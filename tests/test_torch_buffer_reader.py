"""BufferReader's block kernel (``kernels/buffer_reader.py``, ``csrc/buffer_reader.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it
bit-equal to ``buffer_reader_block``. Here:

- the plain version, through ``BufferReader.process`` over several
  instances at once (the leading batch axes the kernel flattens), against
  the JAX package's reader run instance by instance op by op (under
  ``jax.disable_jit``, so that XLA contracts no multiply-add): rates of
  0.5 to 2 against buffers at other rates, ``duration_s`` and ``end_s``
  windows, restarts mid-block and on a block's first and last sample,
  looping switched on and off, readers that end mid-block and stay done;
  state, output and done flags bit-equal at f32 and f64.
  ``tests/test_torch_buffer.py`` holds one instance at a time against the
  jitted JAX reader, the f32 end-frame snap and the graph paths; those
  cases are not repeated;
- the kernel's CTA phases (``csrc/buffer_reader.cuh``: the planes into
  shared memory, the walk, the gather), compiled by the host C++ compiler
  with ``-ffp-contract=off`` and run as the CTA runs them (each phase every
  thread's share before the next), bit-equal to the plain version at B
  from 1 to 4096, mono and stereo, f32 and f64, from random states and
  planes with restarts, loops and ends: in CTAs of two instances and tiles
  of 16 samples (several CTAs, the last one short, tiles crossed) and in
  one tile;
- dispatch: with the launcher patched, a state whose tensors say CUDA
  reaches it (once a block, with the planes at ``[..., B]``), a CPU state
  never does; ``launch`` refuses CPU tensors.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
import knaster_tpu_torch.kernels.buffer_reader as br
from knaster_tpu_torch.ugens.buffer import buffer_reader_block
from knaster_tpu.core.ugen import AudioCtx as JCtx
from tests.torch_helpers import build_host_library

SR = 48000
TDT = {np.float32: torch.float32, np.float64: torch.float64}


# ------------------------------------------------- the plain version vs JAX
# per instance: (reader rate, its params at sample f of the render)
INSTANCES = (
    # half speed, looping until sample 80, restarted at sample 48
    (0.5, lambda f: {"looping": f < 80, "restart": f == 48}),
    # twice the speed in a 0.4 ms duration window from a 0.2 ms start,
    # one-shot, restarted at sample 47 (a 16-sample block's last)
    (2.0, lambda f: {"start_s": 0.0002, "duration_s": 0.0004, "restart": f == 47}),
    # 1.37x up to an end before the buffer's, looping until sample 64,
    # then one-shot with restarts that find it done and start it again
    (1.37, lambda f: {"end_s": 0.0011, "looping": f < 64, "restart": f in (65, 72, 97, 104)}),
)
RENDER = 128  # samples


def _rows(frames, dtype, rate, at):
    """One instance's param rows over the samples ``frames``."""
    cols = [at(f) for f in frames]
    get = lambda k, d: np.array([c.get(k, d) for c in cols])  # noqa: E731
    return {"rate": np.full(len(frames), rate, dtype),
            "looping": get("looping", False).astype(np.int32),
            "start_s": get("start_s", 0.0).astype(dtype),
            "duration_s": get("duration_s", -1.0).astype(dtype),
            "end_s": get("end_s", -1.0).astype(dtype),
            "t_restart": get("restart", False).astype(bool)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("buf_sr, B", [(SR // 2, 16), (44100, 16), (44100, 1)])
def test_batched_plain_version_matches_jax(buf_sr, B, dtype):
    data = (np.random.default_rng(5).standard_normal((2, 60)) * 0.3).astype(np.float32)
    tctx = kt.AudioCtx(SR, B, TDT[dtype])
    jctx = JCtx(SR, B, dtype)
    tr = kt.BufferReader(kt.Buffer(data, buf_sr))
    n = len(INSTANCES)
    ts = {k: torch.stack([v] * n) for k, v in tr.init(tctx).items()}
    dones = 0
    with jax.enable_x64(dtype == np.float64), jax.disable_jit():
        jr = jk.BufferReader(jk.Buffer(data, buf_sr))
        js = [jr.init(jctx) for _ in INSTANCES]
        for b in range(RENDER // B):
            frames = range(b * B, (b + 1) * B)
            rows = [_rows(frames, dtype, rate, at) for rate, at in INSTANCES]
            # the same rows, the instances on the leading axis
            tp = {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in rows[0]}
            ts, to, td = tr.process(tctx, ts, torch.zeros((n, 0, B)), tp)
            assert to.shape == (n, 2, B) and td.shape == (n, B)
            for i, r in enumerate(rows):
                js[i], jo, jd = jr.process(jctx, js[i], np.zeros((0, B), dtype), r)
                np.testing.assert_array_equal(to[i].numpy(), np.asarray(jo),
                                              err_msg=f"out, instance {i} block {b}")
                np.testing.assert_array_equal(td[i].numpy(), np.asarray(jd))
                for k in ("ptr_int", "ptr_frac", "finished"):
                    np.testing.assert_array_equal(ts[k][i].numpy(), np.asarray(js[i][k]),
                                                  err_msg=f"{k}, instance {i} block {b}")
            dones += int(td.sum())
    assert dones >= 2


# ------------------------------------- the kernel's walk, host-compiled
DRIVER = r"""
#include <cstddef>
#include <vector>

#include "buffer_reader.cuh"

// The kernel's CTAs one after another, each phase every thread's share
// before the next (csrc/buffer_reader.cuh cta): I instances a CTA on
// `threads` threads, TS samples a tile.
template <typename T>
static void block(const T* buf, int C, int frames, int n, int B, int I, int TS, int threads,
                  const int32_t* pi, const T* pf, const uint8_t* fin, const int32_t* s_int,
                  const T* s_frac, const T* end, const T* step, const uint8_t* looping,
                  const uint8_t* restart, T* out, uint8_t* done, int32_t* pi_out, T* pf_out,
                  uint8_t* fin_out) {
  const reader::Io<T> io{buf, pi, pf, fin, s_int, s_frac, end, step, looping, restart, out,
                         done, pi_out, pf_out, fin_out, n, B, C, frames};
  std::vector<unsigned char> smem(static_cast<std::size_t>(reader::Tile<T>::bytes(I, TS)));
  for (int first = 0; first < n; first += I) {
    reader::cta<T>(io, first, I, TS, smem.data(), 0, threads);
  }
}

#define ENTRY(name, T)                                                                       \
  extern "C" void name(const T* buf, int C, int frames, int n, int B, int I, int TS,          \
                       int threads, const int32_t* pi, const T* pf, const uint8_t* fin,       \
                       const int32_t* s_int, const T* s_frac, const T* end, const T* step,    \
                       const uint8_t* looping, const uint8_t* restart, T* out, uint8_t* done, \
                       int32_t* pi_out, T* pf_out, uint8_t* fin_out) {                        \
    block<T>(buf, C, frames, n, B, I, TS, threads, pi, pf, fin, s_int, s_frac, end, step,     \
             looping, restart, out, done, pi_out, pf_out, fin_out);                           \
  }
ENTRY(walk_f32, float)
ENTRY(walk_f64, double)
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 14
    return build_host_library(tmp_path_factory, "buffer_reader", DRIVER,
                              {"walk_f32": argtypes, "walk_f64": argtypes})


# (label, I, TS, threads) the test runs the kernel's phases at: CTAs of two
# instances on 32 threads in tiles of 16 samples (several CTAs, the last one
# short, tiles crossed), and every instance in one tile
LAYOUTS = (("tiles", 2, 16, 32), ("one tile", 64, None, 128))


def random_block(n, B, C, frames, dtype, seed):
    """(buf, state, planes) at ``[n]`` / ``[n, B]``: pointers inside and
    past the buffer (negative ones too), some readers finished, windows
    whose ends fall inside the block, steps of 0.5 to 2 and a few large
    ones, restarts and looping flags at random."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    buf = t(rng.standard_normal((C, frames)) * 0.5)
    start = rng.uniform(-2.0, frames * 0.5, (n, B))
    start[:, :] = start[:, :1]  # a window per instance, as a param row gives it
    start = t(start)
    s_int = torch.floor(start).to(torch.int32)
    state = {"ptr_int": t(rng.integers(-3, frames + 3, n), torch.int32),
             "ptr_frac": t(rng.uniform(0, 1, n)),
             "finished": t(rng.uniform(size=n) < 0.3, torch.bool)}
    step = rng.uniform(0.5, 2.0, (n, B))
    step[:, B // 3:B // 3 + 1] = 7.25
    planes = (s_int, start - s_int.to(dtype),
              start + t(rng.uniform(3.0, frames * 0.7, (n, 1))).expand(n, B),
              t(step), t(rng.uniform(size=(n, 1)) < 0.5, torch.bool).expand(n, B).clone(),
              t(rng.uniform(size=(n, B)) < 4.0 / max(B, 4), torch.bool))
    return buf, state, planes


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B, C", [(1, 1), (15, 1), (16, 2), (17, 2), (64, 1), (64, 2), (255, 1),
                                  (256, 2), (257, 1), (704, 2), (1024, 2), (4096, 1)])
def test_kernel_walk_matches_the_plain_version(host_walk, B, C, dtype):
    n, frames = 5, 300
    buf, state, planes = random_block(n, B, C, frames, dtype, seed=B * 10 + C)
    want_state, want, want_done = buffer_reader_block(buf, state, *planes)
    fin = state["finished"].to(torch.uint8)
    p = [x.contiguous() for x in planes]
    p[4], p[5] = p[4].to(torch.uint8), p[5].to(torch.uint8)
    fn = host_walk.walk_f32 if dtype == torch.float32 else host_walk.walk_f64
    words = torch.int32 if dtype == torch.float32 else torch.int64
    for label, I, TS, threads in LAYOUTS:
        out = torch.empty((n, C, B), dtype=dtype)
        done = torch.empty((n, B), dtype=torch.uint8)
        pi, pf = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=dtype)
        fin_out = torch.empty(n, dtype=torch.uint8)
        fn(_ptr(buf), C, frames, n, B, I, TS or B, threads, _ptr(state["ptr_int"]),
           _ptr(state["ptr_frac"]), _ptr(fin), *map(_ptr, p), _ptr(out), _ptr(done), _ptr(pi),
           _ptr(pf), _ptr(fin_out))
        assert torch.equal(out.view(words), want.view(words)), label
        assert torch.equal(done.bool(), want_done), label
        assert torch.equal(pi, want_state["ptr_int"]), label
        assert torch.equal(pf.view(words), want_state["ptr_frac"].view(words)), label
        assert torch.equal(fin_out.bool(), want_state["finished"]), label
    # the cases happened: restarts, dones and silent (finished) samples
    if B >= 64:
        assert bool(planes[5].any()) and bool(want_done.any()) and bool((want == 0).any())


# ---------------------------------------------------------------- dispatch
class _SaysCuda(torch.Tensor):
    """A CPU tensor whose ``device`` says CUDA, to follow the dispatch on a
    machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_state_reaches_the_launcher_and_cpu_never(monkeypatch):
    ctx = kt.AudioCtx(SR, 64)
    data = np.sin(np.arange(200) / 7.0).astype(np.float32)
    reader = kt.BufferReader(kt.Buffer(np.stack([data, -data]), 44100), rate=1.5)
    params = {k: torch.from_numpy(v)
              for k, v in _rows(range(64), np.float32, 1.5, lambda f: {}).items()}
    calls = []

    def fake_launch(buf, state, *planes):
        calls.append((buf, state, planes))
        return buffer_reader_block(buf, state, *planes)

    monkeypatch.setattr(br, "launch", fake_launch)
    monkeypatch.setattr(kt.Buffer, "on", lambda self, device, dtype: torch.from_numpy(
        self.data).to(dtype))
    state = reader.init(ctx)
    cpu_state, cpu_out, cpu_done = reader.process(ctx, state, None, params)
    assert calls == []
    said = {k: torch.Tensor._make_subclass(_SaysCuda, v) for k, v in state.items()}
    new, out, done = reader.process(ctx, said, None, params)
    assert len(calls) == 1
    buf, _, planes = calls[0]
    assert buf.shape == (2, 200) and all(x.shape[-1] == 64 for x in planes)
    assert torch.equal(out, cpu_out) and torch.equal(done, cpu_done)
    for k in cpu_state:
        assert torch.equal(new[k].as_subclass(torch.Tensor), cpu_state[k])


def test_launch_refuses_cpu_tensors():
    buf, state, planes = random_block(2, 64, 1, 100, torch.float32, seed=0)
    before = br.LAUNCHES
    got = br.buffer_reader(buf, state, *planes)
    want = buffer_reader_block(buf, state, *planes)
    assert br.LAUNCHES == before and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="unsupported device"):
        br.launch(buf, state, *planes)
