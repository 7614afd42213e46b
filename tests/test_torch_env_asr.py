"""EnvAsr's block kernel (``kernels/env_asr.py``, ``csrc/env_asr.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it
bit-equal to ``asr_block``. Here:

- the kernel's CTA phases (``csrc/env_asr.cuh``), compiled by the host C++
  compiler with ``-ffp-contract=off`` and run as the CTA runs them (each
  phase every thread's share before the next; what a thread holds over a
  barrier held per thread): the state machine in shared-memory tiles
  (several CTAs, the last one short, tiles crossed, and one tile), the
  closed form's in-place Hillis-Steele steps (the kernel's threads and 64
  threads of up to 16 lanes each, several instances a CTA) and its global
  workspace, and the two base-16 scans at once, are bit-equal to
  ``asr_block`` (outputs, done flags and state) on all three paths at B
  from 1 to 4096 (15, 16, 17 and 255-257 about a row of 16 and a level of
  256), f32 and f64, from every stage, with restarts and releases,
  attacks that reach 1 and releases that end within the block, instant
  (zero-time) rates;
- the moved base-16 scan (``csrc/scan_base16.cuh``) on 64 and 7 threads
  against ``cumsum_base16`` at the same lengths, -0 included;
- ``EnvAsr.process`` against the JAX package's stays in
  tests/test_torch_envelope.py and the voices' tests;
- dispatch: with the launcher patched, a state whose tensors say CUDA
  reaches it once a block, a CPU state never does; ``launch`` refuses CPU
  tensors.
"""

import ctypes

import numpy as np
import pytest
import torch

import knaster_tpu_torch as kt
import knaster_tpu_torch.kernels.env_asr as ek
from knaster_tpu_torch.core.dsp import cumsum, cumsum_base16
from knaster_tpu_torch.ugens.envelopes import asr_block, rate_from_time
from tests.torch_helpers import build_host_library

SR = 48000

DRIVER = r"""
#include <cstddef>
#include <vector>

#include "env_asr.cuh"

// The block kernel's CTAs one after another, each phase every thread's
// share before the next (csrc/env_asr.cuh). The state machine: CTAs of I
// instances on `threads` threads, TS samples a tile. The closed form: CTAs
// of G instances on P threads each, K lanes a thread held over the
// Hillis-Steele barrier, the rows in one CTA's shared memory or, where
// `global`, in a workspace of every instance's rows.
template <typename T, int K>
static void closed(const asr::Io<T>& io, int mode, int global, int G, int P) {
  const int64_t stride = asr::closed_row_len(mode, io.B, global != 0);
  std::vector<T> rows(static_cast<std::size_t>(stride) * (global ? io.n : G));
  for (int first = 0; first < io.n; first += G) {
    T* base = global ? rows.data() + first * stride : rows.data();
    asr::closed_cta<T, K>(io, first, G, P, mode, global != 0, base, stride, 0);
  }
}

template <typename T>
static void block(int n, int B, int mode, int global, int I, int TS, int threads, int G, int P,
                  int K, const int32_t* stage, const T* t, const T* rscale, const T* atk,
                  const T* rel, const uint8_t* restart, const uint8_t* release, T* out,
                  uint8_t* done, int32_t* stage_out, T* t_out, T* rscale_out) {
  const asr::Io<T> io{stage, t, rscale, atk, rel, restart, release, out, done, stage_out, t_out,
                      rscale_out, n, B};
  if (mode == asr::kStep) {
    std::vector<unsigned char> smem(static_cast<std::size_t>(asr::StepTile<T>::bytes(I, TS)));
    for (int first = 0; first < n; first += I) {
      asr::step_cta<T>(io, first, I, TS, smem.data(), 0, threads);
    }
  } else if (K <= 1) {
    closed<T, 1>(io, mode, global, G, P);
  } else if (K <= 2) {
    closed<T, 2>(io, mode, global, G, P);
  } else if (K <= 4) {
    closed<T, 4>(io, mode, global, G, P);
  } else if (K <= 8) {
    closed<T, 8>(io, mode, global, G, P);
  } else {
    closed<T, 16>(io, mode, global, G, P);
  }
}

#define ENTRY(name, T)                                                                      \
  extern "C" void name(int n, int B, int mode, int global, int I, int TS, int threads, int G, \
                       int P, int K, const int32_t* stage, const T* t, const T* rscale,     \
                       const T* atk, const T* rel, const uint8_t* restart,                  \
                       const uint8_t* release, T* out, uint8_t* done, int32_t* stage_out,   \
                       T* t_out, T* rscale_out) {                                           \
    block<T>(n, B, mode, global, I, TS, threads, G, P, K, stage, t, rscale, atk, rel,       \
             restart, release, out, done, stage_out, t_out, rscale_out);                    \
  }
ENTRY(env_f32, float)
ENTRY(env_f64, double)

// ktt::scan_sum_base16 on `lanes` threads, x -> r
#define SCAN(name, T)                                                          \
  extern "C" void name(const T* x, T* r, int n, int lanes) {                  \
    std::vector<T> work(static_cast<std::size_t>(ktt::scan_work(n)) + 1);      \
    ktt::scan_sum_base16<T>(x, r, work.data(), n, 0, lanes);                   \
  }
SCAN(scan_f32, float)
SCAN(scan_f64, double)
"""


@pytest.fixture(scope="module")
def host_env(tmp_path_factory):
    argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p] * 12
    scan = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    return build_host_library(tmp_path_factory, "env_asr", DRIVER,
                              {"env_f32": argtypes, "env_f64": argtypes,
                               "scan_f32": scan, "scan_f64": scan})


def closed_threads(B):
    """The kernel's threads an instance on the closed form (csrc/env_asr.cu
    closed_threads) and the lanes each holds over the Hillis-Steele
    barrier, a power of two."""
    P = min(1024, max(64, (2 * B // 4 + 63) // 64 * 64))
    K = 1
    while K * P < 2 * B:
        K *= 2
    return P, K


def layouts(mode, B, n):
    """(label, global, I, TS, threads, G, P, K) the test runs the kernel's
    phases at: for the state machine CTAs of 16 instances on 64 threads in
    tiles of 16 samples (several CTAs, the last one short, tiles crossed)
    and of every instance in one tile; for the closed form the kernel's
    threads with 3 instances a CTA, 64 threads with up to 16 lanes each
    held over the barrier where that covers the rows, and the global
    workspace."""
    if mode == ek.STEP:
        return [("tiles", 0, 16, 16, 64, 1, 1, 1), ("one tile", 0, 128, B, 128, 1, 1, 1)]
    P, K = closed_threads(B)
    out = [("shared", 0, 1, 1, 1, 3, P, K), ("global", 1, 1, 1, 1, 1, P, K)]
    if 2 * B <= 16 * 64:
        narrow = 1
        while narrow * 64 < 2 * B:
            narrow *= 2
        out.append(("narrow", 0, 1, 1, 1, 2, 64, narrow))
    return out


def random_block(n, B, dtype, seed):
    """(state, atk, rel, restart, release) over n instances: every stage,
    t anywhere in [0, 1] (and at 1), attack and release times from 0 (an
    instant rate of 1) to ~10 blocks, a few restarts and releases."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    tt = rng.uniform(0.0, 1.0, n)
    tt[::5] = 1.0
    state = {"stage": torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
             "t": t(tt), "release_scale": t(rng.uniform(0.2, 1.0, n))}
    times = rng.uniform(0.0, 10 * B / SR, (n, 1)) * (rng.uniform(size=(n, 1)) > 0.1)
    atk = rate_from_time(t(np.repeat(times, B, axis=1)), SR)
    rel = rate_from_time(t(np.repeat(rng.uniform(0.0, 10 * B / SR, (n, 1)), B, axis=1)), SR)
    restart = torch.from_numpy(rng.uniform(size=(n, B)) < 2.0 / B)
    release = torch.from_numpy(rng.uniform(size=(n, B)) < 2.0 / B)
    return state, atk, rel, restart, release


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


PATHS = {"step": (ek.STEP, False, cumsum), "hillis_steele": (ek.HILLIS_STEELE, True, cumsum),
         "base16": (ek.BASE16, True, cumsum_base16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 15, 16, 17, 64, 255, 256, 257, 704, 4096])
@pytest.mark.parametrize("path", list(PATHS))
def test_kernel_steps_match_the_plain_version(host_env, path, B, dtype):
    mode, closed, scan = PATHS[path]
    n = 40
    state, atk, rel, restart, release = random_block(n, B, dtype, seed=B * 3 + mode)
    want = asr_block(state, atk, rel, restart, release, closed, scan)
    fn = host_env.env_f32 if dtype == torch.float32 else host_env.env_f64
    ins = [atk.contiguous(), rel.contiguous(), restart.to(torch.uint8), release.to(torch.uint8)]
    words = torch.int32 if dtype == torch.float32 else torch.int64
    w_stage, w_t, w_rs, w_out, w_done = want
    for label, *layout in layouts(mode, B, n):
        out = torch.empty((n, B), dtype=dtype)
        done = torch.empty((n, B), dtype=torch.uint8)
        stage_out = torch.empty(n, dtype=torch.int32)
        t_out, rs_out = torch.empty(n, dtype=dtype), torch.empty(n, dtype=dtype)
        fn(n, B, mode, *layout, _ptr(state["stage"]), _ptr(state["t"]),
           _ptr(state["release_scale"]), *map(_ptr, ins), _ptr(out), _ptr(done),
           _ptr(stage_out), _ptr(t_out), _ptr(rs_out))
        assert torch.equal(out.view(words), w_out.view(words)), label
        assert torch.equal(done.bool(), w_done), label
        assert torch.equal(stage_out, w_stage.to(torch.int32)), label
        assert torch.equal(t_out.view(words), w_t.view(words)), label
        assert torch.equal(rs_out.view(words), w_rs.expand(n).view(words)), label
    if B >= 64:  # the cases happened
        assert bool(w_done.any()) and bool((w_out == 1.0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 15, 16, 17, 64, 255, 256, 257, 704, 4096])
def test_scan_base16_matches_cumsum_base16(host_env, B, dtype):
    """csrc/scan_base16.cuh on 64 and on 7 threads, bit-equal to
    ``cumsum_base16``: values of mixed sign and magnitude, so that the
    association decides the roundings, and -0 (the +0 adds make it +0)."""
    rng = np.random.default_rng(B)
    x = rng.standard_normal(B) * 10.0 ** rng.integers(-6, 6, B)
    x[::7] = -0.0
    x = torch.from_numpy(x).to(dtype)
    want = cumsum_base16(x)
    words = torch.int32 if dtype == torch.float32 else torch.int64
    fn = host_env.scan_f32 if dtype == torch.float32 else host_env.scan_f64
    for lanes in (64, 7):
        r = torch.empty_like(x)
        fn(_ptr(x), _ptr(r), B, lanes)
        assert torch.equal(r.view(words), want.view(words)), lanes


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose ``device`` says CUDA, to follow the dispatch on a
    machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_state_reaches_the_launcher_and_cpu_never(monkeypatch):
    ctx = kt.AudioCtx(SR, 64)
    env = kt.EnvAsr(0.002, 0.01)
    params = {"attack_time": torch.full((64,), 0.002), "release_time": torch.full((64,), 0.01),
              "t_restart": torch.zeros(64, dtype=torch.bool),
              "t_release": torch.zeros(64, dtype=torch.bool)}
    params["t_restart"][3] = True
    calls = []

    def fake_launch(state, *rest):
        calls.append((state, rest))
        plain = lambda v: v.as_subclass(torch.Tensor) if isinstance(v, torch.Tensor) else v  # noqa: E731
        return asr_block({k: plain(v) for k, v in state.items()}, *(plain(v) for v in rest))

    monkeypatch.setattr(ek, "launch", fake_launch)
    state = env.init(ctx)
    cpu_state, cpu_out, cpu_done = env.process(ctx, state, None, params)
    assert calls == []
    said = {k: torch.Tensor._make_subclass(_SaysCuda, v) for k, v in state.items()}
    new, out, done = env.process(ctx, said, None, params)
    assert len(calls) == 1 and calls[0][1][4] is False  # the eventful path: not closed
    assert torch.equal(out, cpu_out) and torch.equal(done, cpu_done)
    for k in cpu_state:
        assert torch.equal(new[k], cpu_state[k]), k


def test_launch_refuses_cpu_tensors():
    state, atk, rel, restart, release = random_block(3, 64, torch.float32, seed=1)
    before = ek.LAUNCHES
    got = ek.env_asr(state, atk, rel, restart, release, True, cumsum)
    want = asr_block(state, atk, rel, restart, release, True, cumsum)
    assert ek.LAUNCHES == before and torch.equal(got[3], want[3])
    with pytest.raises(ValueError, match="unsupported device"):
        ek.launch(state, atk, rel, restart, release, True, cumsum)
