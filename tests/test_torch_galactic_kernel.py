"""Galactic's blockwise kernel (``kernels/galactic.py``, ``csrc/galactic.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it
bit-equal to ``blockwise_rest``. Here:

- the kernel's body (``csrc/galactic.cuh galactic::run``), compiled by the
  host C++ compiler with ``-ffp-contract=off``, its phases run in order as
  the CTA runs them, is bit-equal to ``airwindows/galactic.py
  blockwise_rest`` (the output and every state leaf it returns) at B from
  1 to 740 (the shortest line at 48 kHz), f32 and f64, from the states a
  render leaves and from random ones (lines full of noise, positions and
  feedback anywhere, silent input replaced by the dither's tiny values,
  wet below and at 1, the offsets over their whole range);
- ``Galactic.process`` against the JAX package's stays in
  tests/test_torch_galactic.py and tests/test_torch_fdn_galactic.py;
- dispatch: with the launcher patched, an input whose tensors say CUDA
  reaches it once a block, a CPU input never does; ``launch`` refuses CPU
  tensors.
"""

import ctypes

import numpy as np
import pytest
import torch

import knaster_tpu_torch as kt
import knaster_tpu_torch.kernels.galactic as gk
from knaster_tpu_torch.airwindows.galactic import blockwise_rest
from knaster_tpu_torch.kernels.bank_common import i32_of
from tests.torch_helpers import build_host_library

SR = 48000

DRIVER = r"""
#include "galactic.cuh"

template <typename T>
static void block(int B, int lmax, const T* x, const T* att, const T* lp, const T* regen,
                  const T* wet, const T* off, const T* tiny, const uint32_t* fpd,
                  const int64_t* eff, const T* dbuf, const int32_t* dpos, const T* vib_buf,
                  const int32_t* vib_pos, const T* feedback, const T* iir_a, const T* iir_b,
                  T* out, T* dbuf_out, int32_t* dpos_out, T* vib_buf_out, int32_t* vib_pos_out,
                  T* feedback_out, T* iir_a_out, T* iir_b_out, T* ws) {
  const galactic::Block<T> k{B, lmax, x, att, lp, regen, wet, off, tiny, fpd, eff, dbuf, dpos,
                             vib_buf, vib_pos, feedback, iir_a, iir_b, out, dbuf_out, dpos_out,
                             vib_buf_out, vib_pos_out, feedback_out, iir_a_out, iir_b_out, ws};
  galactic::run<T>(k);
}

#define ENTRY(name, T)                                                                       \
  extern "C" void name(int B, int lmax, const T* x, const T* att, const T* lp,              \
                       const T* regen, const T* wet, const T* off, const T* tiny,           \
                       const uint32_t* fpd, const int64_t* eff, const T* dbuf,              \
                       const int32_t* dpos, const T* vib_buf, const int32_t* vib_pos,       \
                       const T* feedback, const T* iir_a, const T* iir_b, T* out,           \
                       T* dbuf_out, int32_t* dpos_out, T* vib_buf_out, int32_t* vib_pos_out, \
                       T* feedback_out, T* iir_a_out, T* iir_b_out, T* ws) {                 \
    block<T>(B, lmax, x, att, lp, regen, wet, off, tiny, fpd, eff, dbuf, dpos, vib_buf,      \
             vib_pos, feedback, iir_a, iir_b, out, dbuf_out, dpos_out, vib_buf_out,          \
             vib_pos_out, feedback_out, iir_a_out, iir_b_out, ws);                           \
  }
ENTRY(galactic_f32, float)
ENTRY(galactic_f64, double)
"""


@pytest.fixture(scope="module")
def host_galactic(tmp_path_factory):
    argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 25
    return build_host_library(tmp_path_factory, "galactic", DRIVER,
                              {"galactic_f32": argtypes, "galactic_f64": argtypes})


def _operands(ugen, ctx, state, x, params):
    """The blockwise path's operands of ``blockwise_rest`` as
    ``Galactic._process_blockwise`` makes them."""
    B, dtype = ctx.block_size, ctx.dtype
    base, lmax = ugen._geometry(ctx.sample_rate)
    regen, attenuate, lowpass, drift, wet = ugen._rates(ctx, params)
    size = params["bigness"][0] * 0.9 + 0.1
    eff = (torch.from_numpy(base).to(dtype) * size).to(torch.int32).clamp(B + 1, lmax).long()
    off, tiny, fpd_seq, _, _, _ = ugen._vib_fpd_vectorized(ctx, state, drift)
    return (state, x, attenuate, lowpass, regen, wet, off, tiny, fpd_seq, eff), lmax


def _params(B, dtype, rng, wet_one=False):
    row = lambda lo, hi: torch.full((B,), float(rng.uniform(lo, hi)), dtype=dtype)  # noqa: E731
    return {"replace": row(0.0, 1.0), "detune": row(0.2, 1.0), "brightness": row(0.2, 1.0),
            "bigness": row(0.1, 1.0),
            "wet": torch.ones(B, dtype=dtype) if wet_one else row(0.1, 0.9)}


def _random_state(ugen, ctx, rng):
    """A state from ``init`` with every leaf moved: lines full of noise at
    random positions, the vibrato ring and position, feedback and both
    lowpasses anywhere, the vibrato phase near its 2 pi reset."""
    s = ugen.init(ctx)
    dt = ctx.dtype
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    s["dbuf"] = t(rng.standard_normal(tuple(s["dbuf"].shape)) * 0.3)
    base, _ = ugen._geometry(ctx.sample_rate)
    s["dpos"] = torch.from_numpy(rng.integers(0, base // 2, (2, 12)).astype(np.int32))
    s["vib_buf"] = t(rng.standard_normal((2, 256)) * 0.3)
    s["vib_pos"] = torch.from_numpy(rng.integers(0, 256, 2).astype(np.int32))
    s["feedback"] = t(rng.standard_normal((2, 4)) * 0.1)
    s["iir_a"], s["iir_b"] = t(rng.standard_normal(2) * 0.2), t(rng.standard_normal(2) * 0.2)
    s["vib_m"] = t(6.2)
    return s


def _run_host(lib, ops, lmax, dtype):
    state, x, attenuate, lowpass, regen, wet, off, tiny, fpd_seq, eff = ops
    B = x.shape[-1]
    c = lambda v: v.contiguous()  # noqa: E731
    args = [c(x), c(attenuate.expand(B)), c(lowpass.expand(B)), c(regen.expand(B)),
            c(wet.expand(B)), c(off), c(tiny), c(i32_of(fpd_seq)), c(eff), c(state["dbuf"]),
            c(state["dpos"]), c(state["vib_buf"]), c(state["vib_pos"]), c(state["feedback"]),
            c(state["iir_a"]), c(state["iir_b"])]
    out = torch.empty((2, B), dtype=dtype)
    new = {"dbuf": state["dbuf"].clone(), "dpos": torch.empty_like(state["dpos"]),
           "vib_buf": torch.empty_like(state["vib_buf"]),
           "vib_pos": torch.empty_like(state["vib_pos"]),
           "feedback": torch.empty_like(state["feedback"]),
           "iir_a": torch.empty_like(state["iir_a"]), "iir_b": torch.empty_like(state["iir_b"])}
    ws = torch.empty(48 * B + 512, dtype=dtype)
    fn = lib.galactic_f32 if dtype == torch.float32 else lib.galactic_f64
    p = lambda v: ctypes.c_void_p(v.data_ptr())  # noqa: E731
    fn(B, lmax, *map(p, args), p(out), *(p(new[k]) for k in (
        "dbuf", "dpos", "vib_buf", "vib_pos", "feedback", "iir_a", "iir_b")), p(ws))
    return new, out


def _words(v):
    return v.view(torch.int64) if v.dtype == torch.float64 else v.view(torch.int32) \
        if v.dtype == torch.float32 else v


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 16, 64, 257, 704, 740])
def test_kernel_body_matches_blockwise_rest(host_galactic, B, dtype):
    rng = np.random.default_rng(B)
    ctx = kt.AudioCtx(SR, B, dtype)
    ugen = kt.Galactic(seed=B)
    for case in range(3):
        state = ugen.init(ctx) if case == 0 else _random_state(ugen, ctx, rng)
        x = torch.from_numpy(rng.standard_normal((2, B)) * 0.5).to(dtype)
        if case == 0:
            x[:, : B // 2] = 0.0  # silence: the dither's tiny values
        ops, lmax = _operands(ugen, ctx, state, x, _params(B, dtype, rng, wet_one=case == 2))
        want_state, want = blockwise_rest(*ops)
        got_state, got = _run_host(host_galactic, ops, lmax, dtype)
        assert torch.equal(_words(got), _words(want)), f"output, case {case}"
        for k, v in want_state.items():
            assert torch.equal(_words(got_state[k]), _words(v)), f"{k}, case {case}"


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose ``device`` says CUDA, to follow the dispatch on a
    machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_input_reaches_the_launcher_and_cpu_never(monkeypatch):
    """``Galactic.process`` hands its block to ``galactic_block`` once; that
    launches for an input on the card and runs the plain version for one on
    the CPU."""
    ctx = kt.AudioCtx(SR, 64)
    ugen = kt.Galactic(seed=3, wet=0.5)
    params = _params(64, torch.float32, np.random.default_rng(1))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32))
    blocks, launches = [], []
    real_block = gk.galactic_block

    def recording_block(*ops):
        blocks.append(ops)
        return real_block(*ops)

    def fake_launch(*ops):
        launches.append(ops)
        plain = lambda v: v.as_subclass(torch.Tensor)  # noqa: E731
        return blockwise_rest(ops[0], plain(ops[1]), *ops[2:])

    monkeypatch.setattr(gk, "galactic_block", recording_block)
    monkeypatch.setattr(gk, "launch", fake_launch)
    state = ugen.init(ctx)
    cpu_state, cpu_out = ugen.process(ctx, state, x, params)
    assert len(blocks) == 1 and launches == []
    ops = blocks[0]
    said = torch.Tensor._make_subclass(_SaysCuda, ops[1])
    new, out = real_block(ops[0], said, *ops[2:])
    assert len(launches) == 1
    assert torch.equal(out, cpu_out)
    for k, v in new.items():
        assert torch.equal(v, cpu_state[k]), k


def test_launch_refuses_cpu_tensors():
    ctx = kt.AudioCtx(SR, 64)
    ugen = kt.Galactic(seed=5)
    state = ugen.init(ctx)
    x = torch.zeros((2, 64))
    ops, _ = _operands(ugen, ctx, state, x, _params(64, torch.float32, np.random.default_rng(2)))
    before = gk.LAUNCHES
    got = gk.galactic_block(*ops)
    want = blockwise_rest(*ops)
    assert gk.LAUNCHES == before and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="unsupported device"):
        gk.launch(*ops)
