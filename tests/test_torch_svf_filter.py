"""SvfFilter's block kernel (``kernels/svf_filter.py``, ``csrc/svf_filter.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it
bit-equal to ``svf_block``. Here:

- the kernel's element steps (``csrc/svf_filter.cuh``: the coefficients,
  the scan's rows and Hillis-Steele steps, the outputs), compiled by the
  host C++ compiler with ``-ffp-contract=off`` and run as the kernel runs
  them (each step over every sample before the next), are bit-equal to
  ``ugens/filters.py svf_block`` (output and state) at B from 1 to 4096,
  f32 and f64, for every filter type, audio-rate cutoff and q, one and
  several instances (``HOST_CASES`` says where the host's math library
  limits the inputs);
- ``SvfFilter.process`` against the JAX package's stays in
  tests/test_torch_subtractive.py (``test_svf_process_matches_jax``);
- dispatch: with the launcher patched, an input whose tensors say CUDA
  reaches it once a block, a CPU input never does; ``launch`` refuses CPU
  tensors.
"""

import ctypes

import numpy as np
import pytest
import torch

import knaster_tpu_torch as kt
import knaster_tpu_torch.kernels.svf_filter as sk
from knaster_tpu_torch.ugens.filters import svf_block
from tests.torch_helpers import build_host_library

SR = 48000

DRIVER = r"""
#include <cstddef>
#include <vector>

#include "svf_filter.cuh"

template <typename T>
static void block(int n, int B, const T* ic, const T* x, const int32_t* ty, const T* cutoff,
                  const T* q, const T* gain, double sr, T* y, T* ic_out) {
  std::vector<T> buf(12 * static_cast<std::size_t>(B));
  for (int i = 0; i < n; ++i) {
    const long row = static_cast<long>(i) * B;
    T* w = buf.data();
    for (int t = 0; t < B; ++t) {
      const svf::Coefs<T> c = svf::coefs<T>(ty[row + t], cutoff[row + t], q[row + t],
                                            gain[row + t], static_cast<T>(sr));
      svf::rows<T>(w, B, t, c.a1, c.a2, c.a3, x[row + t]);
    }
    int cur = 0;
    for (int s = 1; s < B; s <<= 1) {  // every sample's step before the next, as the CTA
      for (int t = 0; t < B; ++t) svf::step<T>(w + cur * 6 * B, w + (cur ^ 1) * 6 * B, B, t, s);
      cur ^= 1;
    }
    const T* m = w + cur * 6 * B;
    const T x0 = ic[2 * i], x1 = ic[2 * i + 1];
    for (int t = 0; t < B; ++t) {
      const svf::Coefs<T> c = svf::coefs<T>(ty[row + t], cutoff[row + t], q[row + t],
                                            gain[row + t], static_cast<T>(sr));
      T s0 = x0, s1 = x1;
      if (t > 0) svf::after<T>(m, B, t - 1, x0, x1, &s0, &s1);
      y[row + t] = svf::out<T>(s0, s1, c.a1, c.a2, c.a3, c.m0, c.m1, c.m2, x[row + t]);
    }
    svf::after<T>(m, B, B - 1, x0, x1, &ic_out[2 * i], &ic_out[2 * i + 1]);
  }
}

#define ENTRY(name, T)                                                                   \
  extern "C" void name(int n, int B, const T* ic, const T* x, const int32_t* ty,        \
                       const T* cutoff, const T* q, const T* gain, double sr, T* y,      \
                       T* ic_out) {                                                      \
    block<T>(n, B, ic, x, ty, cutoff, q, gain, sr, y, ic_out);                           \
  }
ENTRY(svf_f32, float)
ENTRY(svf_f64, double)
"""


@pytest.fixture(scope="module")
def host_svf(tmp_path_factory):
    argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_double]
                + [ctypes.c_void_p] * 2)
    return build_host_library(tmp_path_factory, "svf_filter", DRIVER,
                              {"svf_f32": argtypes, "svf_f64": argtypes})


def random_block(n, B, dtype, seed, types=range(9)):
    """(ic [n, 2], x [n, B], the params' rows [n, B]: type, cutoff, q,
    gain): the filter types across the instances, cutoffs gliding 30 Hz -
    20 kHz, a q moving within 0.3 - 8 at audio rate, gains of -12 to 12
    dB."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    ty = torch.from_numpy(np.repeat(rng.choice(list(types), (n, 1)), B, axis=1).astype(np.int32))
    cutoff = t(np.exp(np.linspace(np.log(30.0), np.log(20000.0), B))[None, :]
               * rng.uniform(0.5, 1.0, (n, 1)))
    q = t(rng.uniform(0.3, 8.0, (n, B)))
    gain = t(np.repeat(rng.uniform(-12.0, 12.0, (n, 1)), B, axis=1))
    return t(rng.standard_normal((n, 2))), t(rng.standard_normal((n, B))), (ty, cutoff, q, gain)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


# The host's pow (and at f64 tan) need not round as torch's CPU kernels do,
# so the host runs the types whose coefficients use neither away from a
# zero gain (Low to All: no pow; the shelves and Bell at 0 dB, where the
# amplitude is exactly 1); on the card the kernel and torch call the same
# CUDA math library, and chip_smoke.py holds every type at every gain.
HOST_CASES = [(1, 1), (1, 2), (3, 17), (9, 64), (2, 704), (1, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n, B", HOST_CASES)
def test_kernel_steps_match_svf_block(host_svf, n, B, dtype):
    for case in range(2):
        ic, x, (ty, cutoff, q, gain) = random_block(
            n, B, dtype, seed=B + n + 100 * case, types=range(6) if case == 0 else range(6, 9))
        if case == 1:
            gain = torch.zeros_like(gain)
        if dtype == torch.float64:
            # tan at f64: the host's against torch's CPU kernel, an ulp
            # apart on some inputs; a cutoff whose pi f / sr is a multiple
            # of pi / 4 has exact tangents in both
            cutoff = torch.full_like(cutoff, SR / 4)
        want_ic, want = svf_block(ic, x, ty, cutoff, q, gain, SR)
        rows = [r.expand(n, B).contiguous() for r in (x, ty, cutoff, q, gain)]
        y = torch.empty((n, B), dtype=dtype)
        ic_out = torch.empty((n, 2), dtype=dtype)
        fn = host_svf.svf_f32 if dtype == torch.float32 else host_svf.svf_f64
        ic = ic.contiguous()
        fn(n, B, _ptr(ic), *map(_ptr, rows), float(SR), _ptr(y), _ptr(ic_out))
        words = torch.int32 if dtype == torch.float32 else torch.int64
        assert torch.equal(y.view(words), want.view(words)), f"case {case}"
        assert torch.equal(ic_out.view(words), want_ic.view(words)), f"case {case}"
        assert bool(torch.isfinite(y).all())


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose ``device`` says CUDA, to follow the dispatch on a
    machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_input_reaches_the_launcher_and_cpu_never(monkeypatch):
    ctx = kt.AudioCtx(SR, 64)
    svf = kt.SvfFilter(kt.SvfFilterType.Bell, 900.0, q=2.0, gain_db=6.0)
    params = {"filter": torch.full((64,), 6, dtype=torch.int32),
              "cutoff_freq": torch.linspace(200.0, 5000.0, 64), "q": torch.full((64,), 2.0),
              "gain": torch.full((64,), 6.0), "t_calculate_coefficients":
              torch.zeros(64, dtype=torch.bool)}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 64)).astype(np.float32))
    calls = []

    def fake_launch(ic, x, *rest):
        calls.append((ic, x, rest))
        plain = lambda v: v.as_subclass(torch.Tensor) if isinstance(v, torch.Tensor) else v  # noqa: E731
        return svf_block(*(plain(v) for v in (ic, x, *rest)))

    monkeypatch.setattr(sk, "launch", fake_launch)
    state = svf.init(ctx)
    cpu_state, cpu_out = svf.process(ctx, state, x, params)
    assert calls == []
    said = torch.Tensor._make_subclass(_SaysCuda, x)
    new, out = svf.process(ctx, state, said, params)
    assert len(calls) == 1 and calls[0][1].shape == (64,) and calls[0][2][-1] == SR
    assert torch.equal(out.as_subclass(torch.Tensor), cpu_out)
    assert torch.equal(new["ic"].as_subclass(torch.Tensor), cpu_state["ic"])


def test_launch_refuses_cpu_tensors():
    ic, x, params = random_block(2, 64, torch.float32, seed=0)
    before = sk.LAUNCHES
    got = sk.svf_filter(ic, x, *params, SR)
    want = svf_block(ic, x, *params, SR)
    assert sk.LAUNCHES == before and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="unsupported device"):
        sk.launch(ic, x, *params, SR)
