"""EnvAsr's block kernel (``kernels/env_asr.py``, ``csrc/env_asr.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it
bit-equal to ``asr_block``. Here:

- the kernel's element steps (``csrc/env_asr.cuh``), compiled by the host
  C++ compiler with ``-ffp-contract=off`` and run as the kernel runs them
  (the state machine sample by sample; the closed form's Hillis-Steele
  steps each over every lane before the next, or the base-16 scan), are
  bit-equal to ``asr_block`` (outputs, done flags and state) on all
  three paths at B from 1 to 4096, f32 and f64, from every stage, with
  restarts and releases, attacks that reach 1 and releases that end
  within the block, instant (zero-time) rates;
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

template <typename T>
static void block(int n, int B, int mode, const int32_t* stage, const T* t, const T* rscale,
                  const T* atk, const T* rel, const uint8_t* restart, const uint8_t* release,
                  T* out, uint8_t* done, int32_t* stage_out, T* t_out, T* rscale_out) {
  std::vector<T> w(4 * static_cast<std::size_t>(B));
  for (int i = 0; i < n; ++i) {
    const long row = static_cast<long>(i) * B;
    if (mode == 0) {
      int32_t s = stage[i];
      T tt = t[i], rs = rscale[i];
      for (int k = 0; k < B; ++k) {
        bool d = false;
        out[row + k] = asr::step<T>(restart[row + k] != 0, release[row + k] != 0,
                                        atk[row + k], rel[row + k], &s, &tt, &rs, &d);
        done[row + k] = d ? 1 : 0;
      }
      stage_out[i] = s;
      t_out[i] = tt;
      rscale_out[i] = rs;
      continue;
    }
    T* A = w.data();
    T* R = A + B;
    for (int k = 0; k < B; ++k) {
      A[k] = atk[row + k];
      R[k] = rel[row + k];
    }
    if (mode == 1) {
      T* nA = A + 2 * B;
      T* nR = A + 3 * B;
      for (int s = 1; s < B; s <<= 1) {  // every lane's step before the next, as the CTA
        for (int k = 0; k < B; ++k) {
          asr::hs_step<T>(A, nA, k, s);
          asr::hs_step<T>(R, nR, k, s);
        }
        std::swap(A, nA);
        std::swap(R, nR);
      }
    } else {
      asr::scan_base16<T>(A, B, w.data() + 2 * B);
      asr::scan_base16<T>(R, B, w.data() + 2 * B);
    }
    for (int k = 0; k < B; ++k) {
      bool d = false;
      asr::closed_lane<T>(A, R, k, stage[i], t[i], rscale[i], &out[row + k], &d);
      done[row + k] = d ? 1 : 0;
    }
    int32_t s = stage[i];
    T tt = t[i];
    asr::closed_state<T>(A[B - 1], R[B - 1], &s, &tt);
    stage_out[i] = s;
    t_out[i] = tt;
    rscale_out[i] = rscale[i];
  }
}

#define ENTRY(name, T)                                                                     \
  extern "C" void name(int n, int B, int mode, const int32_t* stage, const T* t,          \
                       const T* rscale, const T* atk, const T* rel, const uint8_t* restart, \
                       const uint8_t* release, T* out, uint8_t* done, int32_t* stage_out,  \
                       T* t_out, T* rscale_out) {                                          \
    block<T>(n, B, mode, stage, t, rscale, atk, rel, restart, release, out, done,          \
             stage_out, t_out, rscale_out);                                                \
  }
ENTRY(env_f32, float)
ENTRY(env_f64, double)
"""


@pytest.fixture(scope="module")
def host_env(tmp_path_factory):
    argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 12
    return build_host_library(tmp_path_factory, "env_asr", DRIVER,
                              {"env_f32": argtypes, "env_f64": argtypes})


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
@pytest.mark.parametrize("B", [1, 16, 17, 64, 704, 4096])
@pytest.mark.parametrize("path", list(PATHS))
def test_kernel_steps_match_the_plain_version(host_env, path, B, dtype):
    mode, closed, scan = PATHS[path]
    n = 40
    state, atk, rel, restart, release = random_block(n, B, dtype, seed=B * 3 + mode)
    want = asr_block(state, atk, rel, restart, release, closed, scan)
    out = torch.empty((n, B), dtype=dtype)
    done = torch.empty((n, B), dtype=torch.uint8)
    stage_out = torch.empty(n, dtype=torch.int32)
    t_out, rs_out = torch.empty(n, dtype=dtype), torch.empty(n, dtype=dtype)
    fn = host_env.env_f32 if dtype == torch.float32 else host_env.env_f64
    ins = [atk.contiguous(), rel.contiguous(), restart.to(torch.uint8), release.to(torch.uint8)]
    fn(n, B, mode, _ptr(state["stage"]), _ptr(state["t"]), _ptr(state["release_scale"]),
       *map(_ptr, ins), _ptr(out), _ptr(done), _ptr(stage_out), _ptr(t_out), _ptr(rs_out))
    words = torch.int32 if dtype == torch.float32 else torch.int64
    w_stage, w_t, w_rs, w_out, w_done = want
    assert torch.equal(out.view(words), w_out.view(words))
    assert torch.equal(done.bool(), w_done)
    assert torch.equal(stage_out, w_stage.to(torch.int32))
    assert torch.equal(t_out.view(words), w_t.view(words))
    assert torch.equal(rs_out.view(words), w_rs.expand(n).view(words))
    if B >= 64:  # the cases happened
        assert bool(w_done.any()) and bool((w_out == 1.0).any())


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
