"""The port's FusedSubtractiveVoiceBank against the JAX PallasSubtractiveVoiceBank.

As in tests/test_torch_fm_bank.py: the port's plain torch version against
``_sub_kernel`` in the Pallas interpreter (jitted at XLA optimization
level 0), block by block, with the mix within 1e-5, stage and the ramp
state exact, and t, ic1, ic2, et and rscale within 1e-6 (in practice
bit-equal: the same f32 ops in the same order, IEEE divides included).
"""

import numpy as np
import pytest
import torch
from test_torch_fm_bank import rich_schedule
from test_torch_sine_bank import _in_kernel, lockstep

from knaster_tpu import PallasSubtractiveVoiceBank
from knaster_tpu.parallel import pallas_bank as jpb

import knaster_tpu_torch as ktt
from knaster_tpu_torch.kernels import bank_common as tbc


def sub_defaults(V, seed):
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(55, 880, V).astype(np.float32),
            "cutoff": rng.uniform(400, 8000, V).astype(np.float32),
            "q": rng.uniform(0.7, 4.0, V).astype(np.float32),
            "amp": np.full(V, 0.01, np.float32)}


@pytest.mark.parametrize("B", [48, 64])
def test_matches_jax_subtractive_bank(B):
    """Every event kind, a cutoff sweep in flight (the per-sample
    coefficients must track it), releases in attack and in sustain
    (a 2 ms attack)."""
    V = 512
    d = sub_defaults(V, 16)
    kw = dict(voice_defaults=d, event_capacity=1024, attack=0.002)
    pb = PallasSubtractiveVoiceBank(V, **kw)
    fb = ktt.FusedSubtractiveVoiceBank(V, **kw)
    sched = rich_schedule(
        fb, {"cutoff": 900.0, "freq": 220.0, "q": 2.5, "amp": 0.02}, B)
    mix, st = lockstep(pb, fb, B, sched)
    assert np.abs(mix).max() > 1e-3
    assert bool((st["stage"] == 3).any()) and bool((st["stage"] == 2).any())


def test_svf_low_coeffs_match():
    """The one-divide coefficients over the cutoff range x = pi*fc/sr in
    [0, pi/2) and q from 0.1 to 20, edges included."""
    rng = np.random.default_rng(6)
    shape = (8, 128)
    x = rng.uniform(0.0, np.pi / 2, shape).astype(np.float32)
    q = rng.uniform(0.1, 20.0, shape).astype(np.float32)
    x[0, :4] = [0.0, np.float32(1e-6), np.float32(np.pi / 2) - np.float32(1e-3),
                np.float32(np.pi * 20000 / 48000)]
    q[0, 4:8] = [0.1, 0.7071, 1.0, 20.0]
    want = _in_kernel(jpb._svf_low_coeffs, x, q, out_dtypes=(np.float32,) * 3)
    got = tbc._svf_low_coeffs(torch.from_numpy(x), torch.from_numpy(q))
    for name, w, g in zip(("a1", "a2", "a3"), want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
