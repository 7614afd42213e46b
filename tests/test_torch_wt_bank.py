"""The port's FusedWavetableVoiceBank against the JAX PallasWavetableVoiceBank.

As in tests/test_torch_fm_bank.py: the port's plain torch version against
``_wt_kernel`` in the Pallas interpreter (jitted at XLA optimization
level 0), block by block. Phase, stage and the ramp state exact, t and
rscale within 1e-6. The mix is held to 1e-5 although the fundamental's
sin/cos come from torch on one side and XLA on the other: they may differ
by an ulp, carried through the 16-harmonic recurrence, which at these
amplitudes stays orders of magnitude below 1e-5.

Also the host pieces, numpy only: ``NonAaWavetable.add_saw``,
``harmonics_from_table`` and the kernel's A/B/threshold constants.
"""

import numpy as np
import pytest
import torch
from test_torch_fm_bank import rich_schedule
from test_torch_sine_bank import _in_kernel, lockstep

from knaster_tpu import NonAaWavetable as JNonAaWavetable
from knaster_tpu import PallasWavetableVoiceBank
from knaster_tpu.parallel import pallas_bank as jpb
from knaster_tpu.ugens import wavetable as jwt

import knaster_tpu_torch as ktt
from knaster_tpu_torch.kernels import bank_common as tbc
from knaster_tpu_torch.kernels import wt_bank as twb

H = 16


def saw_table(n_harmonics=H):
    """bench_wavetable_bank's table (benchmarks/suite.py)."""
    nb = ktt.NonAaWavetable()
    nb.add_saw(1, n_harmonics + 1, 1.0)
    return nb.buffer


def wt_defaults(V, seed):
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(50, 2000, V).astype(np.float32),
            "amp": np.full(V, 0.01, np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32)}


@pytest.mark.parametrize("B", [48, 64])
def test_matches_jax_wavetable_bank(B):
    """Every event kind with a pan ramp in flight across event-free blocks
    (the linear-angle pack), a freq jump past half Nyquist (partials drop
    at the event frame), releases in attack and in sustain
    (a 2 ms attack)."""
    V = 512
    d = wt_defaults(V, 18)
    table = saw_table()
    kw = dict(table=table, n_harmonics=H, voice_defaults=d,
              event_capacity=1024, attack=0.002)
    pb = PallasWavetableVoiceBank(V, **kw)
    fb = ktt.FusedWavetableVoiceBank(V, **kw)
    sched = rich_schedule(fb, {"pan": -0.7, "freq": 13000.0, "amp": 0.02}, B)
    mix, st = lockstep(pb, fb, B, sched)
    assert np.abs(mix).max() > 1e-3
    assert bool((st["stage"] == 3).any()) and bool((st["stage"] == 2).any())


def test_host_tables_and_constants_match():
    """The saw table, its decomposition (and a random table's, with
    non-zero phase offsets) and the per-harmonic A/B/threshold constants
    are the JAX package's, bit for bit."""
    want = JNonAaWavetable()
    want.add_saw(1, H + 1, 1.0)
    np.testing.assert_array_equal(saw_table(), want.buffer)
    rand = np.random.default_rng(9).uniform(-1, 1, 16384)
    for table, n in ((want.buffer, H), (rand, 40), (rand, 9000)):
        mags, offs = ktt.harmonics_from_table(table, n)
        jm, jo = jwt.harmonics_from_table(table, n)
        assert mags.dtype == jm.dtype and offs.dtype == jo.dtype
        np.testing.assert_array_equal(mags, jm)
        np.testing.assert_array_equal(offs, jo)
    pb = PallasWavetableVoiceBank(128, table=rand, n_harmonics=24)
    coefs = twb.wt_coefs(pb.mags, pb.offsets, 44100)
    phi = pb.offsets.astype(np.float64) * (2.0 * np.pi / 2.0**32)
    np.testing.assert_array_equal(coefs[0], (pb.mags * np.cos(phi)).astype(np.float32))
    np.testing.assert_array_equal(coefs[1], (pb.mags * np.sin(phi)).astype(np.float32))
    np.testing.assert_array_equal(
        coefs[2], [np.float32(np.float64(22050.0) / (h + 1)) for h in range(24)])


def test_theta_full_matches():
    rng = np.random.default_rng(8)
    phase = rng.integers(0, 2**32, (8, 128), dtype=np.uint64).astype(np.uint32)
    phase[0, :6] = (0, 1, 2**30 - 1, 2**30, 2**31 + 5, 2**32 - 1)
    (want,) = _in_kernel(jpb._theta_full, phase, out_dtypes=(np.float32,))
    got = tbc._theta_full(torch.from_numpy(phase.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
