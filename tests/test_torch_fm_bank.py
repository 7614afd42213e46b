"""The port's FusedFMVoiceBank against the JAX PallasFMVoiceBank.

On the CPU the port's kernel wrapper runs its plain torch version; the JAX
bank runs ``_fm_kernel`` in the Pallas interpreter, jitted at
``xla_backend_optimization_level`` 0 (see tests/test_torch_sine_bank.py:
XLA:CPU otherwise contracts ``a + b*c`` into an FMA) with its algebraic
simplifier off (``EXACT``). Both get the same seeded defaults, events and
state, block by block.

Tolerances (``lockstep``): the mix within 1e-5 (the same per-voice terms
summed in another order); phm, phc, stage and the ramp state exact; t
within 1e-6 (in practice bit-equal).

``rich_schedule`` is the event schedule every bank's parity test uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_generic_bank import _fm_defaults
from test_torch_sine_bank import NO_FMA, _in_kernel, lockstep

from knaster_tpu import PallasFMVoiceBank
from knaster_tpu.parallel import pallas_bank as jpb

import knaster_tpu_torch as ktt
from knaster_tpu_torch.kernels import bank_common as tbc

# FM amplifies an ulp of the reference into the carrier's phase: the JAX
# side also runs without XLA's algebraic simplifier (ROADMAP §3 item 2)
EXACT = dict(NO_FMA, xla_disable_hlo_passes="algsimp")


def rich_schedule(bank, fparams, B):
    """Eight blocks over every event kind, scaled to the block size B
    (tests/test_generic_bank.py ``_schedule``, extended): restarts, (ASR
    voices) releases mid-attack and in sustain, mid-block sets of every
    float param, a smoothing config with a ramp in flight across blocks, a
    depth-3 burst (set, freeze, set), active and note-on flags, a
    saturating and a negative frequency. None is an event-free block."""
    V = bank.n_voices
    names = list(fparams)
    fi = {n: bank.float_index(n) for n in names}
    freq = bank.float_index("freq")
    tr = bank.trig_index("t_restart")
    tq = (bank.trig_index("t_release")
          if "t_release" in bank._trig_names else None)
    amp = bank.float_index("amp")
    b0 = [(v % B, v, tr, 1, 0.0) for v in range(0, V, 3)]
    b0 += [
        ((B // 4), 12, fi[names[0]], 0, float(fparams[names[0]])),
        ((B // 2), 12, fi[names[0]], 4, 0.0),
        ((3 * B // 4), 12, fi[names[0]], 0, float(fparams[names[0]]) * 0.5),
        (0, 13, amp, 3, 0.0),                  # set inactive
        (0, 14, amp, 5, 0.0),                  # note-on
        (5 % B, 15, freq, 0, 1.0e5),           # saturating increment
        (6 % B, 16, freq, 0, -300.0),          # negative: no advance
    ]
    b4 = [(0, 13, amp, 3, 1.0), (B // 2, 20, tr, 1, 0.0)]
    if tq is not None:
        b0 += [(B // 2, v, tq, 1, 0.0) for v in range(0, V, 9)]  # atk -> rel
        b4 += [(v % B, v, tq, 1, 0.0) for v in range(3, V, 9)]  # sus -> rel
    b1 = [((17 + 9 * k) % B, 3 + 2 * k, fi[n], 0, float(fparams[n]))
          for k, n in enumerate(names)]
    b2 = [(0, 9, fi[names[0]], 4, float(2 * B + 22)),
          (10 % B, 9, fi[names[0]], 0, float(fparams[names[0]]))]
    b6 = [((50 % B), 9, fi[names[0]], 0, float(fparams[names[0]]) * 0.5)]
    return [b0, b1, b2, None, b4, None, b6, None]


@pytest.mark.parametrize("B", [48, 64])
def test_matches_jax_fm_bank(B):
    V = 512
    d = _fm_defaults(V, 12)
    pb = PallasFMVoiceBank(V, voice_defaults=d, event_capacity=1024)
    fb = ktt.FusedFMVoiceBank(V, voice_defaults=d, event_capacity=1024)
    sched = rich_schedule(fb, {"freq": 555.0, "index": 2.5, "amp": 0.02}, B)
    mix, st = lockstep(pb, fb, B, sched, compiler_options=EXACT)
    assert np.abs(mix).max() > 1e-3
    assert bool((st["stage"] != 0).any())


def test_matches_jax_fm_bank_phase_wrap_and_release_to_silence():
    """Phases within 2^26 of 2^32 so the first increments wrap, then
    enough event-free blocks (B=1024) that the AR release ends: stage 0
    and a silent voice in both packages."""
    V = 256
    d = _fm_defaults(V, 3)
    pb = PallasFMVoiceBank(V, voice_defaults=d, release=0.01,
                           event_capacity=512)
    fb = ktt.FusedFMVoiceBank(V, voice_defaults=d, release=0.01,
                              event_capacity=512)
    start = np.random.default_rng(5).integers(2**32 - 2**26, 2**32, (2, V),
                                              dtype=np.uint64)

    def near_top(sj):
        sj["phm"] = start[0].astype(np.uint32).reshape(sj["phm"].shape)
        sj["phc"] = start[1].astype(np.uint32).reshape(sj["phc"].shape)

    ev = [(v % 1024, v, 0, 1, 0.0) for v in range(V)]
    mix, st = lockstep(pb, fb, 1024, [ev, None], patch_state=near_top,
                       compiler_options=EXACT)
    assert np.abs(mix).max() > 1e-3
    assert bool((st["stage"] == 0).all()) and bool(st["idle"].all())


@pytest.mark.parametrize("eventful", [True, False])
def test_env_ar_matches_every_transition(eventful):
    """All stages x restart x t at and around the stage edges, including
    the sample that enters release (``done`` excludes it)."""
    rng = np.random.default_rng(4)
    shape = (8, 128)
    stage = rng.integers(0, 3, shape).astype(np.float32)
    t = rng.choice(np.float32([0.0, 1e-4, 0.5, 0.99995, 1.0, 2e-5, 1e-6]),
                   shape).astype(np.float32)
    restart = rng.random(shape) > 0.7
    atk = np.full(shape, np.float32(1 / 240), np.float32)
    rel = np.full(shape, np.float32(1 / 4800), np.float32)
    f32 = jnp.float32
    if eventful:
        want = _in_kernel(jpb._env_ar, stage, t, restart, atk, rel,
                          out_dtypes=(f32,) * 3)
        got = tbc._env_ar(torch.from_numpy(stage), torch.from_numpy(t),
                          torch.from_numpy(restart), torch.tensor(atk[0, 0]),
                          torch.tensor(rel[0, 0]))
    else:
        want = _in_kernel(jpb._env_ar_free, stage, t, atk, rel,
                          out_dtypes=(f32,) * 3)
        got = tbc._env_ar(torch.from_numpy(stage), torch.from_numpy(t), None,
                          torch.tensor(atk[0, 0]), torch.tensor(rel[0, 0]))
    for name, w, g in zip(("env", "stage", "t"), want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
