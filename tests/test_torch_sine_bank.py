"""The port's FusedSineVoiceBank against the JAX PallasSineVoiceBank.

On the CPU the port's kernel wrapper runs its plain torch version; the JAX
bank runs ``_sine_kernel`` in the Pallas interpreter. Both get the same
seeded defaults, events and (through ``convert``) state, block by block.

The JAX side runs under ``jax.jit`` at ``xla_backend_optimization_level``
0. At its default level XLA's CPU backend contracts ``a + b * c`` into one
fused multiply-add (checked: ``jit(lambda a, b, c: a + b * c)`` equals the
singly rounded result, not the twice rounded one), which moves a ramping
frequency by an ulp and with it the u32 phase increment. The TPU kernel,
the CUDA kernel (``--fmad=false``) and the plain torch version all round
the multiply and the add separately; at level 0 XLA does too, so phase can
be held exact.

Tolerances:
- mix: atol 1e-5, as in tests/test_voicebank.py — the same per-voice terms
  are summed in another order (JAX per 128-lane tile then XLA, the port in
  one torch.sum per sample);
- phase and stage: exact (integer and small-integer state);
- t and rscale: 1e-6 (f32 envelope arithmetic in the same order; in
  practice bit-equal);
- the ramp state (fvals ... fsdur, active, idle): exact.

``lockstep`` and ``assert_state`` serve every bank's parity tests
(``tests/test_torch_*_bank.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from knaster_tpu import AudioCtx, PallasSineVoiceBank
from knaster_tpu.parallel import pallas_bank as jpb

import knaster_tpu_torch as ktt
from knaster_tpu_torch.convert import bank_state_from_jax, bank_state_to_numpy
from knaster_tpu_torch.kernels import sine_bank as tsb

SR = 48000
NO_FMA = {"xla_backend_optimization_level": 0}  # see the module docstring
MIX_ATOL = 1e-5
STATE_TOL = 1e-6


def _defaults(V, seed, lo=100.0, hi=4000.0, amp=0.01):
    rng = np.random.default_rng(seed)
    return {
        "freq": rng.uniform(lo, hi, V).astype(np.float32),
        "amp": np.full(V, amp, np.float32),
        "pan": rng.uniform(-1.0, 1.0, V).astype(np.float32),
    }


# per-voice float state compared within STATE_TOL (f32 arithmetic in the
# same order; in practice bit-equal); everything else exactly
LOOSE_STATE = ("t", "rscale", "ic1", "ic2", "et")


def assert_state(sj, st, label):
    a = {k: np.asarray(v) for k, v in sj.items()}
    b = bank_state_to_numpy(st)
    assert sorted(a) == sorted(b), label
    for k in a:
        if k in LOOSE_STATE:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=STATE_TOL,
                                       err_msg=f"{label}: {k}")
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{label}: {k}")


def lockstep(pb, fb, B, blocks, patch_state=None, mix_atol=MIX_ATOL,
             compiler_options=NO_FMA):
    """Run a JAX bank ``pb`` and the port's ``fb`` over ``blocks`` (each an
    event list, ``"empty"`` for an empty event tensor, or None for an
    event-free block), asserting mix and state parity per block, the JAX
    side jitted with ``compiler_options``. Returns the port's mixes and
    state."""
    ctx, tctx = AudioCtx(SR, B, np.float32), ktt.AudioCtx(SR, B)
    sj = {k: np.asarray(v) for k, v in pb.init(ctx).items()}
    if patch_state is not None:
        patch_state(sj)
    st = bank_state_from_jax(sj, "cpu")
    no_in = np.zeros((0, B), np.float32)
    jax_process = jax.jit(
        lambda s, e: pb.process(ctx, s, no_in, {}, events=e)[:2],
        compiler_options=compiler_options)
    mixes = []
    for blk, evs in enumerate(blocks):
        if evs is None:
            ej = et = None
        elif isinstance(evs, str):
            ej, et = pb.empty_node_events(), fb.empty_node_events()
        else:
            ej, et = pb.node_events_from_lists(evs), fb.node_events_from_lists(evs)
        sj, oj = jax_process(sj, ej)
        st, ot = fb.process(tctx, st, events=et)
        assert ot.shape == (fb.voice.outputs, B) and ot.dtype == torch.float32
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=mix_atol, err_msg=f"block {blk}")
        assert_state(sj, st, f"block {blk}")
        mixes.append(ot.numpy())
    return np.concatenate(mixes, axis=1), st



def _trigger_all(V, ti=0):
    return [(0, v, ti, 1, 0.0) for v in range(V)]


def test_matches_jax_bank_mid_block_events():
    """tests/test_voicebank.py's Pallas scenario: restarts on every 5th
    voice, a mid-block release, a freq set, then empty event tensors."""
    V = 1024
    defaults = _defaults(V, 3)
    pb = PallasSineVoiceBank(V, voice_defaults=defaults, event_capacity=1024)
    fb = ktt.FusedSineVoiceBank(V, voice_defaults=defaults, event_capacity=1024)
    events = [(0, v, fb.trig_index("t_restart"), 1, 0.0) for v in range(0, V, 5)]
    events += [(17, 5, fb.trig_index("t_release"), 1, 0.0)]
    events += [(0, 7, fb.float_index("freq"), 0, 1234.0)]
    mix, _ = lockstep(pb, fb, 64, [events, "empty", "empty", "empty"])
    assert np.abs(mix).max() > 1e-4


@pytest.mark.parametrize("name, by_block", [
    # two sets on one slot, out of order in the list: frame order wins
    ("set_burst", {1: [(50, 3, 0, 0, 880.0), (10, 3, 0, 0, 220.0)]}),
    # set@10, cfg@22 freezes it, set@40 jumps; an unrelated amp set
    ("set_cfg_set", {0: [(0, 5, 0, 4, 96.0)],
                     1: [(10, 5, 0, 0, 700.0), (22, 5, 0, 4, 0.0),
                         (40, 5, 0, 0, 300.0), (30, 9, 1, 0, 0.002)]}),
    # a smoothing ramp started mid-block, frozen mid-block in the next, and
    # a set-then-cfg pair (tests/test_bank_event_parity.py anchored ramp)
    ("anchored_ramp", {0: [(0, 3, 0, 4, 96.0), (17, 3, 0, 0, 440.0),
                           (41, 7, 1, 0, 0.002)],
                       1: [(22, 3, 0, 4, 0.0), (5, 9, 0, 0, 620.0),
                           (30, 9, 0, 4, 48.0)]}),
    # pan ramps, active off/on, note-on, releases during attack and sustain
    ("pan_active_release", {0: [(0, 4, 2, 4, 80.0), (3, 4, 2, 0, -0.8),
                                (9, 6, 1, 3, 0.0), (2, 8, 1, 5, 0.0),
                                (20, 10, 1, 1, 0.0)],
                            2: [(0, 6, 1, 3, 1.0), (33, 11, 1, 1, 0.0)]}),
])
def test_matches_jax_bank_event_parity_scenarios(name, by_block):
    """tests/test_bank_event_parity.py's Pallas scenarios, with every voice
    triggered first so the mix is audible."""
    V = 1024
    defaults = _defaults(V, 7, 100.0, 900.0, 0.001)
    pb = PallasSineVoiceBank(V, voice_defaults=defaults, event_capacity=2048)
    fb = ktt.FusedSineVoiceBank(V, voice_defaults=defaults, event_capacity=2048)
    blocks = [list(by_block.get(b, [])) for b in range(4)]
    blocks[0] += _trigger_all(V)
    blocks = [b or None for b in blocks]
    mix, _ = lockstep(pb, fb, 64, blocks)
    assert np.abs(mix).max() > 1e-4


def test_matches_jax_bank_deep_burst_truncation():
    """A burst deeper than kernel_burst_depth keeps its last D events in
    both packages alike (and both warn)."""
    V = 1024
    defaults = {"freq": np.full(V, 440.0, np.float32),
                "amp": np.full(V, 0.001, np.float32),
                "pan": np.zeros(V, np.float32)}
    pb = PallasSineVoiceBank(V, voice_defaults=defaults, event_capacity=2048)
    fb = ktt.FusedSineVoiceBank(V, voice_defaults=defaults, event_capacity=2048)
    burst = [(5 + 10 * i, 2, 0, 0, 200.0 + 100 * i) for i in range(5)]
    with pytest.warns(UserWarning, match="kernel_burst_depth=3"):
        lockstep(pb, fb, 64, [burst + _trigger_all(V), None])


@pytest.mark.parametrize("B", [48, 64, 1024])
def test_matches_jax_bank_saturation_and_phase_wrap(B):
    """Voices at 1e5 Hz (the increment saturates at 2^31 - 128), negative
    and zero freq (no advance), a ramp into saturation, and every phase
    within 2^26 of 2^32 so the first increments wrap."""
    V = 1024
    defaults = _defaults(V, 19)
    defaults["freq"][:8] = [1e5, -300.0, 0.0, 24000.0, 1e9, -1e9, 3e4, 5.0]
    pb = PallasSineVoiceBank(V, voice_defaults=defaults, event_capacity=2048)
    fb = ktt.FusedSineVoiceBank(V, voice_defaults=defaults, event_capacity=2048)
    start = np.random.default_rng(B).integers(
        2**32 - 2**26, 2**32, V, dtype=np.uint64)

    def near_top(sj):
        sj["phase"] = start.astype(np.uint32).reshape(sj["phase"].shape)

    ev0 = _trigger_all(V) + [(0, 9, 0, 4, float(2 * B)), (1, 9, 0, 0, 1e5),
                             (B // 2, 10, 0, 0, -50.0)]
    ev0 += [(B // 2, v, 1, 1, 0.0) for v in range(0, V, 7)]
    mix, st = lockstep(pb, fb, B, [ev0, None, None], patch_state=near_top)
    assert np.abs(mix).max() > 1e-4
    ph = st["phase"].numpy().view(np.uint32).astype(np.uint64)
    # 1e5 and 1e9 Hz advance by the saturated 2^31 - 128 per sample
    sat = (start[[0, 4]] + np.uint64(3 * B * (2**31 - 128))) % np.uint64(2**32)
    np.testing.assert_array_equal(ph[[0, 4]], sat)
    # negative and zero freq never advance
    np.testing.assert_array_equal(ph[[1, 2, 5]], start[[1, 2, 5]])


def test_bench_shaped_slice():
    """bench.py's sequence at V=2048: every voice triggered through staged
    eventful blocks (event_capacity 256), then 20 event-free blocks."""
    V = 2048
    defaults = _defaults(V, 0)
    pb = PallasSineVoiceBank(V, voice_defaults=defaults)
    fb = ktt.FusedSineVoiceBank(V, voice_defaults=defaults)
    cap = fb.event_capacity
    stages = [[(0, v, 0, 1, 0.0) for v in range(base, min(base + cap, V))]
              for base in range(0, V, cap)]
    mix, st = lockstep(pb, fb, 64, stages + [None] * 20)
    assert len(stages) == V // cap
    assert bool((st["stage"] != 0).all())
    assert np.isfinite(mix).all() and np.abs(mix[:, -64:]).max() > 0.1


# --------------------------------------------------------------------------
# helpers one by one: the JAX helpers only run inside a kernel, so each is
# wrapped in a test-local pallas_call in interpret mode
# --------------------------------------------------------------------------

def _in_kernel(fn, *arrays, out_dtypes):
    def kernel(*refs):
        ins, outs = refs[:len(arrays)], refs[len(arrays):]
        res = fn(*[r[...] for r in ins])
        for o, r in zip(outs, res if isinstance(res, tuple) else (res,)):
            o[...] = r

    shape = arrays[0].shape
    call = pl.pallas_call(
        kernel, interpret=True,
        out_shape=tuple(jax.ShapeDtypeStruct(shape, d) for d in out_dtypes),
    )
    out = jax.jit(call, compiler_options=NO_FMA)(*arrays)
    return [np.asarray(o) for o in out]


def test_sin_quant_matches_every_table_index():
    rng = np.random.default_rng(0)
    idx = np.arange(16384, dtype=np.uint64)
    phase = ((idx << 16) | rng.integers(0, 2**16, 16384, dtype=np.uint64))
    phase = phase.astype(np.uint32).reshape(128, 128)
    phase[0, :4] = (0, 2**31, 2**32 - 1, 2**30)
    (want,) = _in_kernel(jpb._sin_quant, phase, out_dtypes=(jnp.float32,))
    got = tsb._sin_quant(torch.from_numpy(phase.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_to_inc_matches_at_the_edges():
    rng = np.random.default_rng(1)
    x = rng.uniform(-3e9, 3e9, (8, 128)).astype(np.float32)
    x[0, :12] = [-1e30, -1.0, -0.0, 0.0, 0.4, 1.5, 2.0**31 - 128, 2.0**31,
                 3e9, 1e30, np.inf, -np.inf]
    (want,) = _in_kernel(jpb._to_inc, x, out_dtypes=(jnp.uint32,))
    got = tsb._to_inc(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("eventful", [True, False])
def test_env_asr_matches_every_transition(eventful):
    """All stages x restart/release x t at and around the stage edges."""
    rng = np.random.default_rng(2)
    shape = (8, 128)
    stage = rng.integers(0, 4, shape).astype(np.float32)
    t = rng.choice(np.float32([0.0, 1e-4, 0.5, 0.99995, 1.0, 2e-5]),
                   shape).astype(np.float32)
    rscale = rng.uniform(0, 1, shape).astype(np.float32)
    restart = rng.random(shape) > 0.7
    release = rng.random(shape) > 0.6
    atk = np.full(shape, np.float32(1 / 480), np.float32)
    rel = np.full(shape, np.float32(1 / 4800), np.float32)
    f32 = jnp.float32
    if eventful:
        want = _in_kernel(jpb._env_asr, stage, t, rscale, restart, release,
                          atk, rel, out_dtypes=(f32,) * 4)
        got = tsb._env_asr(*map(torch.from_numpy, (stage, t, rscale, restart,
                                                   release)),
                           torch.tensor(atk[0, 0]), torch.tensor(rel[0, 0]))
    else:
        want = _in_kernel(jpb._env_asr_free, stage, t, rscale, atk, rel,
                          out_dtypes=(f32,) * 3) + [rscale]
        got = tsb._env_asr(*map(torch.from_numpy, (stage, t, rscale)),
                           None, None, torch.tensor(atk[0, 0]),
                           torch.tensor(rel[0, 0]))
    for name, w, g in zip(("env", "stage", "t", "rscale"), want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
