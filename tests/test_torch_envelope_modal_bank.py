"""The generic FusedVoiceBank with the Envelope and Modal bodies against the
JAX PallasVoiceBank, and the bodies' own contracts.

On the CPU the port's harness runs each voice's torch body; the JAX bank
runs ``_generic_kernel`` with the voice's ``mosaic_voice`` body in the
Pallas interpreter, jitted at XLA optimization level 0 (no fused
multiply-adds, tests/test_torch_sine_bank.py) and without XLA's algebraic
simplifier, which otherwise folds the modal body's ``c2pi * (freq *
ratio)`` into ``freq * (c2pi * ratio)`` and moves theta by an ulp. So
held, both bodies match the JAX bank bit for bit in every carry, and the
mix within 1e-5 (the sum's order). The curved envelope shapes call cos, exp
and log, which XLA and torch evaluate with their own kernels: within 1e-6
there, exact in the runs below.

Ports of tests/test_generic_bank.py:401 (the modal bank against an f64
replay of the recurrence, the same bound), :467 (choked modal voices go
idle, never-struck ones do not), :578 (the envelope-finished idle latch; a
t_stop voice is not idle), :619 (a looping program never idles) and :643
(exponential segments), plus the bank against the JAX bank over eventful
and event-free blocks for a four-shape program, looping and not, and for
the bell, bar and string presets.
"""

import numpy as np
import pytest
import torch
from test_torch_fm_bank import rich_schedule
from test_torch_sine_bank import NO_FMA, lockstep

import knaster_tpu as jk
from knaster_tpu.ugens.envelopes import Envelope as JEnvelope
from knaster_tpu.ugens.modal import _LN10_M3

import knaster_tpu_torch as kt
from knaster_tpu_torch.kernels import generic_bank as tgb
from knaster_tpu_torch.kernels.bank_common import ENV_SEG_FINISHED, ENV_SEG_STOPPED

SR = 48000
EXACT = dict(NO_FMA, xla_disable_hlo_passes="algsimp")


def _pair(voice_of, V, d, capacity=1024):
    return (jk.PallasVoiceBank(voice_of(jk), V, voice_defaults=d, event_capacity=capacity),
            kt.FusedVoiceBank(voice_of(kt), V, voice_defaults=d, event_capacity=capacity))


def _env(m, segs, looping=False, start=0.0):
    return (JEnvelope if m is jk else kt.Envelope)(start, segs, looping=looping)


# four shapes; segments of 19 to 43 samples at time_scale 1, so they end
# mid-block at every time_scale
FOUR_SHAPES = [(0.0004, 1.0, "exponential"), (0.0007, 0.3, "sinusoidal"),
               (0.0005, 0.6, "step"), (0.0009, 0.05)]


def _env_defaults(V, seed):
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(100, 800, V).astype(np.float32),
            "amp": np.full(V, 0.01, np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32),
            "time_scale": rng.uniform(0.5, 2.0, V).astype(np.float32)}


@pytest.mark.parametrize("looping", [False, True])
def test_envelope_bank_matches_jax(looping):
    V, B = 256, 64
    pb, fb = _pair(lambda m: m.EnvelopeVoice(_env(m, FOUR_SHAPES, looping, 0.1)), V,
                   _env_defaults(V, 21))
    sched = rich_schedule(fb, {"freq": 555.0, "time_scale": 1.5, "amp": 0.02}, B)
    ts = fb.trig_index("t_stop")
    # t_stop across the program: many land in the curved segments
    sched[1] = sched[1] + [((7 * v) % B, v, ts, 1, 0.0) for v in range(1, V, 5)]
    sched[6] = sched[6] + [(v % B, v, ts, 1, 0.0) for v in range(2, V, 11)]
    mix, st = lockstep(pb, fb, B, sched, compiler_options=EXACT)
    assert np.abs(mix).max() > 1e-3
    seg = st["eseg"]
    assert bool((seg == ENV_SEG_STOPPED).any())
    if looping:  # the restarted voices never finish
        assert not bool((seg[::3] == ENV_SEG_FINISHED).any())


def _modal_defaults(V, seed):
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(200, 900, V).astype(np.float32),
            "amp": np.full(V, 0.2, np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32),
            "decay": rng.uniform(0.2, 3.0, V).astype(np.float32)}


def _modal_schedule(bank, B):
    """Strikes across block 0, a mid-block retune while ringing, a choke
    (decays small enough that exp underflows), a sample-accurate
    re-strike, a smoothing ramp, a freq ramp that pushes every mode past
    pi, a depth-3 burst, active/note-on flags."""
    V = bank.n_voices
    ts = bank.trig_index("t_strike")
    fi = {n: bank.float_index(n) for n in ("freq", "decay", "amp", "pan")}
    return [
        [(v % B, v, ts, 1, 0.0) for v in range(0, V, 3)],
        [(17, 5, fi["freq"], 0, 555.0), (26, 7, fi["decay"], 0, 1e-6),
         (30, 8, fi["decay"], 0, 0.05), (40, 9, ts, 1, 0.0), (3, 12, fi["pan"], 0, 0.9)],
        [(0, 9, fi["amp"], 4, 150.0), (10, 9, ts, 1, 0.0),
         (0, 3, fi["freq"], 4, float(2 * B)), (5, 3, fi["freq"], 0, 30000.0)],
        None,
        [(B // 4, 6, fi["freq"], 0, 700.0), (B // 2, 6, fi["freq"], 4, 0.0),
         (3 * B // 4, 6, fi["freq"], 0, 300.0), (0, 13, fi["amp"], 3, 0.0),
         (0, 14, fi["amp"], 5, 0.0), (B // 2, 15, ts, 1, 0.0)],
        None,
    ]


@pytest.mark.parametrize("preset", ["bell", "bar", "string"])
def test_modal_bank_matches_jax(preset):
    V, B = 128, 64

    def voice(m):
        cls = jk.ModalResonator if m is jk else kt.ModalResonator
        return m.ModalVoice(getattr(cls, preset)(440.0), strike_ms=1.5, done_threshold=1e-4)

    pb, fb = _pair(voice, V, _modal_defaults(V, 23))
    mix, st = lockstep(pb, fb, B, _modal_schedule(fb, B), compiler_options=EXACT)
    assert np.abs(mix).max() > 1e-3
    assert fb.spec(kt.AudioCtx(SR, B)).cuda_body in tgb.BODIES


def test_modal_truth_parity():
    """One struck bell voice against an f64 replay of the mallet pulse and
    the rotation-decay recurrence, within the JAX test's bound
    (1e-5 + T * 3e-7)."""
    ctx = kt.AudioCtx(SR, 64)
    n_blocks, T = 12, 64 * 12
    res = kt.ModalResonator.bell(440.0)
    voice = kt.ModalVoice(res, strike_ms=1.5, done_threshold=0.0)
    V = 128
    d = {"freq": np.full(V, 440.0, np.float32), "amp": np.full(V, 0.5, np.float32),
         "pan": np.zeros(V, np.float32), "decay": np.full(V, 1.7, np.float32)}
    bank = kt.FusedVoiceBank(voice, V, voice_defaults=d, event_capacity=64)
    st = bank.init(ctx, device="cpu")
    outs = []
    for blk in range(n_blocks):
        ev = (bank.node_events_from_lists([(0, 0, bank.trig_index("t_strike"), 1, 0.0)])
              if blk == 0 else None)
        st, out = bank.process(ctx, st, events=ev)
        outs.append(out.numpy())
    got = np.concatenate(outs, axis=1)

    n = max(0.00075 * SR, 1.0)  # strike_ms / 2 attack and release
    t_env, stage, pulse = 0.0, 1.0, np.zeros(T)
    for i in range(T):
        if stage == 1.0:
            pulse[i] = t_env
            t_env += 1.0 / n
            if t_env >= 1.0:
                stage, t_env = 2.0, 1.0
        elif stage == 2.0:
            pulse[i] = t_env ** 3
            t_env -= 1.0 / n
            if t_env <= 0.0:
                stage, t_env = 0.0, 0.0
    x = pulse * 0.5 / max(voice._half * SR, 1.0)
    truth = np.zeros(T)
    for m in range(res.n_modes):
        theta = 2.0 * np.pi * 440.0 * float(res.ratios[m]) / SR
        if theta >= np.pi:
            continue
        r = np.exp(_LN10_M3 / (float(res.decays[m]) * SR * 1.7))
        s0 = s1 = 0.0
        for i in range(T):
            s0, s1 = (r * np.cos(theta) * s0 - r * np.sin(theta) * s1 + x[i],
                      r * np.sin(theta) * s0 + r * np.cos(theta) * s1)
            truth[i] += float(res.gains[m]) * s1
    truth *= np.cos(np.pi / 4.0)
    assert np.abs(truth).max() > 1e-3
    assert np.abs(got[0] - truth).max() < 1e-5 + T * 3e-7


def test_modal_pool_reclaims():
    """Choked voices go idle in the bank (struck, quiet, mallet done);
    never-struck ones do not."""
    ctx = kt.AudioCtx(SR, 64)
    V = 128
    d = {"decay": np.full(V, 0.004, np.float32), "amp": np.full(V, 0.3, np.float32)}
    bank = kt.FusedVoiceBank(kt.ModalVoice(kt.ModalResonator.bar(300.0), strike_ms=0.5,
                                           done_threshold=1e-3),
                             V, voice_defaults=d, event_capacity=256)
    st = bank.init(ctx, device="cpu")
    ev = bank.node_events_from_lists([(0, v, bank.trig_index("t_strike"), 1, 0.0)
                                      for v in range(8)])
    st, _ = bank.process(ctx, st, events=ev)
    assert not st["idle"][:8].any()
    for _ in range(12):  # 16 ms: a 4 ms T60 is long gone
        st, _ = bank.process(ctx, st)
    assert st["idle"][:8].all()
    assert not st["idle"][8:].any()


def _env4(m):
    return _env(m, [(0.001, 1.0), (0.002, 0.5), (0.002, 0.75, "sinusoidal"),
                    (0.003, 0.0)])


def test_envelope_idle_latch_and_restart():
    """The envelope-finished bit is the idle latch; a voice stopped by
    t_stop holds its frozen value and is not idle; a voice restarted in the
    last block is not idle. The port's latch equals the JAX bank's."""
    V, B = 256, 64
    d = _env_defaults(V, 22)
    pb, fb = _pair(lambda m: m.EnvelopeVoice(_env4(m)), V, d)
    tr, ts = fb.trig_index("t_restart"), fb.trig_index("t_stop")
    sched = [None] * 10
    sched[0] = [(0, v, tr, 1, 0.0) for v in range(10)]
    sched[2] = [(30, 8, ts, 1, 0.0)]
    sched[9] = [(0, 9, tr, 1, 0.0)]
    _, st = lockstep(pb, fb, B, sched, compiler_options=EXACT)
    idle = st["idle"].numpy()
    done = [v for v in range(8) if d["time_scale"][v] * 0.008 < 0.011]
    assert done and idle[done].all()
    assert not idle[8] and not idle[9]


def test_envelope_looping_never_idles():
    V, B = 128, 64
    d = {"freq": np.full(V, 300.0, np.float32), "amp": np.full(V, 0.01, np.float32)}
    pb, fb = _pair(lambda m: m.EnvelopeVoice(
        _env(m, [(0.001, 1.0), (0.001, 0.0)], looping=True)), V, d, capacity=256)
    sched = [[(0, v, fb.trig_index("t_restart"), 1, 0.0) for v in range(V)]] + [None] * 7
    mix, st = lockstep(pb, fb, B, sched, compiler_options=EXACT)
    assert not st["idle"].any()
    assert np.abs(mix[:, -64:]).max() > 1e-4


def test_envelope_exponential_shape():
    V, B = 128, 64
    d = {"freq": np.full(V, 440.0, np.float32), "amp": np.full(V, 0.02, np.float32)}
    pb, fb = _pair(lambda m: m.EnvelopeVoice(_env(
        m, [(0.002, 1.0, "exponential"), (0.004, 0.001, "exponential"), (0.002, 0.5),
            (0.002, 0.0)], start=0.001)), V, d, capacity=256)
    sched = [[(0, v, fb.trig_index("t_restart"), 1, 0.0) for v in range(V)]] + [None] * 7
    mix, _ = lockstep(pb, fb, B, sched, compiler_options=EXACT)
    assert np.abs(mix).max() > 1e-3


def test_modal_voice_past_16_modes_has_no_cuda_body():
    """ModalBody<M> exists for M = 1 ... 16; a voice of more modes names
    itself off the CPU (and still runs on CPU tensors)."""
    ctx = kt.AudioCtx(SR, 64)
    for M in (1, 16):
        spec = kt.ModalVoice(kt.ModalResonator.string(n_modes=M)).kernel_voice(ctx)
        body = tgb.BODIES[spec.cuda_body]
        assert body[3] == len(spec.carry) == 3 + 2 * M
    bank = kt.FusedVoiceBank(kt.ModalVoice(kt.ModalResonator.string(n_modes=17)), 32)
    st = bank.init(ctx, device="cpu")
    st, out = bank.process(ctx, st)
    assert out.shape == (2, 64)
    ops, _ = bank.kernel_operands(ctx, st)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in ops.items()}
    with pytest.raises(ValueError, match="ModalVoice has no CUDA body"):
        tgb.generic_bank(**meta)
