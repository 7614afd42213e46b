"""The port's composable ``VoiceBank`` (``parallel/voicebank.py``) against the JAX package's vmap bank.

- ``_apply_events_rounds``: the round fold's float and int planes, ramp
  state, int values, retrigger set masks, trigger planes and flags against
  the JAX function, on random event lists with bursts, int sets and
  smoothing configs, three blocks in a row at B in {16, 64}: bit-equal
  to the JAX function evaluated op by op (``jax.disable_jit``). Jitted,
  even at optimization level 0, XLA's CPU backend rounds the trajectory's
  ``anchor + step * progress`` otherwise, as a fused multiply-add would
  (measured: three plane samples of 384 an ulp apart).
- The vmap-bank cases of tests/test_voicebank.py: :27 (the bank equals the
  sum of single voices), :63 (per-voice events), :99 (active masking),
  :122 (each voice model, here port against JAX at V = 8 block by block,
  state included, at f32 and f64), :262 (per-voice smoothing), :370 (a
  sample-accurate float set) and :429 (an additive voice of one harmonic
  is the sine voice).
- The vmap-bank cases of tests/test_bank_event_parity.py:100-295: each
  event schedule through a one-voice port bank, the port's own graph
  engine and the JAX bank (repeated ``jump_to_segment`` on a
  ``VoiceBank(Envelope)``, int-set bursts, set/config interleavings).
- One block at V = 4096: the voices see ``ctx.wide_batch`` (the envelope's
  per-sample loop) and the block matches the JAX bank's.
- Each fused bank's plain version against the vmap bank at atol 1e-5
  (sine, FM, subtractive, wavetable), as tests/test_voicebank.py:175-213,
  306-369 and 452-481 hold the Pallas banks.
- ``VoicePool`` over a vmap bank (tests/test_voice_pool.py:20-68), an int
  voice param set through a handle, and the vmap bank's state through the
  converter both ways.

Tolerances against the JAX bank (``MIX_TOL``): 1e-6 at f32, 1e-12 at f64.
The JAX bank is jitted at XLA level 0 without its algebraic simplifier
(``EXACT``); the two sides' sines are XLA's and torch's own kernels, an
ulp apart on some arguments, and a ramping param's trajectory is rounded
otherwise there (above). At f32 an ulp of a frequency truncates to another u32
increment about half the time (the FM voice's carrier takes its frequency
from the modulator's sine every sample), so a u32 phase may drift by a few
units of 2^-32 of a cycle: ``PHASE_UNITS`` bounds the drift over these
blocks. A table index moves only where the drift crosses a step of 2^16
units, which these short runs do not reach.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from knaster_tpu.models import PluckedVoice as JPluckedVoice
from knaster_tpu_torch.convert import (bank_state_from_jax, bank_state_to_numpy,
                                       graph_state_from_jax, graph_state_to_numpy)

SR = 48000
B = 64
EXACT = {"xla_backend_optimization_level": 0, "xla_disable_hlo_passes": "algsimp"}
MIX_TOL = {np.float32: 1e-6, np.float64: 1e-12}
PHASE_UNITS = 64
TDT = {np.float32: torch.float32, np.float64: torch.float64}


def _proc(m, outputs, **opts):
    kw = {} if m is jk else {"device": "cpu"}
    return m.AudioProcessor.new(0, outputs, m.AudioProcessorOptions(
        block_size=B, sample_rate=SR, **opts), **kw)


def _push(g, ugen):
    h = g.edit(lambda gg: gg.push(ugen))
    h.to_graph_out()
    g.commit()
    return h


def _samples(m, n):
    return m.Seconds.from_samples(n, SR)


# ---------------------------------------------------------------------------
# voices written for both packages
# ---------------------------------------------------------------------------

def _fold_voice(m):
    """Two floats, an int, a retrigger int and two triggers: the round
    fold's every plane (``process`` is not called)."""

    class FoldVoice(m.UGen):
        inputs = 0
        outputs = 1
        params = (m.pfloat("a", 1.0), m.pfloat("b", -2.0), m.pinteger("sel", 3),
                  m.pinteger("jump", 0, retrigger=True), m.ptrigger("t0"),
                  m.ptrigger("t1"))

    return FoldVoice()


def _level_voice(m, default=1.0):
    """Emits its float param (tests/test_bank_event_parity.py:48)."""

    class LevelVoice(m.UGen):
        inputs = 0
        outputs = 1
        params = (m.pfloat("level", default),)

        def batch_key(self):
            return (type(self),)

        def process(self, ctx, state, inputs, params):
            if m is jk:
                return state, params["level"][None, :].astype(ctx.dtype)
            return state, params["level"].unsqueeze(-2).to(ctx.dtype)

    return LevelVoice()


def _int_level_voice(m):
    """Emits its int param as a float signal (tests/test_bank_event_parity.py:34)."""

    class IntLevelVoice(m.UGen):
        inputs = 0
        outputs = 1
        params = (m.pinteger("sel", 1),)

        def batch_key(self):
            return (type(self),)

        def process(self, ctx, state, inputs, params):
            if m is jk:
                return state, params["sel"][None, :].astype(ctx.dtype)
            return state, params["sel"].unsqueeze(-2).to(ctx.dtype)

    return IntLevelVoice()


# ---------------------------------------------------------------------------
# the round fold
# ---------------------------------------------------------------------------

def _random_events(rng, V, Bk, n=60):
    """Every kind; same-slot bursts (frame ties included) of float sets
    and smoothing configs, int sets repeating a value, triggers, flags."""
    evs = []
    for _ in range(n):
        kind = int(rng.choice([0, 0, 0, 4, 2, 2, 1, 3, 5]))
        f, v, p = int(rng.integers(0, Bk)), int(rng.integers(0, V)), int(rng.integers(0, 2))
        if kind == 0:
            val = float(rng.uniform(-5, 5))
        elif kind == 4:
            val = float(rng.choice([0, 8, 40, 200]))
        elif kind == 2:
            val = float(rng.integers(0, 3))
        elif kind in (3, 5):
            p, val = 0, float(rng.integers(0, 2))
        else:
            val = 0.0
        evs.append((f, v, p, kind, val))
    return evs


@pytest.mark.parametrize("Bk", [16, 64])
def test_round_fold_matches_jax(Bk):
    V = 4
    rng = np.random.default_rng(Bk)
    jb, tb = jk.VoiceBank(_fold_voice(jk), V), kt.VoiceBank(_fold_voice(kt), V)
    ctx, tctx = jk.AudioCtx(SR, Bk, np.float32), kt.AudioCtx(SR, Bk)
    sj, st = jb.init(ctx), tb.init(tctx)
    for blk in range(3):
        evs = _random_events(rng, V, Bk)
        ej, et = jb.node_events_from_lists(evs), tb.node_events_from_lists(evs)
        assert tb._n_rounds(et) >= 3  # bursts
        with jax.disable_jit():
            want = jb._apply_events_rounds(ctx, sj, ej)
        got = tb._apply_events_rounds(tctx, st, tb._events_to(et, "cpu"), tb._n_rounds(et))
        names = ("planes_f", "fstate", "ivals", "planes_i", "iset", "trig", "active", "idle")
        for name, a, b in zip(names, want, got):
            for x, y in zip(jax.tree_util.tree_leaves(a), [b] if name != "fstate" else b):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                              err_msg=f"block {blk}: {name}")
        assert bool(got[4].any()) and bool(got[5].any())
        # carry the folded state to the next block, as process does
        fs_j = jb._advance_ramps(want[1], Bk)
        fs_t = tb._advance_ramps(got[1], Bk)
        keys = ("fvals", "ftarget", "fstep", "felapsed", "fdur", "fsdur")
        sj = dict(sj, **dict(zip(keys, fs_j)), ivals=want[2], active=want[6], idle=want[7])
        st = dict(st, **dict(zip(keys, fs_t)), ivals=got[2], active=got[6], idle=got[7])


# ---------------------------------------------------------------------------
# tests/test_voicebank.py's vmap-bank cases
# ---------------------------------------------------------------------------

def _sine_bank_render(m, V, schedule, frames, voice_defaults=None, amp=0.1):
    g, proc = _proc(m, 2)
    bank = _push(g, m.VoiceBank(m.SineVoice(amp=amp), V, voice_defaults=voice_defaults))
    schedule(m, bank)
    return np.asarray(proc.render(frames=frames))


def test_bank_equals_sum_of_single_voices():
    freqs = np.array([220.0, 330.0, 550.0], np.float32)

    def trig_all(m, bank):
        for v in range(3):
            bank.voice_param("t_restart").trig(v)

    a = _sine_bank_render(kt, 3, trig_all, 256, {"freq": freqs})
    g, proc = _proc(kt, 2)
    ps = []

    def build(gg):
        for f in freqs:
            h = gg.push(kt.SineVoice(freq=float(f), amp=0.1))
            h.to_graph_out()
            ps.append(h.param("t_restart"))

    g.edit(build)
    for p in ps:
        p.trig()
    np.testing.assert_allclose(a, proc.render(frames=256), atol=2e-6)
    np.testing.assert_allclose(a, _sine_bank_render(jk, 3, trig_all, 256, {"freq": freqs}),
                               rtol=0, atol=MIX_TOL[np.float32])


def test_bank_per_voice_events_and_active_masking():
    def events(m, bank):
        freq, trig = bank.voice_param("freq"), bank.voice_param("t_restart")
        freq.set(0, 1000.0)
        freq.set(2, 2000.0)
        trig.trig(0)
        trig.trig_at(2, _samples(m, 100))  # sample-accurate

    def only0(m, bank):
        bank.voice_param("freq").set(0, 1000.0)
        bank.voice_param("t_restart").trig(0)

    def masked(m, bank):
        bank.voice_param("freq").set(0, 1000.0)
        bank.voice_param("t_restart").trig(0)
        bank.voice_param("t_restart").trig(1)
        bank.set_voice_active(1, False)

    a = _sine_bank_render(kt, 4, events, 256)
    b = _sine_bank_render(kt, 4, only0, 256)
    assert np.abs(a[:, 5:90]).max() > 0
    np.testing.assert_allclose(a[:, :100], b[:, :100], atol=1e-7)
    assert not np.allclose(a[:, 105:], b[:, 105:])
    np.testing.assert_allclose(_sine_bank_render(kt, 4, masked, 256), b, atol=1e-7)
    for sched, port in ((events, a), (only0, b)):
        np.testing.assert_allclose(port, _sine_bank_render(jk, 4, sched, 256), rtol=0,
                                   atol=MIX_TOL[np.float32])


def test_bank_per_voice_smoothing():
    """tests/test_voicebank.py:262: a smoothed amp ramps, a jump does not,
    and both land on the same samples after the ramp."""
    def render(smooth):
        g, proc = _proc(kt, 2)
        bank = _push(g, kt.VoiceBank(kt.SineVoice(amp=1.0), 2))
        bank.voice_param("t_restart").trig(0)
        proc.render(frames=6400)
        if smooth:
            bank.voice_param("amp").smooth(0, 128 / 48000)
        bank.voice_param("amp").set(0, 3.0)
        return proc.render(frames=256)

    a, b = render(True), render(False)
    assert not np.allclose(a[:, :128], b[:, :128])
    np.testing.assert_allclose(a[:, 192:], b[:, 192:], atol=1e-5)


def test_bank_sample_accurate_float_set():
    """tests/test_voicebank.py:370: a set lands on its frame; a set while a
    ramp runs anchors the new ramp at its frame from the old ramp's value."""
    g, proc = _proc(kt, 1)
    bank = _push(g, kt.VoiceBank(_level_voice(kt, 0.0), 2,
                                 voice_defaults={"level": np.array([1.0, 10.0], np.float32)}))
    bank.voice_param("level").set_at(0, 5.0, _samples(kt, 100))
    out = proc.render(frames=256)[0]
    np.testing.assert_allclose(out[:100], 11.0, atol=1e-6)
    np.testing.assert_allclose(out[100:], 15.0, atol=1e-6)

    ctx = kt.AudioCtx(SR, B)
    vb = kt.VoiceBank(_level_voice(kt, 0.0), 1)
    li = vb.float_index("level")
    st = vb.init(ctx)
    st, o0, _ = vb.process(ctx, st, events=vb.node_events_from_lists(
        [(0, 0, li, 4, 128.0), (0, 0, li, 0, 128.0)]))
    np.testing.assert_allclose(o0[0].numpy(), np.arange(64.0), atol=1e-4)
    st, o1, _ = vb.process(ctx, st, events=vb.node_events_from_lists([(32, 0, li, 0, 500.0)]))
    t = np.arange(64.0)
    np.testing.assert_allclose(o1[0].numpy(),
                               np.where(t < 32, 64.0 + t, 96.0 + (500.0 - 96.0) / 128.0 * (t - 32)),
                               atol=1e-3)
    assert int(st["felapsed"][li, 0]) == 32 and int(st["fdur"][li, 0]) == 128


def test_additive_single_harmonic_matches_sine_voice():
    """tests/test_voicebank.py:429: the exact angle against SinWt's table
    grid, within one table step."""
    ctx = kt.AudioCtx(SR, B)
    av = kt.AdditiveVoice(harmonics=np.array([1.0], np.float32), freq=330.0)
    sv = kt.SineVoice(freq=330.0)
    sa, sb = av.init(ctx), sv.init(ctx)
    p = {"freq": torch.full((B,), 330.0), "amp": torch.full((B,), 0.5),
         "pan": torch.full((B,), 0.3), "t_restart": torch.zeros(B, dtype=torch.bool),
         "t_release": torch.zeros(B, dtype=torch.bool)}
    p["t_restart"][3] = True
    no_in = torch.zeros((0, B))
    for _ in range(3):
        sa, oa, _ = av.process(ctx, sa, no_in, p)
        sb, ob, _ = sv.process(ctx, sb, no_in, p)
        np.testing.assert_allclose(oa.numpy(), ob.numpy(), atol=3e-4)
        assert float(oa.abs().max()) > 0 or not p["t_restart"].any()
        p["t_restart"] = torch.zeros(B, dtype=torch.bool)


# ---------------------------------------------------------------------------
# every voice model, port against JAX, block by block
# ---------------------------------------------------------------------------

HARMONICS = np.array([1.0, 0.6, 0.4, 0.25, 0.15, 0.08], np.float32)
VOICES = {
    "sine": lambda m: m.SineVoice(),
    "fm": lambda m: m.FMVoice(),
    "subtractive": lambda m: m.SubtractiveVoice(),
    "additive": lambda m: m.AdditiveVoice(harmonics=HARMONICS),
    "envelope": lambda m: m.EnvelopeVoice(),
    "modal": lambda m: m.ModalVoice(m.ModalResonator.bar(300.0), strike_ms=1.0,
                                    done_threshold=1e-3),
}


def _model_schedule(bank, V):
    """Every voice triggered across block 0; a release or stop, a freq
    ramp and a deep set mid-block; event-free blocks between."""
    trig = bank._trig_names
    fi = bank.float_index
    fr = fi("freq")
    later = [(17, 1, fr, 4, 40.0), (20, 1, fr, 0, 500.0), (33, 2, fr, 0, 260.0),
             (0, 3, fi("amp"), 0, 0.05)]
    if len(trig) > 1:
        later.append((25, 4, 1, 1, 0.0))
    return {0: [(v * 9 % B, v, 0, 1, 0.0) for v in range(V)], 2: later,
            5: [(10, 6, 0, 1, 0.0), (0, 7, 0, 3, 0.0)]}


def _lockstep(jb, tb, dtype, sched, n_blocks):
    ctx, tctx = jk.AudioCtx(SR, B, dtype), kt.AudioCtx(SR, B, TDT[dtype])
    ctxf, tctxf = (dataclasses.replace(ctx, no_events=True),
                   dataclasses.replace(tctx, no_events=True))
    sj = jb.init(ctx)
    st = bank_state_from_jax(jax.tree_util.tree_map(np.asarray, sj), "cpu")
    no_in = np.zeros((0, B), dtype)
    step = jax.jit(lambda s, e: jb.process(ctx, s, no_in, {}, events=e)[:2],
                   compiler_options=EXACT)
    free = jax.jit(lambda s: jb.process(ctxf, s, no_in, {}, events=None)[:2],
                   compiler_options=EXACT)
    outs = []
    for blk in range(n_blocks):
        evs = sched.get(blk)
        if evs is None:
            sj, oj = free(sj)
            st, ot, _ = tb.process(tctxf, st, events=None)
        else:
            sj, oj = step(sj, jb.node_events_from_lists(evs, dtype))
            st, ot, _ = tb.process(tctx, st, events=tb.node_events_from_lists(evs, dtype))
        assert ot.dtype == TDT[dtype]
        outs.append((np.asarray(oj), ot.numpy()))
    return outs, jax.tree_util.tree_map(np.asarray, sj), st


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(VOICES))
def test_voice_model_bank_matches_jax(name, dtype):
    V = 8
    rng = np.random.default_rng(len(name))
    vd = {"freq": rng.uniform(150, 900, V).astype(np.float32)}
    with jax.enable_x64(dtype == np.float64):
        jb = jk.VoiceBank(VOICES[name](jk), V, voice_defaults=vd)
        jb.track_idle = True
        tb = kt.VoiceBank(VOICES[name](kt), V, voice_defaults=vd)
        outs, sj, st = _lockstep(jb, tb, dtype, _model_schedule(tb, V), 8)
    for blk, (a, b) in enumerate(outs):
        np.testing.assert_allclose(b, a, rtol=0, atol=MIX_TOL[dtype], err_msg=f"block {blk}")
    assert max(np.abs(a).max() for a, _ in outs) > 1e-3
    back = bank_state_to_numpy(st, like=sj)
    for path, x in jax.tree_util.tree_leaves_with_path(sj):
        y = back
        for k in path:
            y = y[k.key]
        assert y.shape == x.shape and y.dtype == x.dtype, path
        if dtype == np.float32 and x.dtype == np.uint32:
            drift = (y.astype(np.int64) - x.astype(np.int64) + 2**31) % 2**32 - 2**31
            assert np.abs(drift).max() <= PHASE_UNITS, (path, drift)
        elif x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=0, atol=MIX_TOL[dtype] * 10, err_msg=str(path))
        else:
            np.testing.assert_array_equal(y, x, err_msg=str(path))


def test_wide_batch_block_matches_jax():
    """At WIDE_BATCH_VOICES the voices see ctx.wide_batch (the envelope's
    per-sample loop, not the closed form), below it they do not."""
    seen = []

    def spy(voice):
        orig = voice.env.process

        def process(ctx, *args):
            seen.append(ctx.wide_batch)
            return orig(ctx, *args)

        voice.env.process = process
        return voice

    V = kt.VoiceBank.WIDE_BATCH_VOICES
    vd = {"freq": np.linspace(100, 2000, V).astype(np.float32)}
    jb = jk.VoiceBank(jk.SineVoice(attack=0.0005), V, voice_defaults=vd, event_capacity=V)
    tb = kt.VoiceBank(spy(kt.SineVoice(attack=0.0005)), V, voice_defaults=vd,
                      event_capacity=V)
    sched = {0: [(v % B, v, 0, 1, 0.0) for v in range(0, V, 3)]}
    outs, _, _ = _lockstep(jb, tb, np.float32, sched, 2)
    assert seen == [True, True]
    for a, b in outs:
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)  # the sum of 4096 voices
    small = kt.VoiceBank(spy(kt.SineVoice()), V - 1)
    ctx = kt.AudioCtx(SR, B, no_events=True)
    small.process(ctx, small.init(ctx))
    assert seen[-1] is False


# ---------------------------------------------------------------------------
# tests/test_bank_event_parity.py's vmap-bank cases
# ---------------------------------------------------------------------------

def _jump_schedule(p):
    p("jump_to_segment").set_at(1, 100)
    p("jump_to_segment").set_at(1, 400)


PARITY = {
    # name: (voice, schedule of (param, method, args in samples), frames)
    "int_set": ("int", [("sel", "set_at", 3, 37), ("sel", "set_at", 7, 201)], 256),
    "int_burst": ("int", [("sel", "set_at", 3, 10), ("sel", "set_at", 7, 40)], 256),
    "smooth_start": ("level", [("level", "smooth", 0.001, None), ("level", "set_at", 49.0, 37),
                               ("level", "set_at", -20.0, 77)], 256),
    "cfg_freezes": ("level", [("level", "smooth", 0.002, None), ("level", "set_at", 97.0, 10),
                              ("level", "smooth", 0.0, 70)], 256),
    "set_then_cfg": ("level", [("level", "smooth", 0.002, None), ("level", "set_at", 49.0, 70),
                               ("level", "smooth", 0.004, 90), ("level", "set_at", 107.0, 200)],
                     256),
    "cfg_then_set": ("level", [("level", "smooth", 0.002, None), ("level", "set_at", 97.0, 10),
                               ("level", "smooth", 0.001, 70), ("level", "set_at", 13.0, 90)],
                     256),
    "burst_ramps": ("level", [("level", "smooth", 0.001, None), ("level", "set_at", 49.0, 10),
                              ("level", "set_at", 0.0, 34)], 256),
    "set_set_cfg": ("level", [("level", "smooth", 0.002, None), ("level", "set_at", 97.0, 10),
                              ("level", "set_at", 0.0, 20), ("level", "smooth", 0.0, 30)], 256),
    "jump_to_segment": ("envelope", [("jump_to_segment", "set_at", 1, 100),
                                     ("jump_to_segment", "set_at", 1, 400)], 700),
}


def _parity_voice(m, kind):
    if kind == "int":
        return _int_level_voice(m)
    if kind == "level":
        return _level_voice(m)
    env = jk.Envelope if m is jk else kt.Envelope
    return env(0.0, [(0.02, 1.0), (0.02, 0.5), (0.02, 0.0)])


def _parity_render(m, kind, sched, frames, bank):
    g, proc = _proc(m, 1)
    h = _push(g, m.VoiceBank(_parity_voice(m, kind), 1) if bank else _parity_voice(m, kind))
    for name, method, value, at in sched:
        if bank:
            vp = h.voice_param(name)
            if method == "smooth":
                vp.smooth(0, value, None if at is None else m.Time.at(_samples(m, at)))
            else:
                vp.set_at(0, value, _samples(m, at))
        else:
            p = h.param(name)
            if method == "smooth":
                if at is None:
                    p.smooth(value)
                else:
                    p.smooth_at(value, _samples(m, at))
            else:
                p.set_at(value, _samples(m, at))
    return np.asarray(proc.render(frames=frames))[0]


@pytest.mark.parametrize("case", list(PARITY))
def test_bank_event_parity(case):
    """One voice's schedule through a port bank equals the same schedule on
    the port's graph node (the engine) and through the JAX bank."""
    kind, sched, frames = PARITY[case]
    bank = _parity_render(kt, kind, sched, frames, True)
    engine = _parity_render(kt, kind, sched, frames, False)
    jbank = _parity_render(jk, kind, sched, frames, True)
    tol = 1e-6 if kind != "level" else 1e-5
    np.testing.assert_allclose(bank, engine, rtol=0, atol=tol)
    np.testing.assert_allclose(bank, jbank, rtol=0, atol=tol)
    if case == "int_burst":
        assert (bank[9], bank[10], bank[39], bank[40]) == (1.0, 3.0, 3.0, 7.0)
    if case == "jump_to_segment":  # the same-value re-jump restarts segment 1
        assert abs(bank[400] - bank[399]) > 1e-4 or abs(bank[405] - bank[399]) > 1e-4
    if case == "cfg_freezes":
        assert abs(bank[70] - 61.0) < 1e-4 and abs(bank[200] - 61.0) < 1e-4


def test_bank_burst_two_sets_one_block():
    """tests/test_bank_event_parity.py:235: both same-block sets apply at
    their frames, in frame order whatever the list order."""
    ctx = kt.AudioCtx(SR, B)
    vb = kt.VoiceBank(_level_voice(kt), 1)
    ev = vb.node_events_from_lists([(50, 0, 0, 0, 5.0), (10, 0, 0, 0, 3.0)])
    _, out, _ = vb.process(ctx, vb.init(ctx), events=ev)
    out = out[0].numpy()
    assert (out[9], out[10], out[49], out[50], out[63]) == (1.0, 3.0, 3.0, 5.0, 5.0)


def test_fused_bank_refuses_an_int_param_by_name():
    """No kernel body reads an int param: the fused bank refuses such a
    voice, naming the param; the vmap bank takes it."""
    class IntSine(kt.SineVoice):
        params = kt.SineVoice.params + (kt.pinteger("sel", 2),)

    with pytest.raises(ValueError, match=r"integer params \['sel'\]"):
        kt.FusedVoiceBank(IntSine(), 8)
    st = kt.VoiceBank(IntSine(), 8).init(kt.AudioCtx(SR, B))
    assert st["ivals"].tolist() == [[2] * 8]


def test_burst_rounds_false_raises_by_name():
    class Single(kt.VoiceBank):
        burst_rounds = False

    bank = Single(_level_voice(kt), 2)
    with pytest.raises(NotImplementedError, match="burst_rounds=False"):
        bank.node_events_from_lists([(0, 0, 0, 0, 1.0)])


# ---------------------------------------------------------------------------
# the fused banks' plain versions against the vmap bank
# ---------------------------------------------------------------------------

def _fused_vs_vmap(fused, vmap, events, atol):
    ctx = kt.AudioCtx(SR, B)
    sf, sv = fused.init(ctx, device="cpu"), vmap.init(ctx)
    a, b = [], []
    for i in range(4):
        ev_f = fused.node_events_from_lists(events) if i == 0 else fused.empty_node_events()
        ev_v = vmap.node_events_from_lists(events) if i == 0 else vmap.empty_node_events()
        sf, of = fused.process(ctx, sf, events=ev_f)
        sv, ov, _ = vmap.process(ctx, sv, events=ev_v)
        a.append(of.numpy())
        b.append(ov.numpy())
    a, b = np.concatenate(a, 1), np.concatenate(b, 1)
    assert np.abs(b).max() > 1e-3
    np.testing.assert_allclose(a, b, atol=atol)


def _saw_table():
    nb = kt.NonAaWavetable()
    nb.add_saw(1, 12, 1.0)
    return nb.buffer


@pytest.mark.parametrize("kind", ["sine", "fm", "subtractive", "wavetable"])
def test_fused_bank_plain_matches_vmap_bank(kind):
    V = 1024
    rng = np.random.default_rng(3)
    if kind == "sine":
        d = {"freq": rng.uniform(100, 4000, V).astype(np.float32),
             "amp": np.full(V, 0.01, np.float32), "pan": rng.uniform(-1, 1, V).astype(np.float32)}
        fused = kt.FusedSineVoiceBank(V, voice_defaults=d, event_capacity=2048)
        voice, extra = kt.SineVoice(), [(17, 5, 1, 1, 0.0), (0, 7, 0, 0, 1234.0)]
    elif kind == "fm":
        d = {"freq": rng.uniform(100, 1000, V).astype(np.float32),
             "ratio": rng.choice([1.0, 2.0], V).astype(np.float32),
             "index": rng.uniform(0.5, 2.0, V).astype(np.float32),
             "amp": np.full(V, 0.01, np.float32)}
        fused, voice, extra = kt.FusedFMVoiceBank(V, voice_defaults=d, event_capacity=2048), \
            kt.FMVoice(), []
    elif kind == "subtractive":
        d = {"freq": rng.uniform(50, 400, V).astype(np.float32),
             "cutoff": rng.uniform(300, 5000, V).astype(np.float32),
             "q": rng.uniform(0.6, 3.0, V).astype(np.float32),
             "amp": np.full(V, 0.01, np.float32)}
        fused = kt.FusedSubtractiveVoiceBank(V, voice_defaults=d, event_capacity=2048)
        voice, extra = kt.SubtractiveVoice(), [(30, 4, 1, 1, 0.0)]
    else:
        d = {"freq": rng.uniform(60, 3000, V).astype(np.float32),
             "amp": np.full(V, 0.01, np.float32), "pan": rng.uniform(-1, 1, V).astype(np.float32)}
        fused = kt.FusedWavetableVoiceBank(V, table=_saw_table(), n_harmonics=12,
                                           voice_defaults=d, event_capacity=2048)
        voice = kt.AdditiveVoice(table=_saw_table(), n_harmonics=12)
        extra = [(25, 7, 1, 1, 0.0)]
    vmap = kt.VoiceBank(voice, V, voice_defaults=d, event_capacity=2048)
    step = 5 if kind == "sine" else 2
    events = [(0, v, 0, 1, 0.0) for v in range(0, V, step)] + extra
    _fused_vs_vmap(fused, vmap, events, 1e-5)


# ---------------------------------------------------------------------------
# VoicePool, int params through handles, the converter
# ---------------------------------------------------------------------------

def test_pool_over_vmap_bank_thousand_note_ons_zero_recompiles():
    """tests/test_voice_pool.py:36 over the port's vmap bank."""
    g, proc = _proc(kt, 2)
    bank = _push(g, kt.VoiceBank(kt.SineVoice(attack=0.001, release=0.004), 64,
                                 event_capacity=512))
    pool = kt.VoicePool(proc, bank)
    proc.render(frames=64)
    rev0, compiled0 = g.revision, proc.compiled
    played, peak = 0, 0.0
    rng = np.random.default_rng(0)
    while played < 1000:
        burst = min(16, 1000 - played)
        voices = []
        for _ in range(burst):
            v = pool.note_on({"freq": float(rng.uniform(100, 900)), "amp": 0.002})
            assert v is not None, f"pool dry at note {played}"
            voices.append(v)
        played += burst
        peak = max(peak, float(np.abs(proc.render(frames=64 * 2)).max()))
        for v in voices:
            pool.note_off(v)
        proc.render(frames=64 * 8)
    assert peak > 1e-4
    assert g.revision == rev0 and proc.compiled is compiled0
    proc.render(frames=64 * 8)
    pool.refresh()
    assert pool.free_count == pool.n_voices


def test_int_voice_param_through_handle():
    """An int voice param set per voice through ``Handle.voice_param``,
    sample-accurate, beside the JAX graph's render; an enum member sets its
    value."""
    def render(m):
        g, proc = _proc(m, 1)
        bank = _push(g, m.VoiceBank(_int_level_voice(m), 3, mix="sum"))
        sel = bank.voice_param("sel")
        assert sel.ptype == "integer"
        sel.set_at(0, 5, _samples(m, 30))
        sel.set_at(2, m.Waveform.Square, _samples(m, 90))
        return np.asarray(proc.render(frames=192))[0]

    a = render(kt)
    assert (a[29], a[30], a[89], a[90]) == (3.0, 7.0, 7.0, 7.0 - 1.0 + int(kt.Waveform.Square))
    np.testing.assert_array_equal(a, render(jk))


def test_state_through_the_converter():
    """A JAX vmap bank's state (an FM bank after eventful blocks: u32
    phases, int32 stages, ramps in flight) crosses into the port, which
    continues the render; the port's state crosses back leaf for leaf; a
    graph holding a PluckedVoice bank (a u32 frame and the unbatched
    shared leaves) crosses the same way."""
    V = 16
    rng = np.random.default_rng(9)
    vd = {"freq": rng.uniform(150, 600, V).astype(np.float32)}
    jb = jk.VoiceBank(jk.FMVoice(), V, voice_defaults=vd)
    jb.track_idle = True
    tb = kt.VoiceBank(kt.FMVoice(), V, voice_defaults=vd)
    ctx = jk.AudioCtx(SR, B, np.float32)
    sj = jb.init(ctx)
    no_in = np.zeros((0, B), np.float32)
    step = jax.jit(lambda s, e: jb.process(ctx, s, no_in, {}, events=e)[:2],
                   compiler_options=EXACT)
    free = jax.jit(lambda s: jb.process(ctx, s, no_in, {}, events=None)[:2],
                   compiler_options=EXACT)
    fr = jb.float_index("freq")
    for evs in ([(v, v, 0, 1, 0.0) for v in range(V)], [(0, 3, fr, 4, 300.0),
                                                         (9, 3, fr, 0, 800.0)]):
        sj = step(sj, jb.node_events_from_lists(evs))[0]
    np_state = jax.tree_util.tree_map(np.asarray, sj)
    st = bank_state_from_jax(np_state, "cpu")
    assert st["voices"]["car"]["phase"].dtype == torch.int32
    assert st["voices"]["env"]["stage"].shape == (V,)
    back = bank_state_to_numpy(st, like=np_state)
    for a, b in zip(jax.tree_util.tree_leaves(np_state), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    tctx = kt.AudioCtx(SR, B)
    for _ in range(3):
        sj, oj = free(sj)
        st, ot, _ = tb.process(tctx, st, events=None)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=MIX_TOL[np.float32])

    def graph(m):
        g, proc = _proc(m, 2)
        pv = (kt.PluckedVoice if m is kt else JPluckedVoice)(seed=2)

        def build(gg):
            b = gg.push(m.VoiceBank(pv, 2, voice_defaults={"vseed": np.arange(2)}))
            b.out([0, 0]).to_graph_out()
            return b

        b = g.edit(build)
        g.commit()
        b.voice_param("t_pluck").trig(1)
        proc.render(frames=4 * B)
        return proc

    pj, pt = graph(jk), graph(kt)
    js = jax.tree_util.tree_map(np.asarray, pj.state)
    pt.state = graph_state_from_jax(js, "cpu")
    back = graph_state_to_numpy(pt.state, like=js)
    for a, b in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    shared = [v for v in pt.state["nodes"].values() if "voices" in v and "wq" in v["voices"]]
    assert shared and shared[0]["voices"]["wq"].shape == ()
    pt.graph.clock.frames = pj.graph.clock.frames
    np.testing.assert_allclose(pt.render(frames=4 * B), np.asarray(pj.render(frames=4 * B)),
                               rtol=0, atol=1e-6)
