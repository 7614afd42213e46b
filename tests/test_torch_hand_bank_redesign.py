"""The rules of the hand sine and subtractive kernels' Hopper design, on the
CPU, each restated in plain torch f32 and held bit-equal to the form it
replaces; and additive tables past the largest unrolled instantiation.

- The one-divide BLEP (``bank_common._blep_one_divide``, the kernel's
  ``blep_warp``) against ``_blep``'s two-divide form over a (t, dt) grid
  and its edges.
- Event-free ``_env_asr`` at stage 0 or 2 (``env_asr_steady``) leaves
  (stage, t, rscale) as they are and gives one value, over B samples.
- ``_sin_quant`` read from a table of its 4097 first-quadrant values.
- The pan pack's flat rule (``pack_flat_over_block``) against per-sample
  ``_pan_gains``: exact, and true where the kernel hoists the gains.
- The increment and dt hoists: where ``ramp_flat_over_block`` holds, the
  u32 increment and the saw's dt from ``_mat`` at sample 0 are every
  sample's.
- The staging the kernels' prologue now does (``fold_act``, ``pan_pack``,
  ``sine_bank.stage_event_free``), and the FM and wavetable banks' host
  staging by the same functions, against the parent design's host staging
  from the carried integer ramp state (restated here): bit-equal.
- 128-harmonic wavetable and generic Additive banks (the run-time variant
  on the card) against the JAX banks, as tests/test_torch_wt_bank.py and
  tests/test_torch_generic_bank.py hold the 16-harmonic ones.
"""

import numpy as np
import pytest
import torch
from test_torch_fm_bank import rich_schedule
from test_torch_sine_bank import lockstep
from test_torch_wt_bank import saw_table, wt_defaults

import knaster_tpu as kt
from knaster_tpu import PallasWavetableVoiceBank

import knaster_tpu_torch as ktt
from knaster_tpu_torch.kernels import bank_common as bc
from knaster_tpu_torch.kernels import sine_bank as sk
from knaster_tpu_torch.kernels import sub_bank as uk
from knaster_tpu_torch.parallel import fused_bank as fbk

SR = 48000
F32 = torch.float32


def _bits(x):
    return x.contiguous().view(torch.int32)


def _f32(*xs):
    return torch.tensor(np.float32(xs), dtype=F32)


# --------------------------------------------------------------------------
# the one-divide BLEP
# --------------------------------------------------------------------------

def _blep_grid():
    """(t, dt) pairs: a dense grid, random pairs, and every edge."""
    min_dt = np.float32(1e-9)
    dts = np.float32([0.0, -0.0, min_dt / 2, min_dt, np.nextafter(min_dt, 1, dtype=np.float32),
                      1e-6, 1e-3, 0.0123, 0.1, 0.25, 0.4999, 0.5])
    ts = [np.float32(0.0), np.nextafter(np.float32(1), 0, dtype=np.float32)]
    pairs = [(t, dt) for t in ts for dt in dts]
    for dt in dts:
        # t == dt, t == 1 - dt and their neighbours
        for x in (dt, np.float32(1) - dt):
            pairs += [(x, dt), (np.nextafter(x, 0, dtype=np.float32), dt),
                      (np.nextafter(x, 1, dtype=np.float32), dt)]
    rng = np.random.default_rng(0)
    t = rng.random(20000).astype(np.float32)
    dt = rng.choice(dts, 20000)
    grid_t, grid_dt = np.meshgrid(np.linspace(0, 1, 257, dtype=np.float32)[:-1], dts)
    t = np.concatenate([t, grid_t.ravel(), np.float32([p[0] for p in pairs])])
    dt = np.concatenate([dt, grid_dt.ravel(), np.float32([p[1] for p in pairs])])
    return torch.from_numpy(t.astype(np.float32)), torch.from_numpy(dt.astype(np.float32))


def test_one_divide_blep_is_the_two_divide_blep():
    t, dt = _blep_grid()
    want = bc._blep(t, dt)
    got = bc._blep_one_divide(t, dt)
    assert torch.equal(_bits(got), _bits(want))
    # not vacuous: both edges and the flat middle occur, dt = 0 among them
    assert bool((want < 0).any()) and bool((want > 0).any()) and bool((want == 0).any())
    assert bool(((dt == 0) & (t < 1e-30)).any())


# --------------------------------------------------------------------------
# sin_quant from a table of its first-quadrant values
# --------------------------------------------------------------------------

def test_sin_table_is_sin_quant_at_every_index():
    """The sine kernel reads ``_sin_quant``'s polynomial from a shared-memory
    table of its 4097 first-quadrant values, ``_sin_poly(m * idx_scale)``
    for m = 0 ... 4096 (csrc/bank_common.cuh fill_sin_table,
    sin_quant_table): the same fold, the value read instead of evaluated."""
    table = bc._sin_poly(torch.arange(4097).to(F32) * bc._IDX_SCALE)
    rng = np.random.default_rng(5)
    idx = np.arange(16384, dtype=np.int64)
    phase = torch.from_numpy((idx << 16) | rng.integers(0, 2**16, 16384))
    i = (phase >> 16) & 16383
    half = i & 8191
    m = torch.where(half > 4096, 8192 - half, half)
    got = torch.where(i >= 8192, -table[m], table[m])
    assert torch.equal(_bits(got), _bits(bc._sin_quant(phase)))
    assert int(m.max()) == 4096 and int(m.min()) == 0


# --------------------------------------------------------------------------
# the steady envelope
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 64, 1024])
def test_event_free_env_asr_is_steady_at_stages_0_and_2(B):
    rng = np.random.default_rng(B)
    n = 4096
    stage = torch.from_numpy(rng.choice(np.float32([0.0, -0.0, 1.0, 2.0, 3.0]), n))
    t = torch.from_numpy(rng.choice(np.float32([0.0, 0.3, 1.0, 1e-4, 0.99995]), n))
    rscale = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    atk, rel = _f32(1 / 480)[0], _f32(1 / 9600)[0]
    steady = bc.env_asr_steady(stage)
    assert int(steady.sum()) > n // 3 and not bool(steady.all())
    want_env = torch.where(stage == 2, _f32(1.0)[0], _f32(0.0)[0])
    s, tt, r = stage, t, rscale
    for _ in range(B):
        env, s, tt, r = bc._env_asr(s, tt, r, None, None, atk, rel)
        assert torch.equal(_bits(env[steady]), _bits(want_env[steady]))
    for before, after in ((stage, s), (t, tt), (rscale, r)):
        assert torch.equal(_bits(after[steady]), _bits(before[steady]))


# --------------------------------------------------------------------------
# the pan pack's flat rule
# --------------------------------------------------------------------------

def _pan_ramps(seed, n, B):
    """[5, n] raw pan ramp groups (v0, step, el, dur, tgt): random ones and
    every edge of the rule."""
    rng = np.random.default_rng(seed)
    v0 = rng.choice(np.float32([-1.0, -0.0, 0.0, 0.3, 1.0]), n)
    step = rng.choice(np.float32([0.0, -0.0, 1e-3, -2e-2]), n)
    el = rng.integers(-3, 2 * B, n).astype(np.float32)
    dur = rng.integers(0, 3 * B, n).astype(np.float32)
    tgt = rng.choice(np.float32([-1.0, -0.0, 0.25, 0.9]), n)
    edges = [
        (0.3, 0.01, 5.0, 5.0, 0.9),              # ended at sample 0 (rem = 0)
        (0.3, 0.01, 5.0, 5.0 + B - 1, 0.9),      # ends at the last sample (rem = B - 1)
        (0.3, 0.0, 5.0, 5.0 + B - 1, 0.9),       # zero step, ends at the last sample
        (0.3, 0.0, 5.0, 5.0 + B, 0.9),           # zero step, ends after the block
        (-0.0, 0.0, 0.0, 4.0 * B, 0.9),          # -0.0 pan, +0.0 step
        (-0.0, -0.0, 0.0, 4.0 * B, -0.0),        # -0.0 pan, -0.0 step, -0.0 target
        (-1.0, -0.0, 0.0, 4.0 * B, 0.9),         # the angle's zero (+0.0), -0.0 step
        (0.3, 0.02, 0.0, 3.0 * B, 0.9),          # a glide across the block
        (0.0, 0.0, 10.0, 2.0, -0.0),             # ended at -0.0
    ]
    g = np.concatenate([np.stack([v0, step, el, dur, tgt]),
                        np.array(edges, np.float32).T], axis=1)
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("B", [1, 48, 64, 1024])
def test_pack_flat_rule_holds_only_where_the_gains_are_one_pair(B):
    g = _pan_ramps(B, 3000, B)
    pack = bc.pan_pack(g)
    flat = bc.pack_flat_over_block(pack, B)
    l0, r0 = bc._pan_gains(0.0, pack)
    same = torch.ones_like(flat)
    for i in range(1, B):
        l, r = bc._pan_gains(float(i), pack)
        same &= (_bits(l) == _bits(l0)) & (_bits(r) == _bits(r0))
    assert bool((same | ~flat).all()), "the rule says flat where the gains vary"
    assert int(flat.sum()) > 500
    n = g.shape[1]
    edge = flat[n - 9:].tolist()
    assert edge[0] and edge[3] and edge[4] and edge[5] and edge[6] and edge[8]
    assert edge[1] == edge[2] == (B == 1) and not edge[7]
    # the angle's zero is +0.0: its hoisted gains are sin_poly(+0.0)'s
    assert _bits(pack[0, n - 3]).item() == 0 and _bits(r0[n - 3]).item() == 0


# --------------------------------------------------------------------------
# the increment and dt hoists
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 64, 1024])
def test_increment_and_dt_hoists_match_every_sample(B):
    rng = np.random.default_rng(7 + B)
    n = 3000
    v0 = rng.choice(np.float32([0.0, -0.0, 55.0, 440.0, 1.0e5, -300.0, 23999.0]), n)
    step = rng.choice(np.float32([0.0, -0.0, 0.5, -1e-3]), n)
    el = rng.integers(-3, 2 * B, n).astype(np.float32)
    dur = rng.integers(0, 3 * B, n).astype(np.float32)
    tgt = rng.choice(np.float32([0.0, 880.0, 1e9]), n)
    g = torch.from_numpy(np.stack([v0, step, el, dur, tgt]))
    flat = bc.ramp_flat_over_block(g, B)
    f2pi = _f32(2.0**30 / SR)[0]
    inv_sr = _f32(1.0 / SR)[0]

    def inc(i):
        return bc._to_inc(bc._mat(float(i), g) * f2pi)

    def dt(i):
        return torch.clamp(bc._mat(float(i), g) * inv_sr, 0.0, 0.5)

    inc0, dt0 = inc(0), dt(0)
    for i in range(1, B):
        assert torch.equal(inc(i)[flat], inc0[flat])
        assert torch.equal(_bits(dt(i)[flat]), _bits(dt0[flat]))
    assert int(flat.sum()) > 500 and bool((dt0[flat] == 0).any())


# --------------------------------------------------------------------------
# the staging moved into the kernels' prologue
# --------------------------------------------------------------------------

def _ramping_bank(cls, fparams, B=64, V=200, **kw):
    """A bank with ramps in flight, sets mid-block and inactive voices, and
    the event-free block's carried ramp state."""
    bank = cls(V, event_capacity=1024, **kw)
    ctx = ktt.AudioCtx(SR, B)
    st = bank.init(ctx, device="cpu")
    for evs in rich_schedule(bank, fparams, B)[:3]:
        ev = None if evs is None else bank.node_events_from_lists(evs)
        st, _ = bank.process(ctx, st, events=ev)
    return bank, ctx, st


def _host_fold(bank, ramps, act):
    """The parent design's host act fold, in place: amp's (v0, step, tgt)
    times act."""
    amp = ramps[bank.float_index("amp")]
    for j in (0, 1, 4):
        amp[j].mul_(act)


def _host_pack(bank, fstate):
    """The parent design's host pan pack [5, V], from the carried ramp state
    with its integer elapsed and duration."""
    i = bank.float_index("pan")
    fvals, ftgt, fstep, fel, fdur, _ = fstate
    v0 = torch.where(fel[i] >= fdur[i], ftgt[i], fvals[i] + fstep[i] * fel[i].to(F32))
    a0 = (v0 * 0.5 + 0.5) * bc._HALF_PI
    da = fstep[i] * np.float32(np.pi / 4.0)
    at = (ftgt[i] * 0.5 + 0.5) * bc._HALF_PI
    return torch.stack([a0, da, torch.cos(at), torch.sin(at), (fdur[i] - fel[i]).to(F32)])


@pytest.mark.parametrize("cls, fparams", [
    (ktt.FusedSineVoiceBank, {"pan": -0.7, "freq": 13000.0, "amp": 0.02}),
    (ktt.FusedSubtractiveVoiceBank, {"cutoff": 900.0, "q": 3.0, "amp": 0.02}),
])
def test_prologue_staging_is_the_host_staging(cls, fparams):
    bank, ctx, st = _ramping_bank(cls, fparams)
    ops, carry = bank.kernel_operands(ctx, st)
    fstate, active = carry[0], carry[2]
    act = active.to(F32)
    assert torch.equal(ops["act"], act) and not bool(act.all()) and bool(act.any())
    host = fbk._ramp_operands(fstate, F32)
    assert torch.equal(_bits(ops["ramps"]), _bits(host))  # raw, nothing folded in
    _host_fold(bank, host, act)
    amp = bank.float_index("amp")
    folded = ops["ramps"][amp].clone()
    bc.fold_act(folded, act)
    assert torch.equal(_bits(folded), _bits(host[amp]))
    if "pan" in fparams:
        pan = bank.float_index("pan")
        host[pan] = _host_pack(bank, fstate)
        assert torch.equal(_bits(bc.pan_pack(ops["ramps"][pan])), _bits(host[pan]))
        assert torch.equal(_bits(sk.stage_event_free(ops["ramps"], act)), _bits(host))
        # a pan ramp is in flight: the pack is not all flat
        assert not bool(bc.pack_flat_over_block(host[pan], ctx.block_size).all())


@pytest.mark.parametrize("cls, fparams, kw", [
    (ktt.FusedFMVoiceBank, {"ratio": 3.0, "freq": 13000.0, "amp": 0.02}, {}),
    (ktt.FusedWavetableVoiceBank, {"pan": -0.7, "freq": 13000.0, "amp": 0.02},
     {"harmonics": [1.0, 0.5, 0.25]}),
])
def test_host_staging_is_the_parent_host_staging(cls, fparams, kw):
    """The FM and wavetable banks stage an event-free block on the host by
    ``bank_common.fold_act`` and ``pan_pack``: bit-equal to the parent
    design's staging from the integer ramp state, and no act."""
    bank, ctx, st = _ramping_bank(cls, fparams, **kw)
    ops, carry = bank.kernel_operands(ctx, st)
    assert ops["act"] is None and ops["rounds"] is None
    act = carry[2].to(F32)
    assert not bool(act.all()) and bool(act.any())
    host = fbk._ramp_operands(carry[0], F32)
    _host_fold(bank, host, act)
    if "pan" in fparams:
        host[bank.float_index("pan")] = _host_pack(bank, carry[0])
        assert not bool(bc.pack_flat_over_block(host[bank.float_index("pan")],
                                                ctx.block_size).all())
    assert torch.equal(_bits(ops["ramps"]), _bits(host))


@pytest.mark.parametrize("mod, cls, fparams", [
    (sk, ktt.FusedSineVoiceBank, {"pan": -0.7, "freq": 13000.0, "amp": 0.02}),
    (uk, ktt.FusedSubtractiveVoiceBank, {"cutoff": 900.0, "q": 3.0, "amp": 0.02}),
])
def test_plain_version_on_raw_operands_is_the_host_staged_block(mod, cls, fparams):
    """The plain version fed the raw groups and act renders the block the
    parent design's host staging rendered: the same mix and state, bit for
    bit (the eventful path, which reads act per sample, never staged)."""
    bank, ctx, st = _ramping_bank(cls, fparams)
    ops, carry = bank.kernel_operands(ctx, st)
    got = mod.__dict__[mod.KERNEL + "_plain"](**ops)
    act = ops["act"]
    host = fbk._ramp_operands(carry[0], F32)
    _host_fold(bank, host, act)
    if "pan" in fparams:
        host[bank.float_index("pan")] = _host_pack(bank, carry[0])
    staged = dict(ops, ramps=host, act=None)
    if mod is sk:
        want = _sine_plain_staged(**staged)
    else:
        want = _sub_plain_staged(**staged)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a) if a.dtype == F32 else a, _bits(b) if b.dtype == F32 else b)


def _sine_plain_staged(*, ramps, rounds, act, words, phase, stage, t, rscale, block_size,
                       atk, rel, f2pi):
    """The parent design's plain sine block on host-staged operands."""
    B = block_size
    atk, rel, f2pi = (bc.scalar(x, "cpu") for x in (atk, rel, f2pi))
    ph = bc.u32_of(phase)
    outl, outr = [], []
    for i in range(B):
        env, stage, t, rscale = bc._env_asr(stage, t, rscale, None, None, atk, rel)
        gain = env * bc._mat(float(i), ramps[sk.AMP])
        osc = bc._sin_quant(ph)
        ph = bc.u32_add(ph, bc._to_inc(bc._mat(float(i), ramps[sk.FREQ]) * f2pi))
        sig = osc * gain
        panl, panr = bc._pan_gains(float(i), ramps[sk.PAN])
        outl.append(torch.sum(sig * panl))
        outr.append(torch.sum(sig * panr))
    return (torch.stack([torch.stack(outl), torch.stack(outr)]), bc.i32_of(ph), stage, t,
            rscale)


def _sub_plain_staged(*, ramps, rounds, act, words, t, ic1, ic2, stage, et, rscale,
                      block_size, atk, rel, inv_sr, pi_inv_sr):
    """The parent design's plain subtractive block on host-staged operands."""
    atk, rel, inv_sr, pi_inv_sr = (bc.scalar(x, "cpu") for x in (atk, rel, inv_sr, pi_inv_sr))
    one, two, half = np.float32(1.0), np.float32(2.0), np.float32(0.5)
    out = []
    for i in range(block_size):
        env, stage, et, rscale = bc._env_asr(stage, et, rscale, None, None, atk, rel)
        dt = torch.clamp(bc._mat(float(i), ramps[uk.FREQ]) * inv_sr, 0.0, 0.5)
        tt = t + half
        tt = tt - torch.floor(tt)
        saw = two * tt - one - bc._blep(tt, dt)
        t = t + dt
        t = t - torch.floor(t)
        a1, a2, a3 = bc._svf_low_coeffs(pi_inv_sr * bc._mat(float(i), ramps[uk.CUT]),
                                        bc._mat(float(i), ramps[uk.Q]))
        v3 = saw - ic2
        v1 = a1 * ic1 + a2 * v3
        v2 = ic2 + a2 * ic1 + a3 * v3
        ic1 = two * v1 - ic1
        ic2 = two * v2 - ic2
        out.append(torch.sum(v2 * (env * bc._mat(float(i), ramps[uk.AMP]))))
    return torch.stack(out)[None], t, ic1, ic2, stage, et, rscale


# --------------------------------------------------------------------------
# additive tables past the largest unrolled instantiation
# --------------------------------------------------------------------------

H_LARGE = 128


def test_128_harmonic_wavetable_bank_matches_jax():
    V, B = 128, 64
    d = wt_defaults(V, 31)
    kw = dict(table=saw_table(H_LARGE), n_harmonics=H_LARGE, voice_defaults=d,
              event_capacity=1024, attack=0.002)
    fb = ktt.FusedWavetableVoiceBank(V, **kw)
    assert bc.harmonic_slots(len(fb.mags)) == bc.RUNTIME_H
    sched = rich_schedule(fb, {"pan": -0.7, "freq": 13000.0, "amp": 0.02}, B)[:5]
    mix, st = lockstep(PallasWavetableVoiceBank(V, **kw), fb, B, sched)
    assert np.abs(mix).max() > 1e-3


def test_128_harmonic_additive_bank_matches_jax():
    V, B = 128, 64
    d = wt_defaults(V, 32)
    voice = dict(table=saw_table(H_LARGE), n_harmonics=H_LARGE, attack=0.002)
    fb = ktt.FusedVoiceBank(ktt.AdditiveVoice(**voice), V, voice_defaults=d,
                            event_capacity=1024)
    assert fb.spec(ktt.AudioCtx(SR, B)).consts.shape == (3 + 3 * H_LARGE,)
    sched = rich_schedule(fb, {"freq": 13000.0, "amp": 0.02, "pan": -0.7}, B)[:5]
    jb = kt.PallasVoiceBank(kt.AdditiveVoice(**voice), V, voice_defaults=d,
                            event_capacity=1024)
    mix, _ = lockstep(jb, fb, B, sched)
    assert np.abs(mix).max() > 1e-3
