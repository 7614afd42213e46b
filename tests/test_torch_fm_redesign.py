"""The rules of the FM bank and FM cascade kernels' Hopper design, on the CPU,
each restated in plain torch f32 and held bit-equal to the form it replaces.

- Event-free ``_env_ar`` is steady only at stage 0 (``env_ar_steady``):
  there (stage, t) stay and env is 0; attack and release move t at every
  sample.
- The FM kernel's per-block hoists (csrc/fm_bank.cu): where
  ``ramp_flat_over_block`` holds, freq, ratio, index and amp from ``_mat``
  at sample 0, and the modulator's u32 increment where freq and ratio are
  both flat, are every sample's, over ``chip_smoke.flat_edge_cases``.
- The kernel's event-free block as it decides by warp (hoists taken where
  every lane can, warps of zero gains skipping the carrier's sine and the
  mix but running both phase recurrences) against ``fm_bank_plain``:
  state bit-equal, mix equal.
- ``chip_smoke.hand_ops_per_sample`` counts the FM kernel's three paths.
- The cascade kernel's cluster split: ``fm_cascade_plain`` with each stage's
  scan cut into the slices of ``fm_cascade.launch_plan`` (C = 2 and 16),
  each slice's prefix offset by the totals of the slices before it, gives
  the one-scan phases and block bit for bit; the plan's slices cover the
  block; ``FMCascade``'s superblock cap is not lowered.
"""

import numpy as np
import pytest
import torch
from test_torch_fm_bank import rich_schedule

import chip_smoke as cs
import knaster_tpu_torch as ktt
from knaster_tpu_torch.kernels import bank_common as bc
from knaster_tpu_torch.kernels import fm_bank as fk
from knaster_tpu_torch.kernels import fm_cascade as kfc

SR = 48000
F32 = torch.float32
# FMCascade's superblock cap before the cluster layout: the one-CTA row of
# the 227 KB a block can hold, less 32 static words
PARENT_CAP = (227 * 1024 - 128) // 4


def _bits(x):
    return x.contiguous().view(torch.int32)


# --------------------------------------------------------------------------
# the steady envelope
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 64, 1024])
def test_event_free_env_ar_is_steady_only_at_stage_0(B):
    rng = np.random.default_rng(B)
    n = 4096
    stage = torch.from_numpy(rng.choice(np.float32([0.0, -0.0, 1.0, 2.0]), n))
    t = torch.from_numpy(rng.choice(np.float32([0.0, 0.3, 0.99995, 1e-4, 0.7]), n))
    atk, rel = torch.tensor(np.float32(1 / 480)), torch.tensor(np.float32(1 / 9600))
    steady = bc.env_ar_steady(stage)
    assert torch.equal(steady, stage == 0) and 0 < int(steady.sum()) < n
    s, tt = stage, t
    for i in range(B):
        env, s, tt = bc._env_ar(s, tt, None, atk, rel)
        assert torch.equal(_bits(env[steady]), torch.zeros_like(_bits(env[steady])))
        if i == 0:
            # attack and release move (stage, t) at the first sample already
            moved = (s != stage) | (tt != t)
            assert bool(moved[~steady].all())
    assert torch.equal(_bits(s[steady]), _bits(stage[steady]))
    assert torch.equal(_bits(tt[steady]), _bits(t[steady]))


# --------------------------------------------------------------------------
# the per-block hoists
# --------------------------------------------------------------------------

def _fm_bank(B, V=320, seed=3):
    """A bank with ramps in flight and sets mid-block, its event-free
    operands with the flat-ramp edge cases by warp and the EnvAr stages by
    warp (chip_smoke's matrix), phases near the top of the u32 range."""
    bank = ktt.FusedFMVoiceBank(V, voice_defaults=cs.fm_defaults(np, V, seed, amp=0.01),
                                event_capacity=1024)
    ctx = ktt.AudioCtx(SR, B)
    st = bank.init(ctx, device="cpu")
    fparams = {"ratio": 3.0, "index": 2.5, "freq": 13000.0, "amp": 0.02}
    for evs in rich_schedule(bank, fparams, B)[:3]:
        ev = None if evs is None else bank.node_events_from_lists(evs)
        st, _ = bank.process(ctx, st, events=ev)
    st = cs.steady_stages(torch, bank, st)
    rng = np.random.default_rng(seed)
    for name in ("phm", "phc"):
        st[name] = torch.from_numpy(rng.integers(2**32 - 2**26, 2**32, V, dtype=np.uint64)
                                    .astype(np.uint32).view(np.int32))
    ops, _ = bank.kernel_operands(ctx, st)
    return bank, cs.flat_edge_cases(torch, bank, ops, B, by_warp=True)


def _folded(ops):
    ramps = ops["ramps"].clone()
    bc.fold_act(ramps[fk.AMP], ops["act"])
    return ramps


@pytest.mark.parametrize("B", [1, 64, 1024])
def test_fm_hoists_match_every_sample(B):
    _, ops = _fm_bank(B)
    ramps = _folded(ops)
    f2pi = bc.scalar(ops["f2pi"], "cpu")
    flat = {p: bc.ramp_flat_over_block(ramps[p], B)
            for p in (fk.FREQ, fk.RATIO, fk.INDEX, fk.AMP)}
    first = {p: bc._mat(0.0, ramps[p]) for p in flat}
    both = flat[fk.FREQ] & flat[fk.RATIO]
    incm0 = bc._to_inc(first[fk.FREQ] * first[fk.RATIO] * f2pi)
    for i in range(1, B):
        now = {p: bc._mat(float(i), ramps[p]) for p in flat}
        for p, m in flat.items():
            assert torch.equal(_bits(now[p][m]), _bits(first[p][m])), (p, i)
        inc = bc._to_inc(now[fk.FREQ] * now[fk.RATIO] * f2pi)
        assert torch.equal(inc[both], incm0[both])
    # not vacuous: flat and moving ramps of every param, edge cases among them
    for p, m in flat.items():
        assert 0 < int(m.sum()) < m.numel(), p
    assert bool((incm0[both] == 0).any()) and bool((incm0[both] > 0).any())


def _by_warp(x):
    """bool [V] -> bool [V]: every lane of the lane's warp (ragged lanes
    count as true)."""
    pad = torch.ones((-x.numel()) % 32, dtype=torch.bool)
    w = torch.cat([x, pad]).view(-1, 32).all(dim=1)
    return w.repeat_interleave(32)[:x.numel()]


def _fm_block_as_kernel(ops):
    """csrc/fm_bank.cu's event-free block restated in torch as it decides by
    warp: act folded, the hoists of flat ramps from sample 0 where a whole
    warp's are flat, a warp of zero gains (steady envelopes, flat amps)
    skipping the carrier's sine and the mix but not the phases."""
    B = ops["block_size"]
    atk, rel, f2pi = (bc.scalar(ops[k], "cpu") for k in ("atk", "rel", "f2pi"))
    ramps = _folded(ops)
    stage, t = ops["stage"], ops["t"]
    f = {p: _by_warp(bc.ramp_flat_over_block(ramps[p], B))
         for p in (fk.FREQ, fk.RATIO, fk.INDEX, fk.AMP)}
    v0 = {p: bc._mat(0.0, ramps[p]) for p in f}
    f_env = _by_warp(bc.env_ar_steady(stage))
    quiet = f_env & f[fk.AMP] & _by_warp(0.0 * v0[fk.AMP] == 0)
    incm0 = bc._to_inc(v0[fk.FREQ] * v0[fk.RATIO] * f2pi)
    pm, pc = bc.u32_of(ops["phm"]), bc.u32_of(ops["phc"])
    zero = torch.zeros((), dtype=F32)
    out = []
    for i in range(B):
        val = {p: torch.where(f[p], v0[p], bc._mat(float(i), ramps[p])) for p in f}
        env, s2, t2 = bc._env_ar(stage, t, None, atk, rel)
        stage, t = torch.where(f_env, stage, s2), torch.where(f_env, t, t2)
        gain = torch.where(f_env, zero, env) * val[fk.AMP]
        mod = bc._sin_quant(pm)
        incm = torch.where(f[fk.FREQ] & f[fk.RATIO], incm0,
                           bc._to_inc(val[fk.FREQ] * val[fk.RATIO] * f2pi))
        pm = bc.u32_add(pm, incm)
        car_freq = val[fk.FREQ] * (np.float32(1.0) + val[fk.INDEX] * mod)
        car = bc._sin_quant(pc)
        out.append(torch.sum(torch.where(quiet, zero, car * gain)))
        pc = bc.u32_add(pc, bc._to_inc(car_freq * f2pi))
    return torch.stack(out)[None], bc.i32_of(pm), bc.i32_of(pc), stage, t, quiet


@pytest.mark.parametrize("B", [1, 64, 1024])
def test_kernel_block_by_warp_is_the_plain_block(B):
    _, ops = _fm_bank(B)
    *got, quiet = _fm_block_as_kernel(ops)
    want = fk.fm_bank_plain(**ops)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got[0], want[0])  # by value: a skipped term was +-0
    # both sides of every warp-uniform decision ran
    assert bool(quiet.any()) and not bool(quiet.all())


def test_hand_ops_per_sample_counts_the_fm_paths():
    B = 64
    _, ops = _fm_bank(B, V=256)
    ramps = ops["ramps"].clone()
    ramps[:, 1] = 0.0  # no step
    ramps[:, 2] = 0.0  # no ramp has ended
    ramps[:, 3] = 4.0 * B
    stopped = torch.zeros_like(ops["stage"])
    flat_ops = dict(ops, ramps=ramps, stage=stopped)
    assert cs.hand_ops_per_sample(torch, fk, flat_ops, B) == (
        cs.QUIET_OPS_PER_SAMPLE["fm_bank"], 1.0)
    sounding = dict(flat_ops, stage=torch.full_like(stopped, 2.0))
    assert cs.hand_ops_per_sample(torch, fk, sounding, B) == (
        cs.FLAT_OPS_PER_SAMPLE["fm_bank"], 1.0)
    moving = ramps.clone()
    moving[fk.INDEX, 1, :32] = 1e-3  # one warp's index glides
    per, share = cs.hand_ops_per_sample(torch, fk, dict(sounding, ramps=moving), B)
    assert share == 7 / 8 and per == (7 * cs.FLAT_OPS_PER_SAMPLE["fm_bank"]
                                      + cs.OPS_PER_SAMPLE["fm_bank"]) / 8


# --------------------------------------------------------------------------
# the cascade's cluster split
# --------------------------------------------------------------------------

PARAMS = [(100.0, 200.0, 100.0, 0.1), (1.0e5, -300.0, 100.0, 0.1),
          (100.0, 96500.0, 100.0, 0.1)]


def _slices(B, C):
    """[(first sample, end)] of each CTA of ``launch_plan(B, cluster=C)``,
    in rank order (empty where the chunks end before the CTAs do)."""
    chunk = kfc.launch_plan(B, cluster=C).chunk
    return [(min(B, r * chunk), min(B, (r + 1) * chunk)) for r in range(C)]


def _split_plain(params, phases, B, f2pi, scale, C):
    """``fm_cascade_plain`` with each stage's scan cut into the cluster's
    slices: each slice's inclusive cumsum, offset by the u32 sum of the
    slices before it, as the kernel's CTAs take it."""
    f2pi, scale = float(np.float32(f2pi)), float(np.float32(scale))
    freq, base, depth, amp = params
    ph = bc.u32_of(phases)
    cuts = _slices(B, C)
    new, mod = [], None
    for k in range(phases.shape[0]):
        f = freq.expand(B) if k == 0 else base + depth * mod
        inc = kfc.inc_i32_sat(f * f2pi)
        phase_t = torch.empty(B, dtype=torch.int64)
        before = 0
        for a, b in cuts:
            if b == a:
                continue
            csum = torch.cumsum(inc[a:b], dim=0)
            phase_t[a:b] = (ph[k] + before + csum - inc[a:b]) & bc._U32_MASK
            before = (before + int(csum[-1])) & bc._U32_MASK
        mod = torch.sin(((phase_t >> 16) & 16383).to(F32) * scale)
        new.append((ph[k] + before) & bc._U32_MASK)
    return mod * amp, bc.i32_of(torch.stack(new))


@pytest.mark.parametrize("C", [2, 16])
@pytest.mark.parametrize("B", [16, 64, 1000, 8192])
def test_cluster_split_scan_is_the_one_scan(B, C):
    N = 16
    f2pi = float(np.float32(2**30 / SR))
    scale = float(np.float32(2 * np.pi / 16384))
    rng = np.random.default_rng(B + C)
    for vals in PARAMS:
        params = torch.tensor(vals, dtype=F32)
        ph = torch.from_numpy(rng.integers(2**32 - 2**26, 2**32, N, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32))
        want_ph = ph.clone()
        want = kfc.fm_cascade_plain(params=params, phases=want_ph, block_size=B, f2pi=f2pi,
                                    scale=scale)
        got, got_ph = _split_plain(params, ph, B, f2pi, scale, C)
        assert torch.equal(_bits(got), _bits(want)) and torch.equal(got_ph, want_ph)
        assert float(want.abs().max()) > 0


@pytest.mark.parametrize("B", [1, 16, 64, 1000, 1024, 1025, 6144, 8192, kfc.MAX_BLOCK])
def test_launch_plan_slices_cover_the_block(B):
    plan = kfc.launch_plan(B)
    assert (plan.cluster == 1) == (B <= kfc.SHARED_SAMPLES)
    assert plan.cluster == 1 or plan.chunk <= kfc.CLUSTER_CHUNK or plan.cluster == 16
    for C in (1, 2, 3, 16):
        if C == 1 and B > kfc.ONE_CTA_MAX:
            with pytest.raises(ValueError, match="one CTA"):
                kfc.launch_plan(B, cluster=1)
            continue
        cuts = _slices(B, C)
        assert len(cuts) == C and cuts[0][0] == 0 and cuts[-1][1] == B
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        p = kfc.launch_plan(B, cluster=C)
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert C == 1 or p.chunk % 32 == 0
    with pytest.raises(ValueError):
        kfc.launch_plan(B, cluster=17)


def test_superblock_cap_is_not_lowered():
    assert kfc.MAX_BLOCK >= PARENT_CAP
    assert ktt.FMCascade(256).superblock_cap >= PARENT_CAP
    assert ktt.FMCascade(16, use_kernel=False).superblock_cap is None
    with pytest.raises(ValueError):
        kfc.launch_plan(kfc.MAX_BLOCK + 1)
