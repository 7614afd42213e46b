"""Port of knaster_tpu/ugens/envelopes.py: ``EnvAsr`` and ``EnvAr`` (reference envelopes.rs).

Envelopes are trigger-driven state machines, so the eventful path runs
sample by sample over the block. In the event-free fast program
(``ctx.no_events``) a machine makes at most one spontaneous transition a
block (attack -> sustain or release -> stopped for ASR; attack -> release
-> stopped for AR), so the block has a closed form over cumulative sums of
the rates; it runs where ``no_events and not wide_batch``, as in the JAX
package. The crossing tests read the last lane (the rates are positive, so
the trajectories are monotone). ``asr_closed_form`` and ``ar_closed_form``
take the prefix sum as an argument (``scan``), because the association
decides a crossing: an envelope whose attack sum reaches 1 on its last
rounding crosses a sample earlier or later in another association. The
default is the Hillis-Steele doubling of ``core/dsp.cumsum``, which
``csrc/chain_kernel.cu`` repeats op for op, so a graph's envelope nodes
render alike through the chain kernel and the scan executor. The voice
models (``models/voices.py``) build their envelopes with
``scan=cumsum_base16``, the association ``jnp.cumsum`` takes on XLA's CPU
backend: the JAX package's vmap bank sums so, and its golden
``detuned_banks`` fixtures record it.

Both envelopes may set done: the frame the release ends.

``Envelope`` is the multi-segment envelope (envelopes.rs:322-528) with the
four shapes of ``EnvelopeShape``, looping, ``time_scale`` and the retrigger
int ``jump_to_segment``; it runs sample by sample, as the JAX package's
scan does, and sets done where a non-looping program ends.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dsp import const, cumsum, shift1
from ..core.ugen import AudioCtx, UGen
from ..primitives.params import ParameterKind, pfloat, pinteger, ptrigger

# EnvAsr stages (envelopes.rs AsrState)
STOPPED, ATTACKING, SUSTAINING, RELEASING = 0, 1, 2, 3
# above any cumulative rate a block can reach: EnvAr's masked lane-min fill
BIG = 3.4e38


def rate_from_time(seconds, sample_rate):
    """1/(t*sr), with t == 0 mapping to rate 1 (instant) — envelopes.rs:88-111."""
    one = const(1.0, seconds)
    return torch.where(seconds == 0, one, one / (seconds * const(sample_rate, seconds)))


def _last(x):
    return x[..., -1]


def asr_closed_form(stage0, t0, rscale, atk_rate, rel_rate, scan=cumsum):
    """EnvAsr's event-free block over ``[..., B]`` rate rows; the state
    ``[...]``; ``scan`` the prefix sum (module docstring). Returns (stage,
    t, release_scale, out [..., B], done [..., B])."""
    one = const(1.0, t0)
    zero = const(0.0, t0)
    s0, t0_, rs = stage0.unsqueeze(-1), t0.unsqueeze(-1), rscale.unsqueeze(-1)
    lane0 = torch.arange(atk_rate.shape[-1], device=t0.device) == 0

    A = scan(atk_rate)
    inc_atk = t0_ + A          # t after step i
    e_atk = t0_ + shift1(A)    # t at step i
    atk_any = _last(inc_atk) >= one
    out_atk = torch.where(e_atk >= one, one, e_atk)
    t_atk = torch.where(atk_any, one, _last(inc_atk))
    stage_atk = torch.where(atk_any, SUSTAINING, ATTACKING)

    R = scan(rel_rate)
    inc_rel = t0_ - R
    e_rel = t0_ - shift1(R)
    alive = lane0 | (e_rel > zero)
    out_rel = torch.where(alive, e_rel * e_rel * e_rel * rs, zero)
    done_rel = alive & (inc_rel <= zero)
    rel_done = _last(inc_rel) <= zero
    t_rel = torch.where(rel_done, zero, _last(inc_rel))
    stage_rel = torch.where(rel_done, STOPPED, RELEASING)

    is_atk, is_sus, is_rel = s0 == ATTACKING, s0 == SUSTAINING, s0 == RELEASING
    out = torch.where(is_atk, out_atk,
                      torch.where(is_sus, one, torch.where(is_rel, out_rel, zero)))
    done = is_rel & done_rel
    t = torch.where(stage0 == ATTACKING, t_atk, torch.where(stage0 == RELEASING, t_rel, t0))
    stage = torch.where(stage0 == ATTACKING, stage_atk,
                        torch.where(stage0 == RELEASING, stage_rel, stage0))
    return stage.to(stage0.dtype), t, rscale, out, done


def ar_closed_form(stage0, t0, rscale, atk_rate, rel_rate, scan=cumsum):
    """EnvAr's event-free block, including the attack -> release -> stopped
    double transition: the release after the crossing step k runs on the
    release-rate cumsum anchored at R[k], found as the masked lane-min of R
    (R rises, so the first crossed lane holds the minimum). Returns (stage,
    t, release_scale, out, done) as ``asr_closed_form``."""
    one = const(1.0, t0)
    zero = const(0.0, t0)
    s0, t0_, rs = stage0.unsqueeze(-1), t0.unsqueeze(-1), rscale.unsqueeze(-1)
    lane0 = torch.arange(atk_rate.shape[-1], device=t0.device) == 0

    A = scan(atk_rate)
    R = scan(rel_rate)
    Rexc = shift1(R)
    R_last = _last(R)

    # starting in ATTACKING
    inc_atk = t0_ + A
    e_atk = t0_ + shift1(A)
    crossed = inc_atk >= one
    in_rel2 = e_atk >= one     # the lanes after the crossing step
    atk_any = _last(crossed)
    Rk = torch.where(crossed, R, const(BIG, R)).amin(dim=-1)
    Rk = torch.where(atk_any, Rk, zero)
    Rk_ = Rk.unsqueeze(-1)
    t_rel2 = one - (Rexc - Rk_)  # the release t at step i after the crossing
    alive2 = t_rel2 > zero
    out_a = torch.where(in_rel2, torch.where(alive2, t_rel2 * t_rel2 * t_rel2, zero),
                        e_atk)
    done_a = in_rel2 & alive2 & ((one - (R - Rk_)) <= zero)
    a_done = atk_any & ((one - (R_last - Rk)) <= zero)
    t_a = torch.where(a_done, zero,
                      torch.where(atk_any, one - (R_last - Rk), _last(inc_atk)))
    stage_a = torch.where(a_done, STOPPED, torch.where(atk_any, RELEASING, ATTACKING))
    rscale_a = torch.where(atk_any, one, rscale)

    # starting in RELEASING (as ASR)
    inc_rel = t0_ - R
    e_rel = t0_ - Rexc
    alive = lane0 | (e_rel > zero)
    out_r = torch.where(alive, e_rel * e_rel * e_rel * rs, zero)
    done_r = alive & (inc_rel <= zero)
    r_done = _last(inc_rel) <= zero
    t_r = torch.where(r_done, zero, _last(inc_rel))
    stage_r = torch.where(r_done, STOPPED, RELEASING)

    is_atk, is_rel = s0 == ATTACKING, s0 == RELEASING
    out = torch.where(is_atk, out_a, torch.where(is_rel, out_r, zero))
    done = (is_atk & done_a) | (is_rel & done_r)
    at, rel = stage0 == ATTACKING, stage0 == RELEASING
    t = torch.where(at, t_a, torch.where(rel, t_r, t0))
    stage = torch.where(at, stage_a, torch.where(rel, stage_r, stage0))
    return stage.to(stage0.dtype), t, torch.where(at, rscale_a, rscale), out, done


class _EnvBase(UGen):
    may_set_done = True
    inputs = 0
    outputs = 1

    def __init__(self, attack_time: float = 0.0, release_time: float = 0.0,
                 scan=cumsum):
        self.pdefaults = {"attack_time": float(attack_time),
                          "release_time": float(release_time)}
        # the closed form's prefix sum (module docstring)
        self.scan = scan

    def batch_key(self):
        return (type(self), self.scan)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {
            "stage": torch.full((), STOPPED, dtype=torch.int32, device=device),
            "t": torch.zeros((), dtype=ctx.dtype, device=device),
            "release_scale": torch.ones((), dtype=ctx.dtype, device=device),
        }

    def rates(self, ctx: AudioCtx, params):
        """The block's attack and release rates and whether it takes the
        closed form: event-free, outside a voice bank (as in the JAX
        package)."""
        atk = rate_from_time(params["attack_time"].to(ctx.dtype), ctx.sample_rate)
        rel = rate_from_time(params["release_time"].to(ctx.dtype), ctx.sample_rate)
        return atk, rel, ctx.no_events and not ctx.wide_batch

    def process(self, ctx: AudioCtx, state, inputs, params):
        atk, rel, closed_form = self.rates(ctx, params)
        stage, t, rscale, out, done = env_block(self._step, self.CLOSED_FORM, state, atk, rel,
                                                params["t_restart"], params.get("t_release"),
                                                closed_form, self.scan)
        return ({"stage": stage, "t": t, "release_scale": rscale}, out.unsqueeze(-2),
                done)


def env_block(step, closed, state, atk, rel, restart, release, closed_form, scan):
    """One block of an envelope in plain torch: ``closed`` (its closed form)
    over the prefix sum ``scan``, or its state machine ``step`` sample by
    sample (``release`` None for EnvAr, which has no release trigger).
    Returns (stage, t, release_scale, out [..., B], done [..., B])."""
    stage, t, rscale = state["stage"], state["t"], state["release_scale"]
    if closed_form:
        return closed(stage, t, rscale, atk, rel, scan=scan)
    params = {"t_restart": restart, "t_release": release}
    outs, dones = [], []
    for i in range(atk.shape[-1]):
        stage, t, rscale, o, d = step(params, i, stage, t, rscale, atk[..., i], rel[..., i])
        outs.append(o)
        dones.append(d)
    return stage, t, rscale, torch.stack(outs, dim=-1), torch.stack(dones, dim=-1)


def asr_block(state, atk, rel, restart, release, closed_form, scan=cumsum):
    """EnvAsr's block in plain torch (``env_block``): the plain version of
    ``kernels/env_asr.py``."""
    return env_block(EnvAsr._step, asr_closed_form, state, atk, rel, restart, release,
                     closed_form, scan)


class EnvAsr(_EnvBase):
    """Attack-Sustain-Release envelope: linear attack, cubic release
    (envelopes.rs:19-163 EnvAsr). Marks done at the frame the release ends."""

    params = (
        pfloat("attack_time", 0.0, kind=ParameterKind.SECONDS),
        pfloat("release_time", 0.0, kind=ParameterKind.SECONDS),
        ptrigger("t_release"),
        ptrigger("t_restart"),
    )
    CLOSED_FORM = staticmethod(asr_closed_form)

    def process(self, ctx: AudioCtx, state, inputs, params):
        # one launch of csrc/env_asr.cu on the card, its plain torch
        # version (``asr_block``) on the CPU
        from ..kernels.env_asr import env_asr

        atk, rel, closed_form = self.rates(ctx, params)
        stage, t, rscale, out, done = env_asr(state, atk, rel, params["t_restart"],
                                              params["t_release"], closed_form, self.scan)
        return ({"stage": stage, "t": t, "release_scale": rscale}, out.unsqueeze(-2),
                done)

    @staticmethod
    def _step(params, i, stage, t, rscale, atk, rel):
        """One sample of the state machine (envelopes.rs:52-80); the
        triggers apply before the sample, as param_apply does."""
        one, zero = const(1.0, t), const(0.0, t)
        stage = torch.where(params["t_restart"][..., i], ATTACKING, stage)
        release = params["t_release"][..., i]
        rel_from_atk = release & (stage == ATTACKING)
        rel_from_sus = release & (stage == SUSTAINING)
        rscale = torch.where(rel_from_atk, t, torch.where(rel_from_sus, one, rscale))
        t = torch.where(rel_from_atk | rel_from_sus, one, t)
        stage = torch.where(rel_from_atk | rel_from_sus, RELEASING, stage)
        out = torch.where(stage == ATTACKING, t,
                          torch.where(stage == SUSTAINING, one,
                                      torch.where(stage == RELEASING, t * t * t * rscale,
                                                  zero)))
        t_next = torch.where(stage == ATTACKING, t + atk,
                             torch.where(stage == RELEASING, t - rel, t))
        to_sustain = (stage == ATTACKING) & (t_next >= one)
        # pin t to exactly 1 in sustain, as the closed form does
        t_next = torch.where(to_sustain, one, t_next)
        done = (stage == RELEASING) & (t_next <= zero)
        stage = torch.where(to_sustain, SUSTAINING, stage)
        stage = torch.where(done, STOPPED, stage).to(torch.int32)
        t_next = torch.where(done, zero, t_next)
        return stage, t_next, rscale, out, done

    def kernel_stage(self, ctx: AudioCtx):
        from ..kernels.chain_kernel import BODIES

        # the kernel sums in the default association only
        return (BODIES["env_asr"], 0) if self.scan is cumsum else None


class EnvAr(_EnvBase):
    """Attack-Release one-shot envelope (envelopes.rs:174-315 EnvAr)."""

    params = (
        pfloat("attack_time", 0.0, kind=ParameterKind.SECONDS),
        pfloat("release_time", 0.0, kind=ParameterKind.SECONDS),
        ptrigger("t_restart"),
    )
    CLOSED_FORM = staticmethod(ar_closed_form)

    @staticmethod
    def _step(params, i, stage, t, rscale, atk, rel):
        one, zero = const(1.0, t), const(0.0, t)
        stage = torch.where(params["t_restart"][..., i], ATTACKING, stage)
        out = torch.where(stage == ATTACKING, t,
                          torch.where(stage == RELEASING, t * t * t * rscale, zero))
        t_next = torch.where(stage == ATTACKING, t + atk,
                             torch.where(stage == RELEASING, t - rel, t))
        to_rel = (stage == ATTACKING) & (t_next >= one)
        rscale = torch.where(to_rel, one, rscale)
        stage = torch.where(to_rel, RELEASING, stage)
        t_next = torch.where(to_rel, one, t_next)
        done = (stage == RELEASING) & ~to_rel & (t_next <= zero)
        stage = torch.where(done, STOPPED, stage).to(torch.int32)
        t_next = torch.where(done, zero, t_next)
        return stage, t_next, rscale, out, done

    def kernel_stage(self, ctx: AudioCtx):
        from ..kernels.chain_kernel import BODIES

        # the kernel sums in the default association only
        return (BODIES["env_ar"], 0) if self.scan is cumsum else None


class EnvelopeShape:
    """Per-segment interpolation shape (envelopes.rs:339-348 EnvelopeShape).
    The reference declares the enum and evaluates every segment linearly;
    the JAX package implements all four, and so does the port:

    * LINEAR      — a straight line from the previous value to the target;
    * EXPONENTIAL — the geometric curve ``from·(to/from)^frac``, linear when
      the endpoints differ in sign or either is 0;
    * SINUSOIDAL  — a raised-cosine ease-in/out;
    * STEP        — the target from the segment's first sample.
    """

    LINEAR = 0
    EXPONENTIAL = 1
    SINUSOIDAL = 2
    STEP = 3

    _NAMES = {"linear": LINEAR, "exponential": EXPONENTIAL,
              "sinusoidal": SINUSOIDAL, "step": STEP}

    @classmethod
    def code(cls, shape) -> int:
        if isinstance(shape, str):
            return cls._NAMES[shape.lower()]
        return int(shape)


class EnvelopeSegment:
    """(duration seconds, target value, shape) — envelopes.rs EnvelopeSegment."""

    def __init__(self, duration: float, value: float, shape=EnvelopeShape.LINEAR):
        self.duration = float(duration)
        self.value = float(value)
        self.shape = EnvelopeShape.code(shape)


def _segment_value(shape, from_v, to_v, frac):
    """One segment at normalized position ``frac`` (clipped to [0, 1]), the
    shape selected per element from the shape codes ``shape``."""
    frac = frac.clamp(0.0, 1.0)
    lin = from_v + frac * (to_v - from_v)
    sinu = from_v + (to_v - from_v) * (1.0 - torch.cos(math.pi * frac)) * 0.5
    same_sign = from_v * to_v > 0
    tiny = const(1e-12, from_v)
    fa = torch.maximum(from_v.abs(), tiny)
    ta = torch.maximum(to_v.abs(), tiny)
    geo = torch.sign(from_v) * fa * (ta / fa) ** frac
    expo = torch.where(same_sign, geo, lin)
    return torch.where(
        shape == EnvelopeShape.LINEAR, lin,
        torch.where(shape == EnvelopeShape.EXPONENTIAL, expo,
                    torch.where(shape == EnvelopeShape.SINUSOIDAL, sinu, to_v)))


class Envelope(UGen):
    """Multi-segment envelope with per-segment shapes, looping and time
    scaling (envelopes.rs:322-528 Envelope). Params: time_scale,
    jump_to_segment, t_restart, t_stop.

    ``jump_to_segment`` is a retrigger int: every set re-jumps, even to the
    current segment. The graph passes its per-sample set mask as
    ``jump_to_segment_set``; without it (a host that has none) a change of
    value counts as a set."""

    may_set_done = True
    inputs = 0
    outputs = 1
    params = (
        # hint parity: envelopes.rs:469 (logarithmic, 0..=20)
        pfloat("time_scale", 1.0, range=(0.0, 20.0), logarithmic=True),
        pinteger("jump_to_segment", 0, retrigger=True),
        ptrigger("t_restart"),
        ptrigger("t_stop"),
    )

    def __init__(self, start_value: float, segments, looping: bool = False,
                 time_scale: float = 1.0):
        self.start_value = float(start_value)
        self.segments = [s if isinstance(s, EnvelopeSegment) else EnvelopeSegment(*s)
                         for s in segments]
        if not self.segments:
            raise ValueError("Envelope needs at least one segment")
        self.looping = bool(looping)
        self.pdefaults = {"time_scale": float(time_scale)}

    def segment_table(self, dtype=np.float32):
        """[S, 3] (recip, duration, value) and the [S] shape codes."""
        segs = np.asarray([[1.0 / s.duration, s.duration, s.value]
                           for s in self.segments], dtype)
        return segs, np.asarray([s.shape for s in self.segments], np.int64)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {
            "running": torch.zeros((), dtype=torch.bool, device=device),
            "seg": torch.zeros((), dtype=torch.int32, device=device),
            "time": torch.zeros((), dtype=ctx.dtype, device=device),
            "from_value": torch.full((), self.start_value, dtype=ctx.dtype, device=device),
            # the last jump_to_segment value: the set detection without a mask
            "last_jump": torch.zeros((), dtype=torch.int32, device=device),
        }

    def process(self, ctx: AudioCtx, state, inputs, params):
        dtype = ctx.dtype
        device = state["time"].device
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        segs_np, shapes_np = self.segment_table(np_dtype)
        segs = torch.from_numpy(segs_np).to(device)
        shapes = torch.from_numpy(shapes_np).to(device)
        n_seg = segs.shape[0]
        base_scale = torch.tensor(np_dtype(1.0 / ctx.sample_rate), device=device)
        start = const(self.start_value, state["time"])
        zero = const(0.0, state["time"])
        jump_set = params.get("jump_to_segment_set")
        running, seg_i, t = state["running"], state["seg"], state["time"]
        from_v, last_jump = state["from_value"], state["last_jump"]
        outs, dones = [], []
        for i in range(ctx.block_size):
            jump_in = params["jump_to_segment"][..., i]
            jump = jump_in.clamp(0, n_seg - 1)
            do_jump = jump_in != last_jump if jump_set is None else jump_set[..., i]
            last_jump = jump_in
            seg_i = torch.where(do_jump, jump, seg_i)
            t = torch.where(do_jump, zero, t)
            running = running | do_jump
            restart = params["t_restart"][..., i]
            seg_i = torch.where(restart, 0, seg_i).to(torch.int32)
            t = torch.where(restart, zero, t)
            from_v = torch.where(restart, start, from_v)
            running = running | restart
            # t_stop freezes at the current value
            idx = seg_i.long()
            recip, dur, val = segs[idx, 0], segs[idx, 1], segs[idx, 2]
            shape = shapes[idx]
            cur = _segment_value(shape, from_v, val, t * recip)
            stop = params["t_stop"][..., i]
            from_v = torch.where(stop & running, cur, from_v)
            running = running & ~stop
            # the sample (envelopes.rs Envelope::process); a stop leaves the
            # output at from_v, so cur is the running value
            dt = params["time_scale"][..., i] * base_scale
            in_seg = t < dur
            has_next = seg_i + 1 < n_seg
            outs.append(torch.where(running, torch.where(in_seg, cur, val), from_v))
            adv = running & ~in_seg & has_next
            fin = running & ~in_seg & ~has_next
            from_v = torch.where(adv | fin, val, from_v)
            t = torch.where(running & in_seg, t + dt, torch.where(adv, t - dur + dt, t))
            seg_i = torch.where(adv, seg_i + 1, seg_i)
            if self.looping:
                seg_i = torch.where(fin, 0, seg_i)
                t = torch.where(fin, zero, t)
                dones.append(torch.zeros_like(fin))
            else:
                running = running & ~fin
                dones.append(fin)
            seg_i = seg_i.to(torch.int32)
        new_state = {"running": running, "seg": seg_i, "time": t, "from_value": from_v,
                     "last_jump": last_jump.to(torch.int32)}
        out = torch.stack(outs, dim=-1)
        return new_state, out.unsqueeze(-2), torch.stack(dones, dim=-1)
