"""Pieces every fused voice-bank kernel shares: operand checks and plain torch helpers.

The plain helpers are the torch counterparts of the in-kernel helpers of
``knaster_tpu/parallel/pallas_bank.py`` (and of ``csrc/bank_common.cuh`` on
the card), op for op, over ``[V]`` tensors: ``_mat`` (anchored ramp plus
breakpoint rounds), ``_trig_bit`` (packed trigger words), ``_to_inc``
(saturating u32 phase increment), ``_sin_poly``/``_sin_quant`` (the
table-quantized sine), ``_theta_full`` (the full-resolution phase angle),
``_env_asr`` and ``_env_ar`` (the envelope state machines; a ``None``
trigger is the event-free variant, the JAX package's ``_env_asr_free`` and
``_env_ar_free``), ``_pan_gains``, ``_svf_low_coeffs``,
``_make_env_multiseg`` (the multi-segment Envelope fold), ``_exp_poly``
(exp by a base-2 range reduction and a degree-5 fit) and
``_sincos_halfturn``.

u32 phases are carried by the plain versions as int64 in [0, 2^32) (torch
has no uint32 arithmetic) and stored in bank state as their int32 bit
pattern (``u32_of`` / ``i32_of`` convert).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ugens.wavetable import FRACTIONAL_PART, TABLE_HIGH_MASK, TABLE_SIZE

N_GROUP = 5  # floats per ramp group / breakpoint group
# largest block the banks take (the JAX package's cap, kept for parity)
MAX_BLOCK = 1024

U32 = 2**32
_U32_MASK = U32 - 1
_CYCLE = int(TABLE_SIZE) * int(FRACTIONAL_PART)  # 2**30 phase units / cycle
_U2RAD = np.float32(2.0 * np.pi / _CYCLE)
_IDX_SCALE = np.float32(2.0 * np.pi / TABLE_SIZE)
_HALF_PI = np.float32(np.pi / 2.0)
# degree-9 odd polynomial for sin(u) on [0, pi/2]: max error 1.2e-7
_SIN_C = (np.float32(1.0), np.float32(-0.16666652), np.float32(0.008332964),
          np.float32(-0.00019804752), np.float32(2.5981028e-06))
_TO_INC_MAX = 2.0**31 - 128  # largest f32 below 2^31: the int32 cast is exact


# --------------------------------------------------------------------------
# operand checks and the launch plumbing
# --------------------------------------------------------------------------

def check(kernel, name, x, dtype, shape, device):
    """Raise ValueError unless ``x`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device`` (TypeError if it is no tensor)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{kernel}: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def validate_block(kernel, n_float, n_trig, state, ramps, rounds, act, words,
                   block_size, act_always=False):
    """Check a bank kernel's operands against the layout it reads.

    ``state`` is ``[(name, tensor, dtype)]`` of ``[V]`` tensors, V taken
    from the first. ``ramps`` is f32 ``[n_float, 5, V]``; an eventful block
    adds ``rounds`` f32 ``[n_float, 5, D, V]`` and ``words`` int32
    ``[n_trig, ceil(B/32), V]``. ``act`` f32 ``[V]`` comes with them, or in
    every block when ``act_always``. Returns (V, B, D), D = 0 event-free."""
    first = state[0][1]
    V = first.shape[0] if isinstance(first, torch.Tensor) and first.dim() == 1 else -1
    B = int(block_size)
    if V < 1:
        raise ValueError(f"{kernel}: {state[0][0]} must be a non-empty [V] tensor")
    if not 1 <= B <= MAX_BLOCK:
        raise ValueError(
            f"{kernel}: block_size must be in [1, {MAX_BLOCK}], got {B}")
    dev = first.device
    for name, x, dtype in state:
        check(kernel, name, x, dtype, (V,), dev)
    check(kernel, "ramps", ramps, torch.float32, (n_float, N_GROUP, V), dev)
    eventful = rounds is not None
    if eventful != (words is not None) or (
            not act_always and eventful != (act is not None)):
        raise ValueError(
            f"{kernel}: rounds, words{'' if act_always else ' and act'} are "
            "given together (eventful block) or not at all (event-free block)")
    if act_always or eventful:
        check(kernel, "act", act, torch.float32, (V,), dev)
    if not eventful:
        return V, B, 0
    D = rounds.shape[2] if rounds.dim() == 4 else 0
    if D < 1:
        raise ValueError(
            f"{kernel}: rounds must be [{n_float}, 5, D, V] with D >= 1")
    check(kernel, "rounds", rounds, torch.float32, (n_float, N_GROUP, D, V), dev)
    check(kernel, "words", words, torch.int32, (n_trig, (B + 31) // 32, V), dev)
    return V, B, D


def require_cuda(kernel, device):
    if device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {device}")


def ptr(x):
    """A tensor's device pointer for ctypes (NULL for None)."""
    return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


def raise_on_error(kernel, lib, err):
    if err != 0:
        raise RuntimeError(
            f"{kernel}: kernel launch failed with CUDA error {err} "
            f"({lib.ktt_error_string(err).decode()})")


def empty_partial(V, n_out, B, device):
    """The warp-partial mix buffer the hand FM kernel writes:
    [ceil(V/32), n_out, B]."""
    return torch.empty(((V + 31) // 32, n_out, int(B)), dtype=torch.float32,
                       device=device)


# The mix of the sine, subtractive, generic and wavetable kernels
# (csrc/bank_common.cuh): one
# partial row per CTA of MIX_THREADS voices (event-free blocks sum them in
# shared memory; eventful blocks write a row per warp first, MIX_WARPS a
# CTA, and sum those), the rows summed in the kernel by the last CTA of each
# group of MIX_GROUP, then the group rows by the last group, each group and
# the groups counted by a ticket word.
MIX_THREADS = 256
MIX_WARPS = MIX_THREADS // 32
MIX_GROUP = 32


def mix_rows(V):
    """(CTA rows, group rows) of a V-voice bank's mix."""
    n_cta = -(-V // MIX_THREADS)
    return n_cta, -(-n_cta // MIX_GROUP)


def mix_scratch_rows(V):
    """Rows of the mix scratch: the CTA rows, the group rows, the warp rows."""
    n_cta, n_groups = mix_rows(V)
    return n_cta + n_groups + MIX_WARPS * n_cta


def empty_mix(V, n_out, B, device):
    """(mix [n_out, B], scratch [mix_scratch_rows(V), n_out, B]): what a
    sine, subtractive, generic or wavetable kernel writes."""
    return (torch.empty((n_out, int(B)), dtype=torch.float32, device=device),
            torch.empty((mix_scratch_rows(V), n_out, int(B)), dtype=torch.float32,
                        device=device))


_TICKETS = {}  # (device, stream) -> int32 words, zero between launches


def mix_tickets(V, device, stream):
    """The ticket words of the launches on ``stream``: 1 + group rows of
    them, zero before a launch and reset to zero by it. Launches on one
    stream run one after another and share them."""
    n = 1 + mix_rows(V)[1]
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return buf


# the harmonic counts the additive partials are instantiated for on the card
# (csrc/bank_common.cuh Harmonics<HMAX>), their table a kernel parameter; a
# table of more harmonics takes the run-time variant (RUNTIME_H), which reads
# it from device memory (additive_partials_rt)
HARMONIC_SLOTS = (8, 16, 32, 64)
RUNTIME_H = 0


def harmonic_slots(H):
    """The instantiation a table of H >= 1 harmonics takes: the smallest of
    ``HARMONIC_SLOTS`` that holds it, or ``RUNTIME_H`` past the largest (a
    dispatch by size: both variants compute the same partials)."""
    if H < 1:
        raise ValueError(f"a harmonic table needs H >= 1, got {H}")
    for hmax in HARMONIC_SLOTS:
        if H <= hmax:
            return hmax
    return RUNTIME_H


def padded_harmonics(coefs, hmax):
    """f32 [3, hmax]: the [3, H] A / B / threshold table with the harmonics
    from H on as padding that contributes nothing (A = B = 0, thr = -inf,
    which no frequency is at or below)."""
    coefs = np.asarray(coefs, np.float32)
    H = coefs.shape[1]
    out = np.zeros((3, hmax), np.float32)
    out[:, :H] = coefs
    out[2, H:] = -np.inf
    return out


def scalar(x, device):
    """A host float rounded to f32, as a 0-d tensor on ``device``."""
    return torch.tensor(np.float32(x), device=device)


def u32_of(x):
    """int32 bit pattern -> int64 in [0, 2^32)."""
    return x.long() & _U32_MASK


def i32_of(x):
    """int64 in [0, 2^32) -> its int32 bit pattern."""
    return torch.where(x >= 2**31, x - U32, x).to(torch.int32)


def u32_add(a, b):
    return (a + b) & _U32_MASK


# --------------------------------------------------------------------------
# plain torch helpers: the same arithmetic, op for op, over [V] per sample
# --------------------------------------------------------------------------

def ramp_flat_over_block(g, B):
    """bool [V]: where ``_mat`` of the ramp group ``g`` [5, V] gives one bit
    pattern at every sample of an event-free block of B samples (the rule
    the generic kernel hoists its pan gains by, csrc/bank_common.cuh
    ramp_flat). Either the ramp has ended (``el >= dur``: every progress
    ``i + el`` is at or past dur, so tgt), or its step is zero and it does
    not end inside the block (``el + (B-1) < dur``) where ``v0 +
    step*prog`` keeps one sign of zero: prog never negative (``el >= 0``)
    or v0 not zero. The value is ``_mat`` at sample 0, never v0 itself."""
    v0, step, el, dur = g[0], g[1], g[2], g[3]
    last = el + np.float32(B - 1)
    return (el >= dur) | ((step == 0) & (last < dur) & ((el >= 0) | (v0 != 0)))


def pack_flat_over_block(pack, B):
    """bool [V]: where the event-free pan pack ``pack`` [5, V] (a0, da, lt,
    rt, rem) gives one pair of ``_pan_gains`` at every sample of a block of
    B samples (the rule the sine kernel hoists its pan gains by,
    csrc/bank_common.cuh pack_flat): the ramp has ended (``rem <= 0``: every
    sample takes the target's gains), or the angle's step is zero and the
    ramp does not end inside the block (``rem > B - 1``), where ``a0 +
    da*i`` is a0 at every sample (a0 is never -0.0). The value is
    ``_pan_gains`` at sample 0."""
    da, rem = pack[1], pack[4]
    return (rem <= 0) | ((da == 0) & (rem > np.float32(B - 1)))


def env_asr_steady(stage):
    """bool [V]: where event-free ``_env_asr`` leaves (stage, t, rscale) as
    they are at every sample and gives one value, 0 or 1: stage 0 (stopped)
    or 2 (sustain) at block entry (csrc/bank_common.cuh env_asr_steady)."""
    return (stage == 0) | (stage == 2)


def pan_pack(g):
    """The event-free pan pack [5, V] (a0, da, lt, rt, rem) from the raw pan
    ramp group ``g`` [5, V] (v0, step, el, dur, tgt, el and dur in f32): the
    operations of the JAX package's ``pallas_bank._pan_fast_operands`` in
    its order, as the wavetable bank stages it on the host and the sine
    kernel's prologue builds it (csrc/bank_common.cuh pan_pack); rem is
    ``dur - el`` in f32, the integer difference rounded wherever |el|,
    |dur| <= 2^24."""
    v0, step, el, dur, tgt = g
    start = torch.where(el >= dur, tgt, v0 + step * el)
    a0 = (start * 0.5 + 0.5) * _HALF_PI
    da = step * np.float32(np.pi / 4.0)
    at = (tgt * 0.5 + 0.5) * _HALF_PI
    return torch.stack([a0, da, torch.cos(at), torch.sin(at), dur - el])


def fold_act(g, act):
    """Fold the 0/1 active gain into the amp ramp group ``g`` [5, V] in
    place, three launches: (v0, step, tgt) times act, never el/dur, so
    ``_mat`` of it is ``amp * act`` bit for bit (the JAX package's
    ``pallas_bank._fold_act``; the FM and wavetable banks stage it on the
    host, the sine and subtractive kernels in their prologue)."""
    for j in (0, 1, 4):
        g[j].mul_(act)


def _mat(i_f, g, rg=None):
    """The float param at sample ``i_f`` from its ramp group ``g`` [5, V]
    (v0, step, el, dur, tgt) and, when eventful, its breakpoints ``rg``
    [5, D, V] (v0, step, dur, tgt, frame): each round's piece wins from its
    frame on (untouched rounds carry ``frame = B``)."""
    prog = i_f + g[2]
    acc = torch.where(prog >= g[3], g[4], g[0] + g[1] * prog)
    if rg is not None:
        for r in range(rg.shape[1]):
            ln = i_f - rg[4, r]
            v = torch.where(ln >= rg[2, r], rg[3, r], rg[0, r] + rg[1, r] * ln)
            acc = torch.where(i_f >= rg[4, r], v, acc)
    return acc


def _trig_bit(i, words):
    """Sample i's trigger bit from [W, V] int32 words (word w holds frames
    [32w, 32w+32)); the shift runs on the int64 value of the u32 word."""
    word = words[i >> 5].long() & _U32_MASK
    return ((word >> (i & 31)) & 1) == 1


def _to_inc(x):
    """freq*f2pi -> u32 phase increment with Rust ``as u32`` saturation:
    clamp to [0, 2^31 - 128], truncate to int32 (non-negative, so the u32
    bits equal the value)."""
    return x.clamp(0.0, _TO_INC_MAX).to(torch.int32).long()


def _sin_poly(u):
    u2 = u * u
    p = _SIN_C[4] * u2 + _SIN_C[3]
    p = p * u2 + _SIN_C[2]
    p = p * u2 + _SIN_C[1]
    return (p * u2 + _SIN_C[0]) * u


def _sin_quant(phase):
    """SinWt's table-quantized sine of an int64 phase in [0, 2^32): the
    16384-grid index folded to the first quadrant by integer identities
    and evaluated with the degree-9 odd polynomial."""
    idx = (phase >> 16) & TABLE_HIGH_MASK
    half = idx & (TABLE_SIZE // 2 - 1)
    neg = idx >= TABLE_SIZE // 2
    m = torch.where(half > TABLE_SIZE // 4, TABLE_SIZE // 2 - half, half)
    p = _sin_poly(m.to(torch.float32) * _IDX_SCALE)
    return torch.where(neg, -p, p)


def _theta_full(phase):
    """AdditiveVoice's full-resolution phase angle (mod one cycle) of an
    int64 phase in [0, 2^32)."""
    return (phase & (_CYCLE - 1)).to(torch.float32) * _U2RAD


def _env_asr(stage, t, rscale, restart, release, atk, rel):
    """EnvAsr state machine (stages: 0 stop, 1 atk, 2 sus, 3 rel).
    ``restart``/``release`` None is the event-free variant. Returns
    (env, stage', t', rscale')."""
    one = torch.ones((), dtype=t.dtype, device=t.device)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    if restart is not None:
        stage = torch.where(restart, one, stage)
        rel_from_atk = release & (stage == 1.0)
        rel_from_sus = release & (stage == 2.0)
        rscale = torch.where(rel_from_atk, t,
                             torch.where(rel_from_sus, one, rscale))
        t = torch.where(rel_from_atk | rel_from_sus, one, t)
        stage = torch.where(rel_from_atk | rel_from_sus, 3.0 * one, stage)
    env = torch.where(
        stage == 1.0, t,
        torch.where(stage == 2.0, one,
                    torch.where(stage == 3.0, t * t * t * rscale, zero)),
    )
    t_next = torch.where(stage == 1.0, t + atk,
                         torch.where(stage == 3.0, t - rel, t))
    to_sus = (stage == 1.0) & (t_next >= 1.0)
    t_next = torch.where(to_sus, one, t_next)  # pin sustain t
    done = (stage == 3.0) & (t_next <= 0.0)
    stage = torch.where(to_sus, 2.0 * one, stage)
    stage = torch.where(done, zero, stage)
    t_next = torch.where(done, zero, t_next)
    return env, stage, t_next, rscale


def _env_ar(stage, t, restart, atk, rel):
    """EnvAr state machine (stages: 0 stopped, 1 attack, 2 release); no
    sustain, so a voice falls silent ``release`` after its attack ends.
    ``restart`` None is the event-free variant. Returns (env, stage', t')."""
    one = torch.ones((), dtype=t.dtype, device=t.device)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    if restart is not None:
        stage = torch.where(restart, one, stage)
    env = torch.where(stage == 1.0, t,
                      torch.where(stage == 2.0, t * t * t, zero))
    t_next = torch.where(stage == 1.0, t + atk,
                         torch.where(stage == 2.0, t - rel, t))
    to_rel = (stage == 1.0) & (t_next >= 1.0)
    stage = torch.where(to_rel, 2.0 * one, stage)
    t_next = torch.where(to_rel, one, t_next)
    done = (stage == 2.0) & ~to_rel & (t_next <= 0.0)
    stage = torch.where(done, zero, stage)
    t_next = torch.where(done, zero, t_next)
    return env, stage, t_next


def _pan_gains(i_f, g, rg=None):
    """Per-sample equal-power pan gains. Eventful (``rg`` given): cos/sin
    of the materialized pan's angle, like Pan2. Event-free: ``g`` is the
    linear-angle pack (a0, da, lt, rt, rem); polynomial cos/sin of the
    angle until the ramp ends, the exact target gains after."""
    if rg is not None:
        angle = (_mat(i_f, g, rg) * np.float32(0.5) + np.float32(0.5)) * _HALF_PI
        return torch.cos(angle), torch.sin(angle)
    angle = g[0] + g[1] * i_f
    ended = i_f >= g[4]
    panl = torch.where(ended, g[2], _sin_poly(_HALF_PI - angle))
    panr = torch.where(ended, g[3], _sin_poly(angle))
    return panl, panr


def _svf_low_coeffs(x, q):
    """SVF lowpass coefficients (svf.rs set_coeffs, Low type) in the
    one-divide form: with s = sin(x), c = cos(x) (x = pi*cutoff/sr in
    [0, pi/2)), a1 = q*c^2/(q+s*c), a2 = q*s*c/(q+s*c), a3 = q*s^2/(q+s*c),
    algebraically the tan form 1/(1+g(g+1/q))."""
    s = _sin_poly(x)
    c = _sin_poly(_HALF_PI - x)
    sc = s * c
    d = q / (q + sc)
    return d * (c * c), d * sc, d * (s * s)


ENV_SEG_FINISHED = -1.0  # a non-looping program ran out: the idle latch
ENV_SEG_STOPPED = -2.0   # t_stop froze the value: still audible, NOT idle

# ugens/envelopes.py EnvelopeShape codes (kept here so that the helpers do
# not import the UGen layer)
_LINEAR, _EXPONENTIAL, _SINUSOIDAL, _STEP = 0, 1, 2, 3
_PI_F32 = np.float32(np.pi)


def env_shape_eval(shape, from_v, val, frac):
    """``_segment_value``'s formula for one shape code over the selected
    segment constants (``val`` is the segment's target)."""
    one, half = np.float32(1.0), np.float32(0.5)
    if shape == _LINEAR:
        return from_v + frac * (val - from_v)
    if shape == _SINUSOIDAL:
        return from_v + (val - from_v) * (one - torch.cos(_PI_F32 * frac)) * half
    if shape == _STEP:
        return val
    # EXPONENTIAL: same-sign geometric, linear across zero; exp(frac*log())
    # is the pow identity
    lin = from_v + frac * (val - from_v)
    tiny = np.float32(1e-12)
    fa = torch.clamp(torch.abs(from_v), min=tiny)
    ta = torch.clamp(torch.abs(val), min=tiny)
    geo = torch.sign(from_v) * fa * torch.exp(frac * torch.log(ta / fa))
    return torch.where(from_v * val > 0, geo, lin)


def env_segment_index(seg, S):
    """int64 [V]: the segment the kernel reads for each ``seg`` (the
    Envelope body's index select, csrc/bank_common.cuh EnvProgram.index):
    seg itself where it is one of 1 ... S-1, else 0 (segment 0 and the
    negative finished / stopped codes), the segment the select loop of
    ``_make_env_multiseg`` picks."""
    idx = seg.to(torch.int64)
    ok = (idx.to(seg.dtype) == seg) & (idx >= 1) & (idx < S)
    return torch.where(ok, idx, torch.zeros_like(idx))


def env_present_shapes(shapes):
    """The distinct shape codes of a segment table, in first-segment order."""
    present = []
    for sh in shapes:
        if sh not in present:
            present.append(int(sh))
    return present


def _make_env_multiseg(segments, looping, start_value, shapes=None):
    """The multi-segment Envelope evaluated per sample over ``[V]`` tensors
    (``pallas_bank._make_env_multiseg``): ``segments`` is the [S, 3]
    (recip, duration, value) table and ``shapes`` the per-segment shape
    codes, both constants. The segment constants are selected first (a fold
    over S), then each distinct shape present is evaluated once over them.
    The running flag lives in ``seg`` as the sentinels ``ENV_SEG_FINISHED``
    and ``ENV_SEG_STOPPED``.

    Returns ``step(seg, t, from_v, dt, restart, stop) -> (out, seg', t',
    from_v', fin)``; ``restart``/``stop`` None is the event-free variant.
    ``fin`` is the envelope-finished bit: a stopped voice keeps emitting its
    frozen value and is not finished."""
    segs = np.asarray(segments, np.float32)
    S = segs.shape[0]
    shapes = [_LINEAR] * S if shapes is None else [int(s) for s in shapes]
    present = env_present_shapes(shapes)
    one, zero = np.float32(1.0), np.float32(0.0)
    start_v = np.float32(start_value)
    fin_s, stop_s = np.float32(ENV_SEG_FINISHED), np.float32(ENV_SEG_STOPPED)

    def step(seg, t, from_v, dt, restart, stop):
        if restart is not None:
            seg = torch.where(restart, zero, seg)
            t = torch.where(restart, zero, t)
            from_v = torch.where(restart, start_v, from_v)
        masks = [seg == np.float32(s) for s in range(S)]
        recip = torch.full_like(from_v, segs[0, 0])
        dur = torch.full_like(from_v, segs[0, 1])
        val = torch.full_like(from_v, segs[0, 2])
        for s in range(1, S):
            recip = torch.where(masks[s], segs[s, 0], recip)
            dur = torch.where(masks[s], segs[s, 1], dur)
            val = torch.where(masks[s], segs[s, 2], val)
        frac = torch.clamp(t * recip, 0.0, 1.0)
        cur = env_shape_eval(present[0], from_v, val, frac)
        for sh in present[1:]:
            m_sh = None
            for s in range(S):
                if shapes[s] == sh:
                    m_sh = masks[s] if m_sh is None else (m_sh | masks[s])
            cur = torch.where(m_sh, env_shape_eval(sh, from_v, val, frac), cur)
        if stop is not None:
            frozen = stop & (seg >= zero)
            from_v = torch.where(frozen, cur, from_v)
            seg = torch.where(frozen, stop_s, seg)
        is_run = seg >= zero
        in_seg = t < dur
        has_next = seg + one < np.float32(S)
        out = torch.where(is_run, torch.where(in_seg, cur, val), from_v)
        adv = is_run & ~in_seg & has_next
        fin = is_run & ~in_seg & ~has_next
        from_v = torch.where(adv | fin, val, from_v)
        t = torch.where(is_run & in_seg, t + dt, torch.where(adv, t - dur + dt, t))
        seg = torch.where(adv, seg + one, seg)
        if looping:
            seg = torch.where(fin, zero, seg)
            t = torch.where(fin, zero, t)
            fin = torch.zeros_like(fin)
        else:
            seg = torch.where(fin, fin_s, seg)
        return out, seg, t, from_v, fin

    return step


# degree-5 fit of 2^f on [-0.5, 0.5] (rel err <= 1.8e-7): the mantissa half
# of the range-reduced polynomial exp
_EXP2_C = (np.float32(0.0013400433), np.float32(0.009676037),
           np.float32(0.05550327), np.float32(0.24022107),
           np.float32(0.6931472), np.float32(1.0000001))
_LOG2E = np.float32(1.4426950408889634)


def _exp_poly(x):
    """exp(x) for x <= 0: x*log2(e) = n + f with n = round(.) half to even
    (f in [-0.5, 0.5]), 2^n built in the exponent field with n clamped to
    [-126, 0] (the result underflows to ~0 where exp does), 2^f by the
    degree-5 polynomial."""
    z = torch.clamp(x * _LOG2E, min=np.float32(-126.0))
    n = torch.round(z)
    f = z - n
    p = torch.full_like(f, _EXP2_C[0])
    for c in _EXP2_C[1:]:
        p = p * f + c
    n_i = n.clamp(-126.0, 0.0).to(torch.int32)
    pow2n = ((n_i + 127) << 23).view(torch.float32)
    return pow2n * p


def _sincos_halfturn(theta):
    """(sin, cos) of theta in [0, pi] by the odd polynomial: sin folded
    about pi/2 (sin(pi - t) = sin t), cos as sin(pi/2 - t)."""
    s = _sin_poly(torch.minimum(theta, _PI_F32 - theta))
    c = _sin_poly(_HALF_PI - theta)
    return s, c


def _blep_one_divide(t, dt):
    """``_blep`` with one divide, as the subtractive kernel takes it
    (csrc/bank_common.cuh blep_warp): the quotient ``_blep`` reads is ``x =
    (t < dt ? t : t - 1) / safe_dt``, and ``x - 1``, ``x + 1`` round as its
    two expressions do."""
    one = np.float32(1.0)
    lo = t < dt
    x = torch.where(lo, t, t - one) / torch.clamp(dt, min=np.float32(1e-9))
    a, b = x - one, x + one
    return torch.where(lo, -(a * a),
                       torch.where(t > one - dt, b * b, torch.zeros_like(t)))


def _blep(t, dt):
    """polyBLEP residual of the saw (polyblep.rs), ``dt`` clamped away from
    zero for the two divides."""
    one = np.float32(1.0)
    safe_dt = torch.clamp(dt, min=np.float32(1e-9))
    a = t / safe_dt - one
    b = (t - one) / safe_dt + one
    return torch.where(t < dt, -(a * a),
                       torch.where(t > one - dt, b * b, torch.zeros_like(t)))
