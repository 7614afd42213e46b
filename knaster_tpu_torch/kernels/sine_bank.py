"""The fused sine-bank kernel: wrapper, plain torch version and launch count.

Replaces ``knaster_tpu/parallel/pallas_bank.py::_sine_kernel`` (the Pallas
TPU kernel called from ``PallasSineVoiceBank.process``) with the CUDA C++
kernel in ``csrc/sine_bank.cu``, built for sm_90a by ``kernels/build.py``.

Per voice and sample it computes what ``_sine_kernel`` computes: the
materialized freq/amp/pan ramps (``_mat``, with D breakpoint rounds in
eventful blocks), the packed restart/release trigger bits (``_trig_bit``),
the saturating u32 phase increment (``_to_inc``), the table-quantized sine
from the folded-quadrant degree-9 polynomial (``_sin_quant``), the EnvAsr
state machine (``_env_asr`` / ``_env_asr_free``) and the equal-power pan
gains (``_pan_gains``), and mixes the bank to stereo.

What bounds it on an H100: FP32 and SFU issue. Each voice-sample costs
roughly 60 float/integer ops event-free (the sine and pan polynomials are
most of them; an eventful sample adds ``cosf``/``sinf`` and 15*D breakpoint
selects), while memory traffic is a few tens of bytes per voice per block
(15 ramp floats and 4 state words in, 4 out). The mix is a per-sample warp
reduction (five ``__shfl_down_sync`` per channel) whose 2 floats per warp
per sample are the only stores inside the loop; the warp partials
``[ceil(V/32), 2, B]`` are summed by ``torch.sum`` afterwards, the split the
JAX package makes between its tile partials and XLA.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``sine_bank_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ugens.wavetable import TABLE_HIGH_MASK, TABLE_SIZE

# kernel launches since import (or since a caller reset it): a run shows
# its main path went through the kernel by reading this around it
LAUNCHES = 0

N_FLOAT = 3  # freq, amp, pan (SineVoice's float params, in bank order)
FREQ, AMP, PAN = 0, 1, 2
N_GROUP = 5  # floats per ramp group / breakpoint group
# largest block the bank takes (the JAX package's cap, kept for parity)
MAX_BLOCK = 1024

_IDX_SCALE = np.float32(2.0 * np.pi / TABLE_SIZE)
_HALF_PI = np.float32(np.pi / 2.0)
# degree-9 odd polynomial for sin(u) on [0, pi/2]: max error 1.2e-7
_SIN_C = (np.float32(1.0), np.float32(-0.16666652), np.float32(0.008332964),
          np.float32(-0.00019804752), np.float32(2.5981028e-06))
_TO_INC_MAX = 2.0**31 - 128  # largest f32 below 2^31: the int32 cast is exact
_U32 = 2**32


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"sine_bank: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"sine_bank: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"sine_bank: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"sine_bank: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"sine_bank: {name} must be contiguous")


def _validate(ramps, rounds, act, words, phase, stage, t, rscale, block_size):
    """Check every operand against the layout the kernel reads; returns
    (V, B, D) with D = 0 for an event-free block."""
    V = phase.shape[0] if phase.dim() == 1 else -1
    B = int(block_size)
    if V < 1:
        raise ValueError("sine_bank: phase must be a non-empty [V] tensor")
    if not 1 <= B <= MAX_BLOCK:
        raise ValueError(
            f"sine_bank: block_size must be in [1, {MAX_BLOCK}], got {B}")
    dev, f32 = phase.device, torch.float32
    _check("phase", phase, torch.int32, (V,), dev)
    for name, x in (("stage", stage), ("t", t), ("rscale", rscale)):
        _check(name, x, f32, (V,), dev)
    _check("ramps", ramps, f32, (N_FLOAT, N_GROUP, V), dev)
    eventful = rounds is not None
    if eventful != (act is not None) or eventful != (words is not None):
        raise ValueError(
            "sine_bank: rounds, act and words are given together (eventful "
            "block) or not at all (event-free block)")
    if not eventful:
        return V, B, 0
    D = rounds.shape[2] if rounds.dim() == 4 else 0
    if D < 1:
        raise ValueError("sine_bank: rounds must be [3, 5, D, V] with D >= 1")
    _check("rounds", rounds, f32, (N_FLOAT, N_GROUP, D, V), dev)
    _check("act", act, f32, (V,), dev)
    _check("words", words, torch.int32, (2, (B + 31) // 32, V), dev)
    return V, B, D


def sine_bank(*, ramps, rounds, act, words, phase, stage, t, rscale,
              block_size, atk, rel, f2pi):
    """One block of the fused sine bank.

    ramps:  f32 [3, 5, V] — per float param (freq, amp, pan) the anchored
            ramp group (v0, step, el, dur, tgt). Event-free blocks carry amp
            with ``act`` already folded in and pan as the linear-angle pack
            (a0, da, lt, rt, rem).
    rounds: f32 [3, 5, D, V] breakpoints (v0, step, dur, tgt, frame), or
            None for an event-free block.
    act:    f32 [V] 0/1 active gain (eventful only).
    words:  int32 [2, ceil(B/32), V] restart and release trigger bits
            (eventful only).
    phase:  int32 [V] bit pattern of the u32 oscillator phase.
    stage, t, rscale: f32 [V] EnvAsr state.
    atk, rel, f2pi: f32-representable floats (per-sample envelope rates and
            phase units per Hz).

    Returns (mix f32 [2, B], phase, stage, t, rscale), the state new
    tensors. CPU tensors run ``sine_bank_plain``; CUDA tensors launch the
    kernel."""
    operands = dict(ramps=ramps, rounds=rounds, act=act, words=words,
                    phase=phase, stage=stage, t=t, rscale=rscale,
                    block_size=block_size, atk=atk, rel=rel, f2pi=f2pi)
    if phase.device.type == "cpu":
        return sine_bank_plain(**operands)
    outs = empty_outputs(phase, block_size)
    launch(outs, **operands)
    partial, *state = outs
    return (partial.sum(dim=0), *state)


def empty_outputs(phase, block_size):
    """The kernel's output buffers for a bank of ``phase.shape[0]`` voices:
    (partial mix [ceil(V/32), 2, B], phase, stage, t, rscale)."""
    V = phase.shape[0]
    f32 = torch.float32
    return (torch.empty(((V + 31) // 32, 2, int(block_size)), dtype=f32,
                        device=phase.device),
            torch.empty_like(phase),
            *(torch.empty((V,), dtype=f32, device=phase.device)
              for _ in range(3)))


def launch(outs, *, ramps, rounds, act, words, phase, stage, t, rscale,
           block_size, atk, rel, f2pi):
    """Launch the CUDA kernel on the current stream, writing ``outs`` (from
    ``empty_outputs``): the warp partials of the mix and the new state.
    Raises for anything but CUDA tensors of the documented layout, and if
    the launch fails."""
    global LAUNCHES
    V, B, D = _validate(ramps, rounds, act, words, phase, stage, t, rscale,
                        block_size)
    device = phase.device
    if device.type != "cuda":
        raise ValueError(f"sine_bank: unsupported device {device}")
    partial, phase_out, stage_out, t_out, rscale_out = outs
    _check("partial", partial, torch.float32, ((V + 31) // 32, 2, B), device)
    _check("phase_out", phase_out, torch.int32, (V,), device)
    for name, x in (("stage_out", stage_out), ("t_out", t_out),
                    ("rscale_out", rscale_out)):
        _check(name, x, torch.float32, (V,), device)

    from .build import load_library

    lib = load_library()

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_sine_bank(
            ptr(ramps), ptr(rounds), ptr(act), ptr(words),
            ptr(phase), ptr(stage), ptr(t), ptr(rscale),
            ptr(partial), ptr(phase_out), ptr(stage_out), ptr(t_out),
            ptr(rscale_out),
            V, B, D, int(rounds is not None),
            ctypes.c_float(atk), ctypes.c_float(rel), ctypes.c_float(f2pi),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"sine_bank: kernel launch failed with CUDA error {err} "
            f"({lib.ktt_error_string(err).decode()})")
    LAUNCHES += 1


# --------------------------------------------------------------------------
# plain torch version: the same arithmetic, op for op, over [V] per sample
# --------------------------------------------------------------------------

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
    word = words[i >> 5].long() & (_U32 - 1)
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


def sine_bank_plain(*, ramps, rounds, act, words, phase, stage, t, rscale,
                    block_size, atk, rel, f2pi):
    """``sine_bank`` in plain torch: a Python loop over the B samples with
    [V]-wide ops in the kernel's order, on whatever device the tensors are
    on. The u32 phase is carried as int64 in [0, 2^32) (torch has no uint32
    arithmetic) and returned as its int32 bit pattern. The mix is one
    ``torch.sum`` per sample and channel, so it differs from the kernel's
    warp-tree sum by rounding only."""
    V, B, _ = _validate(ramps, rounds, act, words, phase, stage, t, rscale,
                        block_size)
    dev = phase.device

    def scalar(x):
        return torch.tensor(np.float32(x), device=dev)

    atk, rel, f2pi = scalar(atk), scalar(rel), scalar(f2pi)
    eventful = rounds is not None
    rg = (lambda p: rounds[p]) if eventful else (lambda p: None)
    ph = phase.long() & (_U32 - 1)
    outl, outr = [], []
    for i in range(B):
        i_f = float(i)
        restart = _trig_bit(i, words[0]) if eventful else None
        release = _trig_bit(i, words[1]) if eventful else None
        env, stage, t, rscale = _env_asr(stage, t, rscale, restart, release,
                                         atk, rel)
        gain = env * _mat(i_f, ramps[AMP], rg(AMP))
        if eventful:
            gain = gain * act
        freq = _mat(i_f, ramps[FREQ], rg(FREQ))
        osc = _sin_quant(ph)
        ph = (ph + _to_inc(freq * f2pi)) & (_U32 - 1)
        sig = osc * gain
        panl, panr = _pan_gains(i_f, ramps[PAN], rg(PAN))
        outl.append(torch.sum(sig * panl))
        outr.append(torch.sum(sig * panr))
    mix = torch.stack([torch.stack(outl), torch.stack(outr)])
    phase_out = torch.where(ph >= 2**31, ph - _U32, ph).to(torch.int32)
    return mix, phase_out, stage, t, rscale
