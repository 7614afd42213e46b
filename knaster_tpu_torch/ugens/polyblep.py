"""Port of knaster_tpu/ugens/polyblep.py: the anti-aliased classic waveforms (reference polyblep.rs).

The phase is a u32 fixed-point sum over the block, 2^30 units a cycle (the
wavetable convention), exact in any order of summation; ``t`` is read back
from its top 24 bits. Every waveform is then an elementwise function of
``(t, dt, pulse_width)``. The waveform is an integer parameter read at
block rate: each row of a batched call (or each stage of a collapsed chain)
takes the waveform of its first sample, so batches and chains mix
waveforms. From sr/4 up the output is the pure sine (polyblep.rs:207-211).

The arithmetic here is the chain kernel's, op for op, in Python's
association (``csrc/chain_kernel.cu`` ``polyblep_wave``): ``polyblep_block``
serves ``PolyBlep.process`` and the kernel body's plain version alike, so
the two executors agree bit for bit.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..core.dsp import const
from ..core.ugen import AudioCtx, UGen
from ..kernels.bank_common import i32_of, u32_of
from ..primitives.params import ParameterKind, pfloat, pinteger
from .osc import U32_MASK, _freq_to_inc_u32


class Waveform(enum.IntEnum):
    """polyblep.rs Waveform."""

    Sawtooth = 0
    Sine = 1
    Cosine = 2
    Triangle = 3
    Square = 4
    Rectangle = 5
    Ramp = 6
    ModifiedTriangle = 7
    ModifiedSquare = 8
    HalfWaveRectifiedSine = 9
    FullWaveRectifiedSine = 10
    TriangularPulse = 11
    TrapezoidFixed = 12
    TrapezoidVariable = 13


PHASE_CYCLE = float(1 << 30)  # u32 phase units a cycle
PHASE_MASK = (1 << 30) - 1
T_SCALE = 1.0 / float(1 << 24)
TAU = 2.0 * np.pi


def _frac(t):
    return t - torch.trunc(t)


def _where(c, a, b, like):
    """``torch.where`` with Python numbers as ``like``'s dtype and device."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=like.dtype, device=like.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=like.dtype, device=like.device)
    return torch.where(c, a, b)


def phase_to_t(ph, dtype):
    """u32 phase (int64, mod 2^30 a cycle) -> the unit ramp t in [0, 1)."""
    return ((ph & PHASE_MASK) >> 6).to(dtype) * T_SCALE


def blep(t, dt):
    """Polynomial band-limited step residual (polyblep.rs:47-55)."""
    a = -torch.square(t / dt - 1.0)
    b = torch.square((t - 1.0) / dt + 1.0)
    return _where(t < dt, a, _where(t > 1.0 - dt, b, 0.0, t), t)


def blamp(t, dt):
    """Band-limited ramp residual (polyblep.rs:58-67)."""
    ta = t / dt - 1.0
    a = -(1.0 / 3.0) * ta * ta * ta
    tb = (t - 1.0) / dt + 1.0
    b = (1.0 / 3.0) * tb * tb * tb
    return _where(t < dt, a, _where(t > 1.0 - dt, b, 0.0, t), t)


def _sin(t, dt, pw):
    return torch.sin(t * TAU)


def _cos(t, dt, pw):
    return torch.cos(t * TAU)


def _half(t, dt, pw):
    t2 = _frac(t + 0.5)
    y = _where(t < 0.5, 2.0 * torch.sin(t * TAU) - 2.0 / np.pi, -2.0 / np.pi, t)
    return y + TAU * dt * (blamp(t, dt) + blamp(t2, dt))


def _full(t, dt, pw):
    _t = _frac(t + 0.25)
    y = 2.0 * torch.sin(_t * np.pi) - 4.0 / np.pi
    return y + TAU * dt * blamp(_t, dt)


def _fold4(y):
    """The triangle fold of y = 4t: y - 4 from 3 up, 2 - y above 1."""
    return _where(y >= 3.0, y - 4.0, _where(y > 1.0, 2.0 - y, y, y), y)


def _tri(t, dt, pw):
    t1 = _frac(t + 0.25)
    t2 = _frac(t + 0.75)
    y = _fold4(t * 4.0)
    return y + 4.0 * dt * (blamp(t1, dt) - blamp(t2, dt))


def _tri2(t, dt, pw):
    pw = torch.clamp(pw, 0.0001, 0.9999)
    t1 = _frac(t + 0.5 * pw)
    t2 = _frac(t + 1.0 - 0.5 * pw)
    y = t * 2.0
    y = _where(y >= 2.0 - pw, (y - 2.0) / pw,
               _where(y >= pw, 1.0 - (y - pw) / (1.0 - pw), y / pw, y), y)
    return y + dt / (pw - pw * pw) * (blamp(t1, dt) - blamp(t2, dt))


def _trip(t, dt, pw):
    t1 = _frac(t + 0.75 + 0.5 * pw)
    y1 = 4.0 * t1
    y = _where(t1 >= pw, -pw,
               _where(y1 >= 2.0 * pw, 4.0 - y1 / pw - pw, y1 / pw - pw, y1), y1)
    t2 = _frac(t1 + 1.0 - 0.5 * pw)
    t3 = _frac(t1 + 1.0 - pw)
    corr = 2.0 * dt / pw * (blamp(t1, dt) - 2.0 * blamp(t2, dt) + blamp(t3, dt))
    return _where(pw > 0.0, y + corr, y, y)


def _trap(t, dt, pw):
    y = torch.clamp(2.0 * _fold4(4.0 * t), -1.0, 1.0)
    t1 = _frac(t + 0.125)
    t2 = _frac(t1 + 0.5)
    y = y + 4.0 * dt * (blamp(t1, dt) - blamp(t2, dt))
    t1 = _frac(t + 0.375)
    t2 = _frac(t1 + 0.5)
    return y + 4.0 * dt * (blamp(t1, dt) - blamp(t2, dt))


def _trap2(t, dt, pw):
    pw = torch.clamp(pw, max=0.9999)
    scale = const(1.0, pw) / (1.0 - pw)
    y = torch.clamp(scale * _fold4(4.0 * t), -1.0, 1.0)
    t1 = _frac(t + 0.25 - 0.25 * pw)
    t2 = _frac(t1 + 0.5)
    y = y + scale * 2.0 * dt * (blamp(t1, dt) - blamp(t2, dt))
    t1 = _frac(t + 0.25 + 0.25 * pw)
    t2 = _frac(t1 + 0.5)
    return y + scale * 2.0 * dt * (blamp(t1, dt) - blamp(t2, dt))


def _sqr(t, dt, pw):
    t2 = _frac(t + 0.5)
    y = _where(t < 0.5, 1.0, -1.0, t)
    return y + blep(t, dt) - blep(t2, dt)


def _sqr2(t, dt, pw):
    t1 = _frac(t + 0.875 + 0.25 * (pw - 0.5))
    t2 = _frac(t + 0.375 + 0.25 * (pw - 0.5))
    y = _where(t1 < 0.5, 1.0, -1.0, t) + blep(t1, dt) - blep(t2, dt)
    t1 = _frac(t1 + 0.5 * (1.0 - pw))
    t2 = _frac(t2 + 0.5 * (1.0 - pw))
    y = y + _where(t1 < 0.5, 1.0, -1.0, t) + blep(t1, dt) - blep(t2, dt)
    return 0.5 * y


def _rect(t, dt, pw):
    t2 = _frac(t + 1.0 - pw)
    y = -2.0 * pw + _where(t < pw, 2.0, 0.0, t)
    return y + blep(t, dt) - blep(t2, dt)


def _saw(t, dt, pw):
    _t = _frac(t + 0.5)
    return 2.0 * _t - 1.0 - blep(_t, dt)


def _ramp(t, dt, pw):
    _t = _frac(t)
    return 1.0 - 2.0 * _t + blep(_t, dt)


WAVEFORM_FNS = (_saw, _sin, _cos, _tri, _sqr, _rect, _ramp, _tri2, _sqr2, _half,
                _full, _trip, _trap, _trap2)


def polyblep_block(t_word, waveform, freq, pulse_width, sample_rate, waveform_host=None):
    """One block of PolyBlep over ``[..., B]`` rows.

    t_word: the phase words ``[...]`` (u32 as int32); waveform: int
    ``[..., B]`` (read at sample 0 of each row; float rows holding whole
    numbers, as the chain kernel's planes carry them, work alike); freq and
    pulse_width: ``[..., B]``. Returns (new phase words, out ``[..., B]``).
    The distinct waveforms of the rows pick the waveform functions to run:
    ``waveform_host`` gives the rows' waveforms on the host (numpy of the
    leading shape, as the graph renderer passes them); without it they are
    read from the device, which waits for it."""
    dtype = freq.dtype
    sr = float(sample_rate)
    dt = freq / const(sr, freq)
    inc = _freq_to_inc_u32(freq, PHASE_CYCLE / sr, dtype)
    csum = torch.cumsum(inc, dim=-1)  # exact: B increments below 2^31
    ph0 = u32_of(t_word)
    t = phase_to_t(ph0.unsqueeze(-1) + csum - inc, dtype)
    carry = (ph0 + csum[..., -1]) & U32_MASK
    w = waveform[..., 0].clamp(0, len(WAVEFORM_FNS) - 1).to(torch.int64)
    if waveform_host is None:
        kinds = sorted(set(w.reshape(-1).tolist()))
    else:
        kinds = sorted(set(np.clip(np.asarray(waveform_host), 0, len(WAVEFORM_FNS) - 1)
                           .reshape(-1).tolist()))
    out = WAVEFORM_FNS[kinds[0]](t, dt, pulse_width)
    for k in kinds[1:]:
        out = torch.where((w == k).unsqueeze(-1), WAVEFORM_FNS[k](t, dt, pulse_width), out)
    out = torch.where(freq >= sr / 4.0, torch.sin(t * TAU), out)
    return i32_of(carry), out


class PolyBlep(UGen):
    """Anti-aliased classic waveforms via polyBLEP (polyblep.rs:128-509)."""

    inputs = 0
    outputs = 1
    params = (
        pinteger("waveform", Waveform.Sawtooth, enum=Waveform),
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("pulse_width", 0.5),
    )

    # the waveform selects at block rate: the renderer passes it on the host
    host_int_params = ("waveform",)

    def __init__(self, waveform: Waveform = Waveform.Sawtooth, freq: float = 440.0):
        self.pdefaults = {"waveform": int(waveform), "freq": float(freq)}

    def batch_key(self):
        # the waveform is a parameter: process closes over nothing of the
        # instance, so any PolyBleps batch and chain together
        return (type(self),)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"t": torch.zeros((), dtype=torch.int32, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        t, out = polyblep_block(state["t"], params["waveform"], params["freq"],
                                params["pulse_width"], ctx.sample_rate,
                                params.get("waveform_host"))
        return {"t": t}, out.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        from ..kernels.chain_kernel import BODIES

        return BODIES["polyblep"], 0
