"""Port of knaster_tpu/ugens/filters.py: the state-variable filter and the one-poles (reference svf.rs, onepole.rs).

These IIRs are linear recurrences, so a block runs as a prefix scan over
affine maps (``core/dsp.py``) instead of a per-sample loop. Coefficients
are recomputed for every sample from the parameter rows, with the
reference's ``set_coeffs`` formulas (svf.rs:150-268), so audio-rate
cutoff, q and gain modulation are exact.

SVF topology: cytomic SvfLinearTrapOptimised2 (Andrew Simper, 2013), as in
the reference (svf.rs:270-300)::

    v3 = x - ic2;  v1 = a1*ic1 + a2*v3;  v2 = ic2 + a2*ic1 + a3*v3
    ic1' = 2*v1 - ic1;  ic2' = 2*v2 - ic2;  y = m0*x + m1*v1 + m2*v2

which in state-space form is s' = M s + c with M = [[2*a1-1, -2*a2],
[2*a2, 1-2*a3]] and c = [2*a2, 2*a3]*x.

``svf_block`` and ``onepole_block`` serve ``process`` and the chain
kernel's plain bodies alike (``csrc/chain_kernel.cu`` repeats them op for
op), so the scan executor and the kernel path agree bit for bit. On the
card ``SvfFilter.process`` runs ``svf_block`` in one launch of
``csrc/svf_filter.cu`` (``kernels/svf_filter.py``), bit-equal to it. Every
division divides by a tensor (``core/dsp.py`` ``const``).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..core.dsp import affine_scan_1d, affine_scan_2x2_rows, const, tan_first_quadrant
from ..core.ugen import AudioCtx, UGen
from ..primitives.params import ParameterKind, pfloat, pinteger, ptrigger


class SvfFilterType(enum.IntEnum):
    """svf.rs SvfFilterType (KnasterIntegerParameter enum)."""

    Low = 0
    High = 1
    Band = 2
    Notch = 3
    Peak = 4
    All = 5
    Bell = 6
    LowShelf = 7
    HighShelf = 8


def svf_coefficients(ty, cutoff, q, gain_db, sample_rate):
    """SvfFilter::set_coeffs (svf.rs:150-268) for every sample.

    ``ty`` holds the filter type per sample (int, or whole-number floats);
    the float rows share one shape. Returns (a1, a2, a3, m0, m1, m2)."""
    one = torch.ones_like(cutoff)
    zero = torch.zeros_like(cutoff)
    amp = torch.pow(const(10.0, cutoff), gain_db / const(40.0, cutoff))
    sqrt_amp = torch.sqrt(amp)

    is_bell = ty == SvfFilterType.Bell
    is_ls = ty == SvfFilterType.LowShelf
    is_hs = ty == SvfFilterType.HighShelf

    # the polynomial tan at f32 (core/dsp.py tan_first_quadrant)
    g_base = tan_first_quadrant((const(np.pi, cutoff) * cutoff) / const(sample_rate, cutoff))
    g = torch.where(is_bell | is_ls, g_base / sqrt_amp,
                    torch.where(is_hs, g_base * sqrt_amp, g_base))
    k = torch.where(is_bell, one / (q * amp), one / q)
    a1 = one / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2

    # m0/m1/m2 per type: the first matching case, as the JAX package's
    # chained wheres pick it
    def pick(cases, default):
        out = default
        for cond, val in reversed(cases):
            out = torch.where(cond, val, out)
        return out

    m0 = pick([
        (ty == SvfFilterType.Low, zero),
        (ty == SvfFilterType.Band, zero),
        (ty == SvfFilterType.HighShelf, amp * amp),
    ], one)
    m1 = pick([
        (ty == SvfFilterType.Low, zero),
        (ty == SvfFilterType.Band, one),
        (ty == SvfFilterType.Notch, -k),
        (ty == SvfFilterType.High, -k),
        (ty == SvfFilterType.Peak, -k),
        (ty == SvfFilterType.All, -2.0 * k),
        (ty == SvfFilterType.Bell, k * (amp * amp - 1.0)),
        (ty == SvfFilterType.LowShelf, k * (amp - 1.0)),
        (ty == SvfFilterType.HighShelf, k * (1.0 - amp) * amp),
    ], zero)
    m2 = pick([
        (ty == SvfFilterType.Low, one),
        (ty == SvfFilterType.High, -one),
        (ty == SvfFilterType.Peak, -2.0 * one),
        (ty == SvfFilterType.LowShelf, amp * amp - 1.0),
        (ty == SvfFilterType.HighShelf, 1.0 - amp * amp),
    ], zero)
    return a1, a2, a3, m0, m1, m2


def svf_block(ic, x, ty, cutoff, q, gain_db, sample_rate):
    """One block of the SVF over ``[..., B]`` rows; ic: ``[..., 2]``.
    Returns (new ic, y). The plain version of ``kernels/svf_filter.py``."""
    a1, a2, a3, m0, m1, m2 = svf_coefficients(ty, cutoff, q, gain_db, sample_rate)
    s_pre0, s_pre1, f0, f1 = affine_scan_2x2_rows(
        2.0 * a1 - 1.0, -2.0 * a2, 2.0 * a2, 1.0 - 2.0 * a3,
        2.0 * a2 * x, 2.0 * a3 * x, ic[..., 0], ic[..., 1])
    v3 = x - s_pre1
    v1 = a1 * s_pre0 + a2 * v3
    v2 = s_pre1 + a2 * s_pre0 + a3 * v3
    y = m0 * x + m1 * v1 + m2 * v2
    return torch.stack([f0, f1], dim=-1), y


class SvfFilter(UGen):
    """Versatile EQ filter (svf.rs:40-300 SvfFilter).

    Params: filter (int enum), cutoff_freq, q, gain (dB). The reference's
    ``t_calculate_coefficients`` trigger is kept for API parity but is a
    no-op: the coefficients always follow the parameter rows."""

    inputs = 1
    outputs = 1
    params = (
        pinteger("filter", SvfFilterType.Low, enum=SvfFilterType),
        pfloat("cutoff_freq", 1000.0, kind=ParameterKind.FREQUENCY),
        pfloat("q", 0.7071),
        pfloat("gain", 0.0),
        ptrigger("t_calculate_coefficients"),
    )

    def batch_key(self):
        return (type(self),)

    def __init__(self, ty: SvfFilterType = SvfFilterType.Low, cutoff_freq: float = 1000.0,
                 q: float = 0.7071, gain_db: float = 0.0):
        self.pdefaults = {"filter": int(ty), "cutoff_freq": float(cutoff_freq),
                          "q": float(q), "gain": float(gain_db)}

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"ic": torch.zeros((2,), dtype=ctx.dtype, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        # one launch of csrc/svf_filter.cu on the card, its plain torch
        # version (svf_block) on the CPU
        from ..kernels.svf_filter import svf_filter

        ic, y = svf_filter(state["ic"], inputs[..., 0, :], params["filter"],
                           params["cutoff_freq"], params["q"], params["gain"], ctx.sample_rate)
        return {"ic": ic}, y.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        from ..kernels.chain_kernel import BODIES

        return BODIES["svf"], 0


def onepole_lowpass_coeffs(freq, sample_rate):
    """OnePole::set_freq_lowpass (onepole.rs:34-46): b1 = e^(-2 pi f/sr).
    Returns (a0, b1)."""
    b1 = torch.exp(const(-2.0 * np.pi, freq) * (freq / const(sample_rate, freq)))
    return 1.0 - b1, b1


def onepole_block(last, x, freq, sample_rate, highpass):
    """One block of the one-pole lowpass ``y[t] = b1*y[t-1] + a0*x[t]`` over
    ``[..., B]`` rows (the highpass outputs x - y). Returns (new last, out)."""
    a0, b1 = onepole_lowpass_coeffs(freq, sample_rate)
    y_pre, y_final = affine_scan_1d(b1, a0 * x, last)
    y = b1 * y_pre + a0 * x  # the state after each step is the output
    return y_final, (x - y if highpass else y)


class _OnePoleBase(UGen):
    inputs = 1
    outputs = 1
    params = (pfloat("cutoff_freq", 20000.0, kind=ParameterKind.FREQUENCY),)
    HIGHPASS = False

    def __init__(self, cutoff_freq: float = 20000.0):
        self.pdefaults = {"cutoff_freq": float(cutoff_freq)}

    def batch_key(self):
        return (type(self),)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"last": torch.zeros((), dtype=ctx.dtype, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        last, y = onepole_block(state["last"], inputs[..., 0, :], params["cutoff_freq"],
                                ctx.sample_rate, self.HIGHPASS)
        return {"last": last}, y.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        from ..kernels.chain_kernel import BODIES

        return BODIES["onepole_hpf" if self.HIGHPASS else "onepole_lpf"], 0


class OnePoleLpf(_OnePoleBase):
    """One-pole lowpass, 6 dB/oct (onepole.rs:111-141 OnePoleLpf)."""


class OnePoleHpf(_OnePoleBase):
    """One-pole highpass: the input minus the lowpass (onepole.rs:144-186;
    the reference's set_freq_highpass takes the lowpass coefficients)."""

    HIGHPASS = True
