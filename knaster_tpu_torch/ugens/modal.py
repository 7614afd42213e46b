"""Port of knaster_tpu/ugens/modal.py: ``ModalResonator``, banks of decaying sinusoidal modes.

A struck or plucked body as M independent second-order resonators
("modes"), each with a frequency ratio, a gain and a decay time; the input
channel drives all modes in parallel. A mode is the complex one-pole
``s[n] = p·s[n-1] + x[n]`` with pole ``p = r·e^{iθ}``, carried as the real
pair under a 2x2 rotation-decay affine map, so a block of all M modes is
one ``core/dsp.affine_scan_2x2_rows`` over ``[M, B]`` rows. Coefficients
follow the params per sample (audio-rate ``freq``/``decay`` are exact), and
a mode whose frequency crosses Nyquist gets radius 0 for those samples.

The mode sum is elementwise and a sum over M, never a matrix product (on
the card a float32 product could take TF32). The decay radius and the
rotation's cos/sin are taken in float64 and rounded, so that the card and
the CPU ring the same modes bit for bit: the JAX package's f32 ``exp``,
``cos`` and ``sin`` are XLA's, and the port's differ from them by an ulp
either way (tests/test_torch_modal.py states the drift this allows).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dsp import affine_scan_2x2_rows, const
from ..core.ugen import AudioCtx, UGen
from ..primitives.params import ParameterKind, pfloat

_LN10_M3 = float(-3.0 * np.log(10.0))  # ln(10^-3): -60 dB in amplitude


def _rounded(fn, x):
    """``fn(x)`` taken in float64 and rounded to x's dtype: the f32
    coefficients then agree on the card and the CPU, whose f32 exp/cos/sin
    are different kernels an ulp apart (an ulp in a mode's rotation drifts
    its phase sample after sample)."""
    return fn(x.double()).to(x.dtype)


class ModalResonator(UGen):
    """M parallel decaying sinusoid modes excited by the input channel.

    Static config: ``ratios`` (mode frequency = ``freq * ratios[m]``),
    ``gains`` (output mix weights) and ``decays`` (relative T60 per mode; the
    T60 of mode m is ``decay * decays[m]`` seconds). Params: ``freq`` (the
    fundamental in Hz) and ``decay`` (the T60 scale in seconds).

    Presets: :meth:`bell`, :meth:`bar`, :meth:`string`, :meth:`membrane`.
    """

    inputs = 1
    outputs = 1
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("decay", 1.0, range=(0.0, 100.0), kind=ParameterKind.SECONDS),
    )

    def __init__(self, freq: float = 440.0, decay: float = 1.0,
                 ratios: Sequence[float] = (1.0,),
                 gains: Optional[Sequence[float]] = None,
                 decays: Optional[Sequence[float]] = None):
        ratios = np.asarray(ratios, np.float32)
        if ratios.ndim != 1 or ratios.size == 0:
            raise ValueError("ratios must be a non-empty 1-D sequence")
        m = ratios.size
        gains = np.ones(m, np.float32) if gains is None else np.asarray(gains, np.float32)
        decays = np.ones(m, np.float32) if decays is None else np.asarray(decays, np.float32)
        if gains.shape != (m,) or decays.shape != (m,):
            raise ValueError("gains/decays must match ratios in length")
        self.ratios, self.gains, self.decays = ratios, gains, decays
        self.n_modes = m
        self.pdefaults = {"freq": float(freq), "decay": float(decay)}

    # ---- presets ----------------------------------------------------------
    @staticmethod
    def bell(freq: float = 440.0, decay: float = 4.0) -> "ModalResonator":
        """Church-bell partials (hum at 0.5, prime, tierce, quint, nominal
        and upper partials); the hum and prime ring longest."""
        return ModalResonator(
            freq, decay,
            ratios=(0.5, 1.0, 1.183, 1.506, 2.0, 2.514, 2.662, 3.011, 4.166,
                    5.433, 6.796, 8.215),
            gains=(0.6, 1.0, 0.75, 0.6, 0.9, 0.25, 0.2, 0.25, 0.15, 0.1,
                   0.07, 0.05),
            decays=(1.0, 0.8, 0.55, 0.45, 0.4, 0.25, 0.22, 0.18, 0.12, 0.09,
                    0.07, 0.05),
        )

    @staticmethod
    def bar(freq: float = 440.0, decay: float = 1.5, n_modes: int = 6) -> "ModalResonator":
        """Ideal free bar: mode frequencies scale as ((2k+1)/3)^2."""
        k = np.arange(1, n_modes + 1, dtype=np.float64)
        return ModalResonator(freq, decay, ratios=((2.0 * k + 1.0) / 3.0) ** 2,
                              gains=1.0 / k, decays=1.0 / k)

    @staticmethod
    def string(freq: float = 440.0, decay: float = 2.0, n_modes: int = 16) -> "ModalResonator":
        """Harmonic series with 1/h gains and decays."""
        h = np.arange(1, n_modes + 1, dtype=np.float64)
        return ModalResonator(freq, decay, ratios=h, gains=1.0 / h, decays=1.0 / h)

    @staticmethod
    def membrane(freq: float = 110.0, decay: float = 0.4) -> "ModalResonator":
        """Ideal circular membrane: Bessel-zero quotients, dense and inharmonic."""
        return ModalResonator(
            freq, decay,
            ratios=(1.0, 1.594, 2.136, 2.296, 2.653, 2.918, 3.156, 3.501),
            gains=(1.0, 0.7, 0.5, 0.45, 0.35, 0.3, 0.25, 0.2),
            decays=(1.0, 0.7, 0.55, 0.5, 0.42, 0.38, 0.33, 0.28),
        )

    # ---- UGen protocol ----------------------------------------------------
    def batch_key(self):
        return (type(self), self.ratios.tobytes(), self.gains.tobytes(),
                self.decays.tobytes())

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"s0": torch.zeros((self.n_modes,), dtype=ctx.dtype, device=device),
                "s1": torch.zeros((self.n_modes,), dtype=ctx.dtype, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        """Over leading batch axes: ``inputs [..., 1, B]``, params ``[..., B]``,
        state ``[..., M]``."""
        dtype = ctx.dtype
        like = state["s0"]
        sr = np.float32(ctx.sample_rate)
        ratios = torch.from_numpy(self.ratios).to(like.device, dtype)[:, None]  # [M, 1]
        rel = torch.from_numpy(self.decays).to(like.device, dtype)[:, None]
        gains = torch.from_numpy(self.gains).to(like.device, dtype)[:, None]

        freq = params["freq"].unsqueeze(-2)                          # [..., 1, B]
        theta = const(np.float32(2.0 * np.pi) / sr, like) * (freq * ratios)  # [..., M, B]
        alive = theta < const(np.float32(np.pi), like)
        # the radius for a T60 of decay*rel seconds: r = 10^(-3/(t60*sr))
        n60 = torch.clamp(params["decay"].unsqueeze(-2) * rel * const(sr, like),
                          min=np.float32(1e-4))
        r = torch.where(alive, _rounded(torch.exp, const(np.float32(_LN10_M3), like) / n60),
                        torch.zeros_like(n60))
        cth = r * _rounded(torch.cos, theta)
        sth = r * _rounded(torch.sin, theta)

        x = inputs[..., 0, :].unsqueeze(-2).expand(cth.shape)
        zero = torch.zeros_like(x)
        s_pre0, s_pre1, sf0, sf1 = affine_scan_2x2_rows(
            cth, -sth, sth, cth, x, zero, state["s0"], state["s1"])
        # the state after absorbing sample t (the strike is audible in its
        # own sample's rotation)
        y_modes = sth * s_pre0 + cth * s_pre1                        # [..., M, B]
        y = torch.sum(gains * y_modes, dim=-2)
        return {"s0": sf0, "s1": sf1}, y.unsqueeze(-2)

    def ring_energy(self, state):
        """Gain-weighted RMS amplitude of the ring-out (the scalar a voice's
        done decision reads)."""
        g = torch.from_numpy(self.gains).to(state["s0"].device, state["s0"].dtype)
        return torch.sqrt(torch.sum((g * state["s0"]) ** 2 + (g * state["s1"]) ** 2,
                                    dim=-1))
