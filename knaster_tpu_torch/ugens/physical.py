"""Port of knaster_tpu/ugens/physical.py: ``PluckedString``, a Karplus-Strong string.

``PluckedString`` is an excitation-driven Karplus-Strong resonator
(Jaffe-Smith extensions: allpass fractional tuning, loop-filter delay
compensation). The excitation is an audio INPUT: "pluck" is any short
burst fed into it (``WhiteNoise * EnvAr`` is the classic), so the string
itself has no trigger. The loop shares ``AllpassDelay``'s geometry and
blockwise read (``ugens/delay.py``).

Whenever the loop is at least one block long (``long=True`` and freq <=
sr/B) the whole block vectorizes: ring reads cannot reach the block's own
writes, and the loop's two one-pole recurrences (the allpass interpolator,
the brightness lowpass) are affine scans (``core/dsp.affine_scan_1d``).
Short strings keep the per-sample loop. The scans take the port's one
association, which differs from the JAX package's ``associative_scan`` at
the ulp.

Every function takes leading batch axes: rows are ``[..., B]``, the ring
``[..., L]``. ``string_geometry`` and ``string_blockwise`` also serve the
bank-scale ``models.voices.PluckedVoice``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dsp import affine_scan_1d, const
from ..core.ugen import AudioCtx, UGen
from ..primitives.params import ParameterKind, pfloat
from .delay import _blockwise_read, _delay_geometry


def string_geometry(freq, brightness, damp, sample_rate, min_freq, L: int, dtype):
    """(nf, coeff, b1, damp) of the loop from its compensated length:
    ``sr / freq`` less the loop filters' own delay (0.5 samples for the
    averaging FIR, ``b1 / (1 - b1)`` capped at 8 for the one-pole), split
    into whole frames and an allpass coefficient (physical.py:63-71)."""
    freq = freq.clamp(float(min_freq), sample_rate / 2)
    b1 = (1.0 - brightness).clamp(0.0, 0.995).to(dtype)
    one = const(1.0, b1)
    comp = 0.5 + torch.minimum(b1 / (one - b1), const(8.0, b1))
    df = (const(float(sample_rate), freq) / freq - comp).clamp(1.0, float(L - 2))
    nf, coeff = _delay_geometry(df, L, dtype)
    return nf, coeff, b1, damp.to(dtype)


def string_blockwise(state, x, nf, coeff, b1, damp):
    """One block of the loop, vectorized (needs nf >= B, so no read reaches
    the block's writes): the allpass read, the averaging FIR, the
    brightness one-pole as an affine scan, ``write = x + damp * lp``.
    ``state`` holds buf/wp/ap_in/ap_out/d_last/lp; nf and coeff are ``[...,
    B]`` rows, b1 and damp rows or ``[..., 1]``. Returns (state', write
    [..., B])."""
    raw, d = _blockwise_read(state, nf, coeff)
    buf = state["buf"]
    L, B = buf.shape[-1], x.shape[-1]
    d_prev = torch.cat([state["d_last"].unsqueeze(-1), d[..., :-1]], dim=-1)
    h = 0.5 * (d + d_prev)
    a0 = 1.0 - b1
    lp_pre, _ = affine_scan_1d(b1.expand(h.shape), a0 * h, state["lp"])
    lp = b1 * lp_pre + a0 * h
    write = x + damp * lp
    wp = state["wp"].long()
    slots = (wp.unsqueeze(-1) + torch.arange(B, device=buf.device)) % L
    new = {
        "buf": buf.scatter(-1, slots, write),
        "wp": ((wp + B) % L).to(torch.int32),
        "ap_in": raw[..., -1],
        "ap_out": d[..., -1],
        "d_last": d[..., -1],
        "lp": lp[..., -1],
    }
    return new, write


class PluckedString(UGen):
    """Karplus-Strong string: ``buf`` is the traveling wave, the loop is
    delay -> allpass fractional tuning -> damping average -> brightness
    one-pole -> * damp -> (+ excitation) -> write::

        d[n]   = allpass_read(buf, sr/freq - comp)
        h[n]   = 0.5 * (d[n] + d[n-1])
        lp[n]  = b1*lp[n-1] + (1-b1)*h[n]
        w[n]   = x[n] + damp * lp[n]
        out[n] = w[n]

    Params: ``freq`` (Hz), ``damp`` (the loop gain, < 1 decays),
    ``brightness`` (1 bypasses the lowpass). ``min_freq`` bounds the ring
    (the lowest note). ``long=True`` declares that freq stays <= sr/block
    and takes the blockwise path; ``max_freq`` (long mode) bounds the
    shortest loop, which becomes the node's ``superblock_cap``."""

    inputs = 1
    outputs = 1
    params = (
        pfloat("freq", 220.0, range=(1.0, 20000.0), logarithmic=True,
               kind=ParameterKind.FREQUENCY),
        pfloat("damp", 0.996, range=(0.0, 1.0)),
        pfloat("brightness", 1.0, range=(0.0, 1.0)),
    )

    def __init__(self, freq: float = 220.0, damp: float = 0.996,
                 brightness: float = 1.0, min_freq: float = 20.0,
                 long: bool = False, max_freq=None):
        self.min_freq = float(min_freq)
        self.long = bool(long)
        self.block_invariant = not self.long  # long clamps loops >= block
        self.max_freq = None if max_freq is None else float(max_freq)
        self.pdefaults = {"freq": float(freq), "damp": float(damp),
                          "brightness": float(brightness)}

    def init(self, ctx: AudioCtx, device="cpu"):
        L = int(np.ceil(ctx.sample_rate / self.min_freq)) + 4
        if self.long and self.max_freq is not None:
            # loops never get shorter than sr/max_freq: superblocks up to
            # that length equal per-block rendering
            self.superblock_cap = max(1, min(L, int(ctx.sample_rate / self.max_freq)))

        def zero():
            return torch.zeros((), dtype=ctx.dtype, device=device)

        # a silent string starts at rest (the interpolator too)
        return {"buf": torch.zeros((L,), dtype=ctx.dtype, device=device),
                "wp": torch.zeros((), dtype=torch.int32, device=device),
                "ap_in": zero(), "ap_out": zero(), "d_last": zero(), "lp": zero()}

    def process(self, ctx: AudioCtx, state, inputs, params):
        B = ctx.block_size
        L = state["buf"].shape[-1]
        x = inputs[..., 0, :]
        nf, coeff, b1, damp = string_geometry(
            params["freq"], params["brightness"], params["damp"], ctx.sample_rate,
            self.min_freq, L, ctx.dtype)
        if self.long and L >= B:
            new, write = string_blockwise(state, x, nf.clamp(min=B), coeff, b1, damp)
            return new, write.unsqueeze(-2)
        # the loop sample by sample: a read may reach this block's writes
        buf, wp = state["buf"], state["wp"].long()
        ap_in, ap_out, d_last, lp = state["ap_in"], state["ap_out"], state["d_last"], state["lp"]
        outs = []
        for t in range(B):
            rp = ((wp + L - nf[..., t]) % L).unsqueeze(-1)
            raw = torch.gather(buf, -1, rp)[..., 0]
            d = coeff[..., t] * (raw - ap_out) + ap_in
            h = 0.5 * (d + d_last)
            lp = b1[..., t] * lp + (1.0 - b1[..., t]) * h
            write = x[..., t] + damp[..., t] * lp
            buf = buf.scatter(-1, wp.unsqueeze(-1), write.unsqueeze(-1))
            wp = (wp + 1) % L
            ap_in, ap_out, d_last = raw, d, d
            outs.append(write)
        return ({"buf": buf, "wp": wp.to(torch.int32), "ap_in": ap_in, "ap_out": ap_out,
                 "d_last": d_last, "lp": lp},
                torch.stack(outs, dim=-1).unsqueeze(-2))
