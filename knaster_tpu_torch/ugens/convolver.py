"""Port of knaster_tpu/ugens/convolver.py: ``Convolver``, uniform partitioned convolution.

The impulse response (IR) is split into K partitions of P samples (P the
largest divisor of the graph's block size <= 64); partition k's spectrum
is the real-input DFT of ``[h_k, 0..]`` (2P points). Per P-sample round
the convolver transforms the last 2P input samples, pushes the spectrum
into a frequency-domain delay line (FDL), forms ``Y = sum_k X_{t-k} H_k``
and keeps the last P samples of the inverse transform: exact linear
convolution, no added latency. A superblock of k*P samples runs k rounds
through the same FDL.

The transforms are the JAX package's matrix DFTs (``_dft_mats``, f64
angles rounded once to the context's dtype), four ``torch.matmul``s a
round. They run at full IEEE FP32 whatever the caller has set:
``ieee_fp32_matmul`` scopes TensorFloat-32 off around them and checks it
is off, since TF32's 10-bit mantissa would break the convolution's error
bound (the reference's 2e-4 against a direct convolution) without a
sign. The IR spectra and the FDL are state (``Hr``, ``Hi``, ``fdl_r``,
``fdl_i``, ``prev``), laid out as in the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen
from ..primitives.params import pfloat

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _dft_mats(B: int, dtype):
    """Real-input DFT / inverse matrices for 2B-point transforms (numpy
    ``dtype``). Forward ([2B, F], F = B+1 bins): Xr = seg @ cos, Xi = seg @
    msin. Inverse ([F, 2B], conjugate-symmetry weights baked in): y = Yr @
    icos + Yi @ isin. The angles are f64, so the f32 matrices are exact to
    one rounding."""
    F = B + 1
    n = np.arange(2 * B, dtype=np.float64)
    k = np.arange(F, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / (2.0 * B)  # [2B, F]
    fwd_cos = np.cos(ang).astype(dtype)
    fwd_msin = (-np.sin(ang)).astype(dtype)
    w = np.full(F, 2.0, np.float64)
    w[0] = 1.0
    w[F - 1] = 1.0
    icos = ((w[:, None] * np.cos(ang.T)) / (2.0 * B)).astype(dtype)
    # Re(Y e^{+i ang}) = Yr cos - Yi sin: the minus lives in the matrix
    isin = (-(w[:, None] * np.sin(ang.T)) / (2.0 * B)).astype(dtype)
    return fwd_cos, fwd_msin, icos, isin


_MATS = {}


def dft_mats(P: int, dtype, device):
    """``_dft_mats(P)`` as tensors of ``dtype`` on ``device``, made once."""
    key = (P, dtype, torch.device(device))
    if key not in _MATS:
        _MATS[key] = tuple(torch.from_numpy(m).to(device)
                           for m in _dft_mats(P, _NP_DTYPE[dtype]))
    return _MATS[key]


def tf32_off() -> bool:
    """True when cuBLAS's f32 products run at full IEEE precision. Reads
    ``fp32_precision`` where torch has it (its legacy ``allow_tf32``
    getter raises once the two APIs have been mixed)."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        return m.fp32_precision == "ieee"
    return not m.allow_tf32


@contextlib.contextmanager
def ieee_fp32_matmul():
    """cuBLAS's f32 products at full IEEE precision inside the block (no
    TensorFloat-32), the caller's setting restored after it. Raises by name
    if TF32 is still on inside."""
    m = torch.backends.cuda.matmul
    name = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
    prev = getattr(m, name)
    setattr(m, name, "ieee" if name == "fp32_precision" else False)
    try:
        if not tf32_off():
            raise RuntimeError("Convolver: TF32 is still on for f32 matmuls; its products "
                               "need full FP32 precision")
        yield
    finally:
        setattr(m, name, prev)


class Convolver(UGen):
    """Convolve the input with an impulse response (spectral, partitioned).

    ir:      ``[L]`` (mono) or ``[C, L]`` (C output channels).
    inputs:  1 (default) or C. With 1 input and a ``[C, L]`` IR the mono
             input feeds every IR channel; with ``inputs == C`` each channel
             convolves its own IR row.
    dry_wet: 0 = dry passthrough, 1 = fully wet (a sample-accurate param).

    The partition size is fixed by the graph's block size, so the state's
    shapes are the same at every superblock length and ``process`` covers a
    k-block superblock as k rounds through one FDL."""

    may_set_done = False
    params = (pfloat("dry_wet", 1.0, range=(0.0, 1.0)),)
    # the IR's spectra live in the state (init): a live IR swap of the same
    # length and channel layout is a program-cache hit
    signature_exclude = ("pdefaults", "ir")

    def __init__(self, ir, inputs: int = 1, dry_wet: float = 1.0):
        ir = np.asarray(ir, dtype=np.float32)
        if ir.ndim == 1:
            ir = ir[None, :]
        if ir.ndim != 2 or ir.shape[1] < 1:
            raise ValueError("ir must be [L] or [channels, L]")
        self.ir = ir
        self.outputs = int(ir.shape[0])
        if inputs not in (1, self.outputs):
            raise ValueError(f"inputs must be 1 or {self.outputs} (the IR's channels)")
        self.inputs = int(inputs)
        self.ir_length = int(ir.shape[1])
        self.pdefaults = {"dry_wet": float(dry_wet)}

    @classmethod
    def from_sound_file(cls, path: str, inputs: int = 1, dry_wet: float = 1.0):
        """A convolver over an IR file (wav/ogg/flac/mp3)."""
        from .buffer import Buffer

        return cls(Buffer.from_sound_file(path).data, inputs=inputs, dry_wet=dry_wet)

    def name(self) -> str:
        return f"Convolver[{self.outputs}ch x {self.ir_length}]"

    @staticmethod
    def _partition(block_size: int) -> int:
        """The largest divisor of the graph's block size <= 64."""
        return block_size // -(-block_size // 64)

    def init(self, ctx: AudioCtx, device="cpu"):
        P = self._partition(ctx.block_size)
        K = max(1, -(-self.ir_length // P))
        C, Cin, F = self.outputs, self.inputs, P + 1
        h = np.pad(self.ir, ((0, 0), (0, K * P - self.ir_length)))  # [C, K*P]
        parts = h.reshape(C, K, P).transpose(1, 0, 2)  # [K, C, P]
        spec = np.fft.rfft(np.concatenate([parts, np.zeros_like(parts)], axis=-1),
                           axis=-1)  # [K, C, F], on the host

        def zeros(shape):
            return torch.zeros(shape, dtype=ctx.dtype, device=device)

        return {
            "Hr": torch.from_numpy(np.ascontiguousarray(spec.real)).to(device, ctx.dtype),
            "Hi": torch.from_numpy(np.ascontiguousarray(spec.imag)).to(device, ctx.dtype),
            "fdl_r": zeros((K, Cin, F)),
            "fdl_i": zeros((K, Cin, F)),
            "prev": zeros((Cin, P)),
        }

    def _round(self, Hr, Hi, fdl_r, fdl_i, prev, x, dw, mats):
        """One P-sample FDL round: transform, push, spectral multiply-add,
        invert. ``x`` is ``[..., Cin, P]``, the FDL ``[..., K, Cin, F]``."""
        C, P = self.outputs, prev.shape[-1]
        fwd_cos, fwd_msin, icos, isin = mats
        seg = torch.cat([prev, x], dim=-1)  # [..., Cin, 2P]
        Xr = torch.matmul(seg, fwd_cos)
        Xi = torch.matmul(seg, fwd_msin)
        fdl_r = torch.cat([Xr.unsqueeze(-3), fdl_r[..., :-1, :, :]], dim=-3)
        fdl_i = torch.cat([Xi.unsqueeze(-3), fdl_i[..., :-1, :, :]], dim=-3)
        if self.inputs == C:
            sr, si = fdl_r, fdl_i
        else:  # the mono input feeds every IR channel
            sr, si = fdl_r[..., :1, :], fdl_i[..., :1, :]
        # complex multiply-add over the partitions, in real pairs
        Yr = torch.sum(sr * Hr - si * Hi, dim=-3)  # [..., C, F]
        Yi = torch.sum(sr * Hi + si * Hr, dim=-3)
        y = torch.matmul(Yr, icos) + torch.matmul(Yi, isin)  # [..., C, 2P]
        wet = y[..., P:]  # the overlap-save valid half
        dry = x if self.inputs == C else x[..., :1, :]
        return fdl_r, fdl_i, dw.unsqueeze(-2) * wet + (1.0 - dw).unsqueeze(-2) * dry

    def process(self, ctx: AudioCtx, state, inputs, params):
        B = ctx.block_size
        prev = state["prev"]
        P = prev.shape[-1]
        mats = dft_mats(P, ctx.dtype, prev.device)
        dw = params["dry_wet"]
        Hr, Hi = state["Hr"], state["Hi"]
        fdl_r, fdl_i = state["fdl_r"], state["fdl_i"]
        outs = []
        with ieee_fp32_matmul():
            for r in range(B // P):  # a superblock: B // P rounds through one FDL
                x = inputs[..., r * P:(r + 1) * P]
                fdl_r, fdl_i, out = self._round(Hr, Hi, fdl_r, fdl_i, prev, x,
                                                dw[..., r * P:(r + 1) * P], mats)
                outs.append(out)
                prev = x
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return {"Hr": Hr, "Hi": Hi, "fdl_r": fdl_r, "fdl_i": fdl_i, "prev": prev}, out
