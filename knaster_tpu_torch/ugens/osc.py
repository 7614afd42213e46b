"""Port of knaster_tpu/ugens/osc.py: the u32 wavetable-phase helpers and ``SinWt``.

The reference's per-sample phase-increment loop is a block-level exclusive
cumulative sum of per-sample increments, exact in u32 fixed point, with
phase-reset triggers as a segmented cumsum (subtract the running sum at
the latest reset frame). The plain torch versions carry u32 values as int64
in [0, 2^32) (torch has no uint32 arithmetic): the cumsum of at most a
block of increments below 2^31 is exact in int64, and one mask wraps it.
State holds the phase as its int32 bit pattern, as the fused banks do.

Every function takes leading batch axes: values are ``[..., B]``, phases
``[...]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen
from ..kernels.bank_common import i32_of, u32_of
from ..primitives.params import ParameterKind, pfloat, ptrigger
from .wavetable import FRACTIONAL_PART, TABLE_HIGH_MASK, TABLE_SIZE, NonAaWavetable

U32_MASK = (1 << 32) - 1
# the largest f32 below 2^31: the int32 conversion of the clamped value is
# exact on every backend (osc.py:37 in the JAX package)
F32_TO_U32_MAX = 2.0**31 - 128


def scalar_of(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float (what
    ``jnp.asarray(x, dtype)`` holds)."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def _f32_to_u32(x):
    """float -> u32 (int64 in [0, 2^31 - 128]): clamp, then truncate toward
    zero; negative values give 0 (Rust ``as u32`` saturation)."""
    return x.clamp(0.0, F32_TO_U32_MAX).to(torch.int32).to(torch.int64)


def _freq_to_inc_u32(freq, f2pi: float, dtype):
    """freq -> u32 phase increment: ``freq * f2pi`` rounds in ``dtype``
    before the clamp."""
    return _f32_to_u32(freq * scalar_of(f2pi, dtype))


def _segmented_cumsum_u32(inc, reset_mask, phase0, block_size: int,
                          no_resets: bool = False):
    """phases[t] for t in 0..B and the carried phase after the block, u32
    values as int64.

    phases[t] = phase0 + sum(inc[0:t]) (wrapping u32), unless a reset
    trigger fired at some frame r <= t: then phases[t] = sum(inc[r:t]).
    ``no_resets`` (the fast program's ``AudioCtx.no_events``) skips the
    reset machinery."""
    B = block_size
    csum = torch.cumsum(inc, dim=-1)  # exact: B increments below 2^31
    ecs = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)  # [..., B+1]
    p0 = phase0.unsqueeze(-1)
    if no_resets:
        return (p0 + ecs[..., :B]) & U32_MASK, (phase0 + ecs[..., B]) & U32_MASK
    t_idx = torch.arange(B, device=inc.device)
    marks = torch.where(reset_mask, t_idx, torch.full_like(t_idx, -1))
    last_reset = torch.cummax(marks, dim=-1).values
    has_reset = last_reset >= 0
    base_at_reset = torch.gather(ecs, -1, last_reset.clamp(min=0))
    phases = torch.where(has_reset, ecs[..., :B] - base_at_reset,
                         p0 + ecs[..., :B]) & U32_MASK
    last_r = last_reset[..., B - 1]  # the latest reset frame, or -1
    at_last = torch.gather(ecs, -1, last_r.clamp(min=0).unsqueeze(-1))[..., 0]
    carry = torch.where(last_r >= 0, ecs[..., B] - at_last,
                        phase0 + ecs[..., B]) & U32_MASK
    return phases, carry


_SINE_TABLES = {}


def shared_sine_table(dtype, device):
    """The shared non-AA sine table (osc.rs SINE_WAVETABLE_F32), stored in
    f32 regardless of the sample type, as the reference does."""
    key = (dtype, str(device))
    tab = _SINE_TABLES.get(key)
    if tab is None:
        buf = NonAaWavetable.sine().buffer.astype(np.float32)
        tab = torch.from_numpy(buf).to(device=device, dtype=dtype)
        _SINE_TABLES[key] = tab
    return tab


class SinWt(UGen):
    """Sine with the reference's u32 fixed-point wavetable phase
    (osc.rs:97-168 SinWt: 16384-entry table, lookup without interpolation).

    As in the JAX package, the sine of the quantized index is recomputed
    instead of read from the table: the same phase quantization and
    frequency truncation, no gather. ``lookup=True`` reads the table."""

    inputs = 0
    outputs = 1
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("phase_offset", 0.0),
        ptrigger("reset_phase"),
    )

    def batch_key(self):
        return (type(self), self.lookup)

    def __init__(self, freq: float = 440.0, lookup: bool = False):
        self.pdefaults = {"freq": float(freq)}
        self.lookup = bool(lookup)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"phase": torch.zeros((), dtype=torch.int32, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        B = ctx.block_size
        f2pi = float(TABLE_SIZE) * float(FRACTIONAL_PART) / ctx.sample_rate
        inc = _freq_to_inc_u32(params["freq"], f2pi, ctx.dtype)
        phases, carry = _segmented_cumsum_u32(
            inc, params["reset_phase"], u32_of(state["phase"]), B,
            no_resets=ctx.no_events,
        )
        off = _f32_to_u32(params["phase_offset"] * float(FRACTIONAL_PART))
        idx = ((phases + off) >> 16) & TABLE_HIGH_MASK
        if self.lookup:
            out = shared_sine_table(ctx.dtype, idx.device)[idx]
        else:
            scale = scalar_of(2.0 * np.pi / TABLE_SIZE, ctx.dtype)
            out = torch.sin(idx.to(ctx.dtype) * scale)
        return {"phase": i32_of(carry)}, out.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        """Chain-kernel body: the fast program's no-reset path, one block
        scan of the u32 increments per stage (exact in any order)."""
        if self.lookup:
            return None  # a table gather: no kernel body, as in the JAX package
        from ..kernels.chain_kernel import BODIES

        return BODIES["sinwt"], 0
