"""Port of knaster_tpu/ugens/osc.py: the phase helpers, ``SinWt``, ``OscWt``, ``SinNumeric`` and ``Phasor``.

The reference's per-sample phase-increment loop is a block-level exclusive
cumulative sum of per-sample increments, exact in u32 fixed point, with
phase-reset triggers as a segmented cumsum (subtract the running sum at
the latest reset frame). The plain torch versions carry u32 values as int64
in [0, 2^32) (torch has no uint32 arithmetic): the cumsum of at most a
block of increments below 2^31 is exact in int64, and one mask wraps it.
State holds the phase as its int32 bit pattern, as the fused banks do.

``SinNumeric`` and ``Phasor`` accumulate a float phase in cycles instead,
over the whole block and wrapped only at its end, so their samples depend
on how the prefix sum associates and on the block length: the port sums in
``core/dsp.cumsum_base16``, the association the JAX package's
``jnp.cumsum`` takes on XLA's CPU backend, and the renderer partitions a
bounce into the same superblocks as the JAX package. Their increment is
``freq * (1 / sample_rate)``: the JAX package divides by the sample rate,
a constant, which XLA's CPU backend rewrites into a multiply by its
reciprocal (measured in ``tests/test_torch_param_sweep.py``); the port
multiplies by that reciprocal as a tensor, on the CPU and the card alike.

Every function takes leading batch axes: values are ``[..., B]``, phases
``[...]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dsp import const, cumsum_base16, recip
from ..core.ugen import AudioCtx, UGen
from ..kernels.bank_common import i32_of, u32_of
from ..primitives.params import ParameterKind, pfloat, ptrigger
from .wavetable import (AA_FREQ_THRESHOLDS, FRACTIONAL_PART, NUM_AA_TABLES, TABLE_HIGH_MASK,
                        TABLE_SIZE, NonAaWavetable, Wavetable)

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


def recip_sample_rate(sample_rate, like: torch.Tensor) -> torch.Tensor:
    """``1 / sample_rate`` rounded to ``like``'s dtype, as a 0-d tensor on
    its device: what the JAX package's division by the sample rate
    multiplies by (module docstring)."""
    return recip(sample_rate, like)


def _segmented_cumsum_f(inc, reset_mask, phase0, block_size: int, no_resets: bool = False):
    """Float phase accumulation with reset triggers (SinNumeric, Phasor):
    ``_segmented_cumsum_u32``'s rule over ``cumsum_base16`` without wrap.
    Returns (phases [..., B], the unwrapped phase after the block [...])."""
    B = block_size
    csum = cumsum_base16(inc)
    ecs = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)  # [..., B+1]
    p0 = phase0.unsqueeze(-1)
    if no_resets:
        return p0 + ecs[..., :B], phase0 + ecs[..., B]
    t_idx = torch.arange(B, device=inc.device)
    marks = torch.where(reset_mask, t_idx, torch.full_like(t_idx, -1))
    last_reset = torch.cummax(marks, dim=-1).values
    base_at_reset = torch.gather(ecs, -1, last_reset.clamp(min=0))
    phases = torch.where(last_reset >= 0, ecs[..., :B] - base_at_reset, p0 + ecs[..., :B])
    last_r = last_reset[..., B - 1]  # the latest reset frame, or -1
    at_last = torch.gather(ecs, -1, last_r.clamp(min=0).unsqueeze(-1))[..., 0]
    carry = torch.where(last_r >= 0, ecs[..., B] - at_last, phase0 + ecs[..., B])
    return phases, carry


def sin_numeric_block(phase0, freq, phase_offset, inv_sr, reset=None):
    """One block of SinNumeric: (the wrapped phase after it, out [..., B]).
    ``reset`` None is the event-free path (the chain kernel's body)."""
    phases, carry = _segmented_cumsum_f(freq * inv_sr, reset, phase0, freq.shape[-1],
                                        no_resets=reset is None)
    out = torch.sin((phases + phase_offset) * scalar_of(2.0 * np.pi, freq.dtype))
    # keep the carried phase bounded (the reference wraps with `-= 1.0`)
    return carry - torch.floor(carry), out


def phasor_block(phase0, freq, inv_sr):
    """One block of Phasor: (the wrapped phase after it, the 0 -> 1 ramp
    [..., B])."""
    phases, carry = _segmented_cumsum_f(freq * inv_sr, None, phase0, freq.shape[-1],
                                        no_resets=True)
    return carry - torch.floor(carry), phases - torch.floor(phases)


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


_AA_THRESHOLDS = {}


def aa_thresholds(device):
    """``AA_FREQ_THRESHOLDS`` (f32) on ``device``, copied there once."""
    key = str(device)
    th = _AA_THRESHOLDS.get(key)
    if th is None:
        th = torch.from_numpy(AA_FREQ_THRESHOLDS).to(device)
        _AA_THRESHOLDS[key] = th
    return th


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


class OscWt(UGen):
    """Arbitrary anti-aliased wavetable oscillator (osc.rs:30-90 OscWt).

    Owns a :class:`Wavetable` mip chain; the playback frequency selects the
    band-limited partial table per sample (``AA_FREQ_THRESHOLDS``: numpy's
    ``side="left"`` on the f32 frequency, also at f64) and the table is
    read at the u32 phase's index by a gather, nearest-neighbour as the
    reference's ``Wavetable::get``, or ``interpolate``d through the diff
    tables. The ``[17, TABLE_SIZE]`` tables (and diffs) live in the state,
    on the state's device, as in the JAX package."""

    inputs = 0
    outputs = 1
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("phase_offset", 0.0),
        ptrigger("reset_phase"),
    )

    def __init__(self, wavetable: Wavetable, freq: float = 440.0, interpolate: bool = False):
        self.pdefaults = {"freq": float(freq)}
        self.wavetable = wavetable
        self.interpolate = bool(interpolate)

    def init(self, ctx: AudioCtx, device="cpu"):
        np_dtype = np.float32 if ctx.dtype == torch.float32 else np.float64
        tables, diffs = self.wavetable.stacked(np_dtype)
        st = {
            "phase": torch.zeros((), dtype=torch.int32, device=device),
            "tables": torch.from_numpy(tables).to(device),
        }
        if self.interpolate:
            st["diffs"] = torch.from_numpy(diffs).to(device)
        return st

    def process(self, ctx: AudioCtx, state, inputs, params):
        B = ctx.block_size
        f2pi = float(TABLE_SIZE) * float(FRACTIONAL_PART) / ctx.sample_rate
        freq = params["freq"]
        inc = _freq_to_inc_u32(freq, f2pi, ctx.dtype)
        phases, carry = _segmented_cumsum_u32(
            inc, params["reset_phase"], u32_of(state["phase"]), B,
            no_resets=ctx.no_events,
        )
        off = _f32_to_u32(params["phase_offset"] * float(FRACTIONAL_PART))
        ph = (phases + off) & U32_MASK
        idx = (ph >> 16) & TABLE_HIGH_MASK
        ti = torch.searchsorted(aa_thresholds(freq.device), freq.to(torch.float32).contiguous(),
                                right=False)
        lin = ti * TABLE_SIZE + idx  # [..., B] into the flattened [17 * N] tables

        def read(tables):
            # one gather over each batch row's flattened tables
            flat = tables.reshape(-1, NUM_AA_TABLES * TABLE_SIZE)
            return torch.gather(flat, 1, lin.reshape(flat.shape[0], -1)).reshape(lin.shape)

        out = read(state["tables"])
        if self.interpolate:
            frac = (ph & 0xFFFF).to(ctx.dtype)
            frac = frac / const(65535.0, frac)
            out = out + read(state["diffs"]) * frac
        new_state = dict(state)
        new_state["phase"] = i32_of(carry)
        return new_state, out.unsqueeze(-2)


class SinNumeric(UGen):
    """Per-sample computed sine (osc.rs:222-270 SinNumeric): the phase in
    cycles, out = sin((phase + offset) * tau), the phase wrapped to [0, 1)
    at the block's end. The float phase makes the samples depend on the
    block partition (module docstring)."""

    inputs = 0
    outputs = 1
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("phase_offset", 0.0),
        ptrigger("reset_phase"),
    )

    def batch_key(self):
        return (type(self),)

    def __init__(self, freq: float = 440.0):
        self.pdefaults = {"freq": float(freq)}

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"phase": torch.zeros((), dtype=ctx.dtype, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        freq = params["freq"]
        carry, out = sin_numeric_block(
            state["phase"], freq, params["phase_offset"],
            recip_sample_rate(ctx.sample_rate, freq),
            None if ctx.no_events else params["reset_phase"])
        return {"phase": carry}, out.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        """Chain-kernel body: the fast program's no-reset path."""
        from ..kernels.chain_kernel import BODIES

        return BODIES["sin_numeric"], 0


class Phasor(UGen):
    """0 -> 1 ramp at a given frequency; aliasing (osc.rs:172-218 Phasor)."""

    inputs = 0
    outputs = 1
    params = (pfloat("freq", 0.0, kind=ParameterKind.FREQUENCY),)

    def batch_key(self):
        return (type(self),)

    def __init__(self, freq: float = 0.0):
        self.pdefaults = {"freq": float(freq)}

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"phase": torch.zeros((), dtype=ctx.dtype, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        freq = params["freq"]
        carry, out = phasor_block(state["phase"], freq,
                                  recip_sample_rate(ctx.sample_rate, freq))
        return {"phase": carry}, out.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        """Chain-kernel body: ``process`` itself (Phasor has no triggers)."""
        from ..kernels.chain_kernel import BODIES

        return BODIES["phasor"], 0
