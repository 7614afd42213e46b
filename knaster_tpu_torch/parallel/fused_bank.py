"""Port of knaster_tpu/parallel/pallas_bank.py: the fused sine voice bank.

``FusedSineVoiceBank`` renders a bank of SineVoices (table-quantized sine on
a u32 fixed-point phase, EnvAsr envelope, equal-power pan, stereo mix) in
one hand-written kernel per block (``kernels/sine_bank.py``); this module is
the host side around it: event staging, kernel operands and the state carry.

**Sample-accurate control.** Each float param reaches the kernel as its
ANCHORED linear-ramp group (anchor value, step, elapsed, duration, target
per voice; the in-kernel value is ``anchor + step * progress`` in one
rounding, so every block partitioning is bit-identical) plus, in eventful
blocks, ``kernel_burst_depth`` trajectory breakpoints per slot from the
round fold (``VoiceBank._apply_events_breakpoints``). Triggers arrive as
32-bit mask words, ``ceil(B/32)`` per voice; any block size up to
``MAX_BLOCK`` works.

**Layout.** Per-voice tensors are flat ``[V]`` (the JAX package's
``[V/128, 128]`` tiles flattened row-major); V needs no particular multiple.
Phase is carried as the int32 bit pattern of the u32 phase. Ramp groups are
stacked ``[n_float, 5, V]`` in ``_float_names`` order (freq, amp, pan), and
breakpoints ``[n_float, 5, D, V]``.

**Dispatch.** Everything here is plain torch on the state's device; the
kernel wrapper launches the CUDA kernel for CUDA tensors and runs the plain
torch version for CPU tensors (the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ugen import AudioCtx
from ..kernels.sine_bank import _HALF_PI, MAX_BLOCK, sine_bank
from ..models.voices import SineVoice
from ..ugens.wavetable import FRACTIONAL_PART, TABLE_SIZE
from .voicebank import VoiceBank


def _check_block(ctx: AudioCtx, name: str) -> None:
    if ctx.block_size > MAX_BLOCK or ctx.block_size < 1:
        raise ValueError(f"{name} supports 1 <= block_size <= {MAX_BLOCK}")
    if ctx.dtype != torch.float32:
        raise ValueError(
            f"{name} supports ctx.dtype=torch.float32 only (got {ctx.dtype})"
        )


# --------------------------------------------------------------------------
# host-side operand staging
# --------------------------------------------------------------------------

def _ramp_operands(fstate, dtype):
    """[n_float, 5, V] anchored ramp groups (v0, step, el, dur, tgt) in
    ``_float_names`` order. ``el``/``dur`` are cast to the compute dtype so
    the in-kernel progress add and ramp-done comparison are single float
    ops. A fresh tensor: staging may edit it in place."""
    fvals, ftgt, fstep, fel, fdur, _ = fstate
    return torch.stack([fvals, fstep, fel.to(dtype), fdur.to(dtype), ftgt],
                       dim=1)


def _ramp_operands_bursts(pieces, dtype):
    """[n_float, 5, D, V] breakpoint groups (v0, step, dur, tgt, frame)
    from ``_apply_events_breakpoints``; ``dur``/``frame`` in the compute
    dtype."""
    bv0, bstep, bdur, btgt, bframe = pieces  # each [D, n_float, V]
    stacked = torch.stack([bv0, bstep, bdur.to(dtype), btgt,
                           bframe.to(dtype)])  # [5, D, n_float, V]
    return stacked.permute(2, 0, 1, 3).contiguous()


def _fold_act(bank, ramps, act):
    """Event-free blocks fold the block-constant active gain into the amp
    ramp group: ``act`` is exactly 0 or 1, so scaling (v0, step, tgt) —
    never ``el``/``dur`` — makes the materialized amp equal ``amp * act``
    bit-exactly. In place on the staged ``ramps``."""
    amp = ramps[bank.float_index("amp")]
    for j in (0, 1, 4):
        amp[j].mul_(act)


def _pan_fast_operands(bank, fstate, dtype):
    """Event-free pan pack [5, V]: the pan ramp is linear, so its
    equal-power angle is linear too and the kernel evaluates cos/sin of
    the per-sample angle with its own odd polynomial until the ramp ends,
    then the exact target gains. Rows: angle at sample 0,
    d(angle)/d(sample), the post-ramp target gains (host cos/sin), and the
    ramp's remaining length."""
    i = bank.float_index("pan")
    fvals, ftgt, fstep, fel, fdur, _ = fstate
    v0 = torch.where(fel[i] >= fdur[i], ftgt[i],
                     fvals[i] + fstep[i] * fel[i].to(dtype))
    a0 = (v0 * 0.5 + 0.5) * _HALF_PI
    da = fstep[i] * np.float32(np.pi / 4.0)  # d(angle)/d(sample)
    at = (ftgt[i] * 0.5 + 0.5) * _HALF_PI
    return torch.stack([a0, da, torch.cos(at), torch.sin(at),
                        (fdur[i] - fel[i]).to(dtype)])


class FusedSineVoiceBank(VoiceBank):
    """A bank of SineVoices rendered by one fused kernel per block.

    Use: ``state = bank.init(ctx, device=...)``, then per block
    ``state, out = bank.process(ctx, state, events=...)`` with ``events``
    from ``node_events_from_lists`` (or None for an event-free block);
    ``out`` is the [2, B] stereo mix."""

    # same-block bursts are exact up to this many events per (param, voice)
    # slot; deeper bursts keep their last kernel_burst_depth events and the
    # bank warns once
    kernel_burst_depth = 3

    def __init__(self, n_voices: int, voice_defaults=None, event_capacity=256,
                 attack: float = 0.01, release: float = 0.1,
                 kernel_burst_depth: int = 3):
        super().__init__(
            SineVoice(attack=attack, release=release),
            n_voices,
            voice_defaults=voice_defaults,
            event_capacity=event_capacity,
        )
        if int(kernel_burst_depth) < 1:
            raise ValueError("kernel_burst_depth must be >= 1")
        self.kernel_burst_depth = int(kernel_burst_depth)
        self._attack = float(attack)
        self._release = float(release)

    def name(self):
        return f"FusedSineBank[{self.n_voices}]"

    def init(self, ctx: AudioCtx, device):
        _check_block(ctx, "FusedSineVoiceBank")
        base = super().init(ctx, device)
        V = self.n_voices
        base["phase"] = torch.zeros((V,), dtype=torch.int32, device=device)
        base["stage"] = torch.zeros((V,), dtype=ctx.dtype, device=device)
        base["t"] = torch.zeros((V,), dtype=ctx.dtype, device=device)
        base["rscale"] = torch.ones((V,), dtype=ctx.dtype, device=device)
        return base

    def kernel_operands(self, ctx: AudioCtx, state, events=None):
        """Stage one block: apply the event channel and build the kernel's
        operands. Returns (operands, carry): ``operands`` are the keyword
        arguments of ``kernels.sine_bank.sine_bank``; ``carry`` is what
        ``finish`` needs besides the kernel's outputs."""
        _check_block(ctx, "FusedSineVoiceBank")
        dtype = ctx.dtype
        if events is None:
            # event-free block: fold active into amp, swap pan's ramp group
            # for the linear-angle pack, no breakpoints or trigger words
            fstate, ivals, active, idle = self._apply_events(state)
            ramps = _ramp_operands(fstate, dtype)
            act = active.to(dtype)
            _fold_act(self, ramps, act)
            ramps[self.float_index("pan")] = _pan_fast_operands(
                self, fstate, dtype)
            rounds = act = words = None
        else:
            events = self._events_to(events, state["fvals"].device)
            fstate, pieces, ivals, active, idle = \
                self._apply_events_breakpoints(ctx, state, events)
            ramps = _ramp_operands(
                (state["fvals"], state["ftarget"], state["fstep"],
                 state["felapsed"], state["fdur"], state["fsdur"]), dtype)
            rounds = _ramp_operands_bursts(pieces, dtype)
            act = active.to(dtype)
            words = torch.stack([
                self._packed_trigs(ctx, events, self.trig_index("t_restart")),
                self._packed_trigs(ctx, events, self.trig_index("t_release")),
            ])
        operands = dict(
            ramps=ramps, rounds=rounds, act=act, words=words,
            phase=state["phase"], stage=state["stage"], t=state["t"],
            rscale=state["rscale"], block_size=ctx.block_size,
            atk=float(np.float32(
                1.0 / max(self._attack * ctx.sample_rate, 1.0))),
            rel=float(np.float32(
                1.0 / max(self._release * ctx.sample_rate, 1.0))),
            f2pi=float(np.float32(
                TABLE_SIZE * FRACTIONAL_PART / ctx.sample_rate)),
        )
        return operands, (fstate, ivals, active, idle)

    def finish(self, ctx: AudioCtx, carry, kernel_out):
        """The block's new state and [2, B] mix from the staging ``carry``
        and the kernel's (mix, phase, stage, t, rscale)."""
        fstate, ivals, active, idle = carry
        mix, phase, stage, t, rscale = kernel_out
        fvals, ftarget, fstep, felapsed, fdur, fsdur = self._advance_ramps(
            fstate, ctx.block_size)
        new_state = {
            "fvals": fvals, "ftarget": ftarget, "fstep": fstep,
            "felapsed": felapsed, "fdur": fdur, "fsdur": fsdur,
            "ivals": ivals, "active": active,
            "idle": idle | (stage == 0),
            "phase": phase, "stage": stage, "t": t, "rscale": rscale,
        }
        return new_state, mix

    def process(self, ctx: AudioCtx, state, inputs=None, params=None,
                events=None):
        """Render one block: (new_state, [2, B] mix). ``inputs`` and
        ``params`` are unused (a bank is controlled by its events); they
        keep the UGen call shape."""
        operands, carry = self.kernel_operands(ctx, state, events)
        return self.finish(ctx, carry, sine_bank(**operands))
