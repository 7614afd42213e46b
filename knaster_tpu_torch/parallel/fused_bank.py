"""Port of knaster_tpu/parallel/pallas_bank.py: the fused voice banks.

Each bank renders ``n_voices`` copies of one voice in one hand-written
kernel per block; this module is the host side around the kernels: event
staging, kernel operands and the state carry.

* ``FusedSineVoiceBank`` — SineVoice, ``kernels/sine_bank.py``;
* ``FusedFMVoiceBank`` — FMVoice, ``kernels/fm_bank.py``;
* ``FusedSubtractiveVoiceBank`` — SubtractiveVoice, ``kernels/sub_bank.py``;
* ``FusedWavetableVoiceBank`` — AdditiveVoice, ``kernels/wt_bank.py``.

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
u32 phases are carried as their int32 bit pattern. Ramp groups are stacked
``[n_float, 5, V]`` in ``_float_names`` order, breakpoints
``[n_float, 5, D, V]`` and trigger words ``[n_trig, W, V]``.

**Dispatch.** Everything here is plain torch on the state's device; the
kernel wrappers launch the CUDA kernels for CUDA tensors and run their
plain torch versions for CPU tensors (the tests).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ugen import AudioCtx
from ..kernels import fm_bank, sine_bank, sub_bank, wt_bank
from ..kernels import bank_common as bc
from ..kernels.bank_common import MAX_BLOCK
from ..models.voices import AdditiveVoice, FMVoice, SineVoice, SubtractiveVoice
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


class FusedBank(VoiceBank):
    """What every fused kernel bank shares, the counterpart of
    ``pallas_bank._bank_setup``: the event-free path (the carried ramp
    state as it is) or the breakpoint round fold with act and trigger
    words, then the ramp advance after the kernel.

    Use: ``state = bank.init(ctx, device=...)``, then per block
    ``state, out = bank.process(ctx, state, events=...)`` with ``events``
    from ``node_events_from_lists`` (or None for an event-free block);
    ``out`` is the [voice.outputs, B] mix."""

    # same-block bursts are exact up to this many events per (param, voice)
    # slot; deeper bursts keep their last kernel_burst_depth events and the
    # bank warns once
    kernel_burst_depth = 3
    # in a graph, the longest superblock a bank renders: the kernels' block
    # limit (the JAX package's PallasVoiceBank.superblock_cap)
    superblock_cap = MAX_BLOCK

    def __init__(self, voice, n_voices: int, voice_defaults=None,
                 event_capacity=256, kernel_burst_depth: int = 3):
        super().__init__(voice, n_voices, voice_defaults=voice_defaults,
                         event_capacity=event_capacity)
        if int(kernel_burst_depth) < 1:
            raise ValueError("kernel_burst_depth must be >= 1")
        self.kernel_burst_depth = int(kernel_burst_depth)

    def init(self, ctx: AudioCtx, device):
        _check_block(ctx, type(self).__name__)
        return super().init(ctx, device)

    def stage_block(self, ctx: AudioCtx, state, events=None):
        """Apply the event channel and build the operands every kernel
        takes. Returns (ramps, rounds, act, words, carry): ``rounds`` and
        ``words`` are None for an event-free block; ``act`` is the f32 0/1
        active gain; ``carry`` is what ``finish_ramps`` needs."""
        _check_block(ctx, type(self).__name__)
        dtype = ctx.dtype
        if events is None:
            fstate, ivals, active, idle = self._apply_events(state)
            ramps = _ramp_operands(fstate, dtype)
            rounds = words = None
        else:
            events = self._events_to(events, state["fvals"].device)
            fstate, pieces, ivals, active, idle = \
                self._apply_events_breakpoints(ctx, state, events)
            ramps = _ramp_operands(
                (state["fvals"], state["ftarget"], state["fstep"],
                 state["felapsed"], state["fdur"], state["fsdur"]), dtype)
            rounds = _ramp_operands_bursts(pieces, dtype)
            words = torch.stack([self._packed_trigs(ctx, events, k)
                                 for k in range(len(self._trig_names))])
        return ramps, rounds, active.to(dtype), words, (fstate, ivals, active, idle)

    def finish_ramps(self, ctx: AudioCtx, carry, idle):
        """The ramp and flag part of the block's new state; ``idle`` is the
        new idle latch."""
        fstate, ivals, active, _ = carry
        fvals, ftarget, fstep, felapsed, fdur, fsdur = self._advance_ramps(
            fstate, ctx.block_size)
        return {
            "fvals": fvals, "ftarget": ftarget, "fstep": fstep,
            "felapsed": felapsed, "fdur": fdur, "fsdur": fsdur,
            "ivals": ivals, "active": active, "idle": idle,
        }

    def process(self, ctx: AudioCtx, state, inputs=None, params=None,
                events=None):
        """Render one block: (new_state, [C, B] mix). ``inputs`` and
        ``params`` are unused (a bank is controlled by its events); they
        keep the UGen call shape."""
        operands, carry = self.kernel_operands(ctx, state, events)
        return self.finish(ctx, carry, self.kernel(**operands))


class _HandBank(FusedBank):
    """A bank whose voice has a hand-written kernel: the kernel's state is
    ``STATE`` (name, "u32" | "f32", initial value) in the kernel's order.
    With ``HOST_STAGING`` event-free blocks fold act into amp on the host
    (and, with ``PAN_PACK``, swap pan's ramp group for the linear-angle
    pack) and pass no act; without it the kernel takes the raw ramp groups
    and act in every block and stages them itself."""

    STATE = ()
    HOST_STAGING = True
    PAN_PACK = False
    kernel = None  # the kernel wrapper (staticmethod in subclasses)

    def __init__(self, voice, n_voices, voice_defaults, event_capacity,
                 kernel_burst_depth):
        super().__init__(voice, n_voices, voice_defaults=voice_defaults,
                         event_capacity=event_capacity,
                         kernel_burst_depth=kernel_burst_depth)
        self._attack = voice.attack
        self._release = voice.release

    def init(self, ctx: AudioCtx, device):
        base = super().init(ctx, device)
        V = self.n_voices
        for name, kind, value in self.STATE:
            dtype = torch.int32 if kind == "u32" else ctx.dtype
            base[name] = torch.full((V,), value, dtype=dtype, device=device)
        return base

    def scalars(self, ctx: AudioCtx):
        """The kernel's float arguments besides the tensors."""
        return dict(
            atk=float(np.float32(1.0 / max(self._attack * ctx.sample_rate, 1.0))),
            rel=float(np.float32(1.0 / max(self._release * ctx.sample_rate, 1.0))),
            f2pi=float(np.float32(TABLE_SIZE * FRACTIONAL_PART / ctx.sample_rate)),
        )

    def kernel_operands(self, ctx: AudioCtx, state, events=None):
        """Stage one block: apply the event channel and build the kernel's
        operands. Returns (operands, carry): ``operands`` are the keyword
        arguments of the bank's kernel wrapper; ``carry`` is what
        ``finish`` needs besides the kernel's outputs."""
        ramps, rounds, act, words, carry = self.stage_block(ctx, state, events)
        if rounds is None and self.HOST_STAGING:
            # event-free block: fold active into amp (and swap pan's ramp
            # group for the linear-angle pack); no act or trigger words
            bc.fold_act(ramps[self.float_index("amp")], act)
            if self.PAN_PACK:
                pan = self.float_index("pan")
                ramps[pan] = bc.pan_pack(ramps[pan])
            act = None
        operands = dict(ramps=ramps, rounds=rounds, act=act, words=words,
                        block_size=ctx.block_size, **self.scalars(ctx))
        for name, _, _ in self.STATE:
            operands[name] = state[name]
        return operands, carry

    def finish(self, ctx: AudioCtx, carry, kernel_out):
        """The block's new state and mix from the staging ``carry`` and the
        kernel's (mix, *state in ``STATE`` order)."""
        mix, *kstate = kernel_out
        new = dict(zip((name for name, _, _ in self.STATE), kstate))
        state = self.finish_ramps(ctx, carry, carry[3] | (new["stage"] == 0))
        state.update(new)
        return state, mix


class FusedSineVoiceBank(_HandBank):
    """A bank of SineVoices (table-quantized sine on a u32 phase, EnvAsr,
    equal-power pan, stereo mix) in one fused kernel per block."""

    STATE = (("phase", "u32", 0), ("stage", "f32", 0.0), ("t", "f32", 0.0),
             ("rscale", "f32", 1.0))
    HOST_STAGING = False  # the kernel folds act and packs pan itself
    kernel = staticmethod(sine_bank.sine_bank)

    def __init__(self, n_voices: int, voice_defaults=None, event_capacity=256,
                 attack: float = 0.01, release: float = 0.1,
                 kernel_burst_depth: int = 3):
        super().__init__(SineVoice(attack=attack, release=release), n_voices,
                         voice_defaults, event_capacity, kernel_burst_depth)

    def name(self):
        return f"FusedSineBank[{self.n_voices}]"


class FusedFMVoiceBank(_HandBank):
    """A bank of FMVoices (modulator and carrier u32 phases, audio-rate FM,
    EnvAr, mono mix) in one fused kernel per block."""

    STATE = (("phm", "u32", 0), ("phc", "u32", 0), ("stage", "f32", 0.0),
             ("t", "f32", 0.0))
    kernel = staticmethod(fm_bank.fm_bank)

    def __init__(self, n_voices: int, voice_defaults=None, event_capacity=256,
                 attack: float = 0.005, release: float = 0.3,
                 kernel_burst_depth: int = 3):
        super().__init__(FMVoice(attack=attack, release=release), n_voices,
                         voice_defaults, event_capacity, kernel_burst_depth)

    def name(self):
        return f"FusedFMBank[{self.n_voices}]"


class FusedSubtractiveVoiceBank(_HandBank):
    """A bank of SubtractiveVoices (polyBLEP saw, per-sample SVF lowpass,
    EnvAsr, mono mix) in one fused kernel per block. As in the JAX
    package, the saw has no > sr/4 sine fallback: keep fundamentals below
    sr/4."""

    STATE = (("t", "f32", 0.0), ("ic1", "f32", 0.0), ("ic2", "f32", 0.0),
             ("stage", "f32", 0.0), ("et", "f32", 0.0), ("rscale", "f32", 1.0))
    HOST_STAGING = False  # the kernel folds act itself
    kernel = staticmethod(sub_bank.sub_bank)

    def __init__(self, n_voices: int, voice_defaults=None, event_capacity=256,
                 attack: float = 0.01, release: float = 0.2,
                 kernel_burst_depth: int = 3):
        super().__init__(SubtractiveVoice(attack=attack, release=release),
                         n_voices, voice_defaults, event_capacity,
                         kernel_burst_depth)

    def name(self):
        return f"FusedSubtractiveBank[{self.n_voices}]"

    def scalars(self, ctx: AudioCtx):
        base = super().scalars(ctx)
        inv_sr = np.float32(1.0 / ctx.sample_rate)
        return dict(atk=base["atk"], rel=base["rel"], inv_sr=float(inv_sr),
                    pi_inv_sr=float(np.float32(np.pi) * inv_sr))


class FusedWavetableVoiceBank(_HandBank):
    """A bank of AdditiveVoices: arbitrary band-limited wavetables (OscWt's
    role) re-synthesized from ``n_harmonics`` partials with per-sample
    anti-aliasing, EnvAsr, equal-power pan, stereo mix, in one fused kernel
    per block. Pass ``table`` (one cycle) or ``harmonics`` (mags, or (mags,
    u32 offsets)). Cost scales linearly with ``n_harmonics``."""

    STATE = (("phase", "u32", 0), ("stage", "f32", 0.0), ("t", "f32", 0.0),
             ("rscale", "f32", 1.0))
    PAN_PACK = True
    kernel = staticmethod(wt_bank.wt_bank)

    def __init__(self, n_voices: int, table=None, harmonics=None,
                 n_harmonics: int = 16, voice_defaults=None,
                 event_capacity=256, attack: float = 0.01,
                 release: float = 0.1, kernel_burst_depth: int = 3):
        voice = AdditiveVoice(table=table, harmonics=harmonics,
                              n_harmonics=n_harmonics, attack=attack,
                              release=release)
        super().__init__(voice, n_voices, voice_defaults, event_capacity,
                         kernel_burst_depth)
        self.mags = voice.mags
        self.offsets = voice.offsets
        self._coefs = {}  # (sample rate, device) -> (f32 [3, H], host image)

    def name(self):
        return f"FusedWavetableBank[{self.n_voices}x{len(self.mags)}h]"

    def kernel_operands(self, ctx: AudioCtx, state, events=None):
        operands, carry = super().kernel_operands(ctx, state, events)
        dev = state["phase"].device
        key = (ctx.sample_rate, dev)
        if key not in self._coefs:
            coefs = wt_bank.wt_coefs(self.mags, self.offsets, ctx.sample_rate)
            image = wt_bank.coef_image(coefs) if dev.type == "cuda" else None
            self._coefs[key] = (torch.from_numpy(coefs).to(dev), image)
        operands["coefs"], operands["image"] = self._coefs[key]
        return operands, carry
