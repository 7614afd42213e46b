"""Port of knaster_tpu/parallel/generic_bank.py: a fused bank for any voice with a kernel body.

A voice opts in by implementing ``kernel_voice(ctx)``, which returns a
:class:`KernelVoiceSpec`: its per-voice scalar carry, a per-sample body
over ``[V]`` tensors in torch (the plain version, run on the CPU), an
``idle_of`` for the idle latch, and the name of its CUDA body in
``csrc/generic_bank.cu``. :class:`FusedVoiceBank` supplies the rest: the
anchored-ramp / burst-breakpoint event machinery, packed trigger words, the
per-sample active mask on every output, the carry across blocks and the
mix. It is the counterpart of ``PallasVoiceBank``; the library voices
(``SineVoice``, ``FMVoice``, ``SubtractiveVoice``, ``AdditiveVoice``) carry
bodies that are the math of the hand-written banks' kernels, and
``EnvelopeVoice`` and ``ModalVoice`` (up to 16 modes on the card) bodies of
their own. In a graph the bank is a node like any other (its superblocks
capped at 1024 samples) under per-voice handles and ``VoicePool``.

On CUDA tensors a voice whose ``cuda_body`` is None (or unknown to the
harness) raises a ``ValueError`` that names it; on CPU tensors the torch
body runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.ugen import AudioCtx
from ..kernels import generic_bank as gk
from .fused_bank import FusedBank


@dataclass
class KernelVoiceSpec:
    """What a voice's ``kernel_voice(ctx)`` returns.

    carry: ordered {name: ("u32" | "f32", initial value)}: per-voice scalar
        state, one 32-bit word per voice and name. u32 carries live in bank
        state as their int32 bit pattern and reach the torch body as int64
        in [0, 2^32) (add with ``u32_add``).
    body: ``body(i_f, carry, P, T) -> (carry', outs)``: ONE sample for every
        voice. ``carry`` is {name: [V]}; ``P[name]`` is float param
        ``name`` at this sample; ``T[name]`` is the trigger's bool [V] in
        eventful blocks and None in event-free ones. ``outs`` is a tuple of
        ``voice.outputs`` [V] rows; the harness multiplies each by the
        active gain and mixes the bank.
    idle_of: optional ``carry -> bool [V]`` on the block's final carry (the
        VoicePool idle latch).
    cuda_body: the CUDA body's name in ``kernels.generic_bank.BODIES``, or
        None for a voice that runs on the CPU only.
    consts: f32 [n] body constants the CUDA body reads.
    voice_name: for error messages.
    """

    carry: Dict[str, Tuple[str, float]]
    body: Callable
    idle_of: Optional[Callable] = None
    cuda_body: Optional[str] = None
    consts: np.ndarray = None
    voice_name: str = "voice"
    # the kernel parameter's host image (kernels.generic_bank.const_image)
    _cuda_image: Optional[np.ndarray] = field(default=None, init=False, repr=False,
                                              compare=False)


class FusedVoiceBank(FusedBank):
    """Fused-kernel bank for any voice implementing ``kernel_voice``.

    Restrictions, checked at construction: float and trigger params only,
    block-invariant voices."""

    def __init__(self, voice, n_voices: int, voice_defaults=None,
                 event_capacity: int = 256, kernel_burst_depth: int = 3):
        if not hasattr(voice, "kernel_voice"):
            raise ValueError(
                f"{type(voice).__name__} has no kernel_voice body: it cannot "
                "run in a FusedVoiceBank")
        if any(p.ptype in ("integer", "bool") for p in voice.params):
            names = [p.name for p in voice.params if p.ptype in ("integer", "bool")]
            raise ValueError(
                "FusedVoiceBank supports float + trigger params only; "
                f"{voice.name()} has integer params {names}")
        if not getattr(voice, "block_invariant", True):
            raise ValueError(
                "FusedVoiceBank needs a block-invariant voice (per-sample "
                "bodies are by construction; this voice declares otherwise)")
        super().__init__(voice, n_voices, voice_defaults=voice_defaults,
                         event_capacity=event_capacity,
                         kernel_burst_depth=kernel_burst_depth)
        self._specs = {}  # (sample rate, dtype) -> KernelVoiceSpec
        self._consts = {}  # (sample rate, device) -> f32 [n] tensor

    def name(self):
        return f"FusedVoiceBank[{self.n_voices}x{self.voice.name()}]"

    def spec(self, ctx: AudioCtx) -> KernelVoiceSpec:
        key = (ctx.sample_rate, ctx.dtype)
        if key not in self._specs:
            self._specs[key] = self.voice.kernel_voice(ctx)
        return self._specs[key]

    def init(self, ctx: AudioCtx, device):
        base = super().init(ctx, device)
        for name, (kind, value) in self.spec(ctx).carry.items():
            if name in base:
                raise ValueError(f"carry name {name!r} collides with bank state")
            if kind == "u32":
                bits = np.full((self.n_voices,), value, np.uint32).view(np.int32)
                base[name] = torch.from_numpy(bits).to(device)
            else:
                base[name] = torch.full((self.n_voices,), value, dtype=ctx.dtype,
                                        device=device)
        return base

    def kernel_operands(self, ctx: AudioCtx, state, events=None):
        """Stage one block. Returns (operands, carry): the keyword arguments
        of ``kernels.generic_bank.generic_bank`` and what ``finish``
        needs."""
        spec = self.spec(ctx)
        dev = state["fvals"].device
        if dev.type == "cuda" and spec.cuda_body not in gk.BODIES:
            raise ValueError(
                f"{self.voice.name()} has no CUDA body for FusedVoiceBank "
                f"(cuda_body={spec.cuda_body!r}): its bank runs on CPU "
                "tensors only")
        ramps, rounds, act, words, carry = self.stage_block(ctx, state, events)
        key = (ctx.sample_rate, dev)
        if key not in self._consts:
            consts = np.zeros(0, np.float32) if spec.consts is None else spec.consts
            self._consts[key] = torch.from_numpy(
                np.ascontiguousarray(consts, np.float32)).to(dev)
        packed = torch.stack([state[name].view(torch.int32) for name in spec.carry])
        operands = dict(
            spec=spec, float_names=tuple(self._float_names),
            trig_names=tuple(self._trig_names), n_out=self.voice.outputs,
            ramps=ramps, rounds=rounds, act=act, words=words, carry=packed,
            consts=self._consts[key], block_size=ctx.block_size)
        return operands, (carry, spec)

    def kernel(self, **operands):
        return gk.generic_bank(**operands)

    def finish(self, ctx: AudioCtx, carry, kernel_out):
        """The block's new state and [C, B] mix from the staging ``carry``
        and the kernel's (mix, packed carry)."""
        carry, spec = carry
        mix, packed = kernel_out
        new = {}
        for k, (name, (kind, _)) in enumerate(spec.carry.items()):
            new[name] = packed[k] if kind == "u32" else packed[k].view(torch.float32)
        idle = carry[3]
        if spec.idle_of is not None:
            idle = idle | spec.idle_of(new)
        state = self.finish_ramps(ctx, carry, idle)
        state.update(new)
        return state, mix
