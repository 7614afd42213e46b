"""Port of knaster_tpu/parallel/generic_bank.py: a fused bank for any voice with a kernel body.

A voice opts in by implementing ``kernel_voice(ctx)``, which returns a
:class:`KernelVoiceSpec`: its per-voice scalar carry, a per-sample body
over ``[V]`` tensors in torch (the plain version, run on the CPU), an
``idle_of`` for the idle latch, and its CUDA body by one of three routes:
the name of a library body in ``csrc/generic_bank.cu``; CUDA C++ source
that defines the body (``cuda_source``); or neither, and the torch body is
lowered to such a source (``kernels/lower.py``, as ``PallasVoiceBank``
traces a ``mosaic_voice`` body into its kernel). The last two are built
against the harness into a library of their own at the first launch on the
card.
:class:`FusedVoiceBank` supplies the rest: the
anchored-ramp / burst-breakpoint event machinery, packed trigger words, the
per-sample active mask on every output, the carry across blocks and the
mix. It is the counterpart of ``PallasVoiceBank``; the library voices
(``SineVoice``, ``FMVoice``, ``SubtractiveVoice``, ``AdditiveVoice``) carry
bodies that are the math of the hand-written banks' kernels, and
``EnvelopeVoice`` and ``ModalVoice`` (a library body up to 16 modes, the
lowered torch body past) bodies of their own. In a graph the bank is a node
like any other (its superblocks capped at 1024 samples) under per-voice
handles and ``VoicePool``.

On CUDA tensors a voice whose torch body the lowering refuses raises a
``ValueError`` that names it and the op at the first launch, and a build
that fails raises with nvcc's output; on CPU tensors the torch body runs.
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
        None.
    cuda_source: CUDA C++ source that defines ``struct VoiceBody`` in the
        harness's body contract (``csrc/generic_harness.cuh``: ``NF``,
        ``NT``, ``NC``, ``C``, ``kPan``, a ``Consts`` struct of floats read
        from ``consts``, ``step``, and the hoist, table, register and pan
        policies by deriving ``NoHoist``, ``NoTable``, ``FourCtas``,
        ``ExactPan`` or ``PolyPan``), or None. It may call
        ``csrc/bank_common.cuh``'s helpers (``sin_quant``, ``to_inc``,
        ``env_ar``, ``env_asr``, ``sin_poly``). Its counts are checked
        against the voice before the first launch. A voice with neither
        ``cuda_body`` nor ``cuda_source`` has ``body`` lowered to such a
        source at its first launch on the card (``kernels/lower.py``: the
        elementwise ops on ``[V]`` values that it lists; anything else is
        refused by name); one with both is refused.
    consts: f32 [n] body constants the CUDA body reads.
    voice_name: for error messages.
    """

    carry: Dict[str, Tuple[str, float]]
    body: Callable
    idle_of: Optional[Callable] = None
    cuda_body: Optional[str] = None
    consts: np.ndarray = None
    voice_name: str = "voice"
    cuda_source: Optional[str] = None
    # the kernel parameter's host image (kernels.generic_bank.const_image)
    _cuda_image: Optional[np.ndarray] = field(default=None, init=False, repr=False,
                                              compare=False)
    # a user body's loaded library and its (NF, NT, NC, C)
    # (kernels.generic_bank.user_body)
    _cuda_lib: Optional[tuple] = field(default=None, init=False, repr=False,
                                       compare=False)
    # the torch body lowered to CUDA (kernels.generic_bank.lowered)
    _lowered: Optional[object] = field(default=None, init=False, repr=False,
                                       compare=False)

    def __post_init__(self):
        if self.cuda_body is not None and self.cuda_source is not None:
            raise ValueError(
                f"{self.voice_name}: a KernelVoiceSpec takes cuda_body (a library "
                "body) or cuda_source (its own body), not both")


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

    def make_local(self, n_local: int) -> "FusedVoiceBank":
        """One mesh shard's bank: the same voice, event capacity and burst
        depth. It shares this bank's ``KernelVoiceSpec``s, so a CUDA body
        built from a user source or lowered from the torch body is built
        once for every shard."""
        local = FusedVoiceBank(self.voice, n_local, event_capacity=self.event_capacity,
                               kernel_burst_depth=self.kernel_burst_depth)
        local._specs = self._specs
        return local

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
