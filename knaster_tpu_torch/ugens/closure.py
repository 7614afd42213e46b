"""Port of knaster_tpu/ugens/closure.py: ad-hoc UGens from plain functions (reference: ugens/closure.rs UGenClosure).

Any torch function over blocks (or per sample, vmapped over the block's
frames) becomes a UGen: the Python analog of the reference's
closure-to-UGen conversions for arities U1..U8. The function sees ONE
instance, as in the JAX package: where the port passes a batch (a voice
bank's ``[V, ...]`` state and ``[V, B]`` params), ``process`` maps it over
the leading axes with ``torch.func.vmap`` (``core.ugen.per_instance``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.ugen import AudioCtx, UGen, per_instance, tree_to
from ..primitives.params import Param


class ClosureUGen(UGen):
    """UGen from a block function ``fn(ctx, state, inputs, params)``.

    ``fn`` may return ``out``, ``(state, out)`` or ``(state, out, done)``;
    ``inputs`` is ``[inputs, block]``, out must be ``[outputs, block]``.
    ``init_state(ctx)`` builds the state (its tensors are moved to the
    device ``init`` is given)."""

    may_set_done = True

    def __init__(
        self,
        fn: Callable,
        inputs: int = 0,
        outputs: int = 1,
        params: Tuple[Param, ...] = (),
        init_state: Optional[Callable] = None,
        name: str = "Closure",
    ):
        self.fn = fn
        self.inputs = int(inputs)
        self.outputs = int(outputs)
        self.params = tuple(params)
        self._init_state = init_state
        self._name = name

    def name(self) -> str:
        return self._name

    def init(self, ctx: AudioCtx, device="cpu"):
        return tree_to(self._init_state(ctx), device) if self._init_state else {}

    def process(self, ctx: AudioCtx, state, inputs, params):
        def one(st, inp, par):
            result = self.fn(ctx, st, inp, par)
            if isinstance(result, tuple):
                return result
            return st, result

        return per_instance(one, inputs)(state, inputs, params)


def ugen_from_sample_fn(
    fn: Callable,
    inputs: int = 0,
    outputs: int = 1,
    name: str = "SampleClosure",
) -> ClosureUGen:
    """UGen from a per-sample function ``fn(frame [inputs]) -> [outputs]``
    (stateless), ``torch.func.vmap``ped over the block's ``[B, inputs]``
    frames. For stateful per-sample closures use ClosureUGen with
    ``core.ugen.sample_scan``."""

    def block_fn(ctx, state, inp, params):
        if inputs == 0:
            frames = torch.zeros((ctx.block_size, 0), dtype=ctx.dtype, device=inp.device)
        else:
            frames = inp.swapaxes(0, 1)
        out = torch.func.vmap(fn)(frames)  # stateless: vmap IS the sample loop
        return state, out.swapaxes(0, 1)

    return ClosureUGen(block_fn, inputs, outputs, (), None, name)
