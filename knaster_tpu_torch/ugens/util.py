"""Port of knaster_tpu/ugens/util.py: ``Constant`` (reference util.rs:37-67)."""

from __future__ import annotations

from ..core.ugen import AudioCtx, UGen
from ..primitives.params import pfloat


class Constant(UGen):
    """Emits a constant value; its ``value`` param is the target of
    audio-rate modulation in graph arithmetic (reference util.rs:37-67)."""

    inputs = 0
    outputs = 1
    params = (pfloat("value"),)

    def batch_key(self):
        return (type(self),)

    def __init__(self, value: float = 0.0):
        self.pdefaults = {"value": float(value)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        return state, params["value"].unsqueeze(-2).to(ctx.dtype)

    def kernel_stage(self, ctx: AudioCtx):
        from ..kernels.chain_kernel import BODIES

        return BODIES["constant"], 0
