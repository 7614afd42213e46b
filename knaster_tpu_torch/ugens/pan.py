"""Port of knaster_tpu/ugens/pan.py: ``Pan2`` (reference pan.rs)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen
from ..primitives.params import pfloat


def pan2_block(x, pan):
    """The cos/sin equal-power pan of ``[..., B]`` rows: (left, right)."""
    angle = (pan * 0.5 + 0.5) * (np.pi / 2.0)
    return x * torch.cos(angle), x * torch.sin(angle)


class Pan2(UGen):
    """Mono to stereo, cos/sin equal-power pan law (pan.rs:12-40 Pan2).

    Pan is in (-1, 1), 0 = center. The reference uses fastapprox cos/sin;
    this uses the exact functions, as the JAX package does."""

    inputs = 1
    outputs = 2
    params = (pfloat("pan", 0.0, range=(-1.0, 1.0)),)

    def batch_key(self):
        return (type(self),)

    def __init__(self, pan: float = 0.0):
        self.pdefaults = {"pan": float(pan)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        return state, torch.stack(pan2_block(inputs[..., 0, :], params["pan"]), dim=-2)

    def kernel_stage(self, ctx: AudioCtx):
        from ..kernels.chain_kernel import BODIES

        return BODIES["pan2"], 0
