"""Port of knaster_tpu/ugens/dynamics.py: ``SafetyLimiter`` (reference: knaster_core_dsp/src/ugens/dynamics.rs)."""

from __future__ import annotations

import torch

from ..core.ugen import AudioCtx, UGen


class SafetyLimiter(UGen):
    """Clamps to (-1, 1) and replaces NaN by 0 (dynamics.rs:14 SafetyLimiter),
    in that order: ``torch.clamp`` passes NaN through, as ``jnp.clip`` does,
    and clamps +-inf to +-1."""

    inputs = 1
    outputs = 1
    params = ()

    def batch_key(self):
        return (type(self),)

    def process(self, ctx: AudioCtx, state, inputs, params):
        x = torch.clamp(inputs[..., 0, :], -1.0, 1.0)
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        return state, x.unsqueeze(-2)
