"""Port of knaster_tpu/ugens/util.py: ``Constant`` (reference util.rs:37-67) and ``LogProbe``."""

from __future__ import annotations

import torch

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


class LogProbe(UGen):
    """Taps a signal's value into the probe log every N samples (reference
    util.rs:70-95 LogProbe + rt_log): the first tapped sample of a block is
    kept in the state, which the host drains (``core.log.collect_probes``,
    ``AudioProcessor.probe_log``)."""

    inputs = 1
    outputs = 0
    params = ()

    def __init__(self, name: str = "probe", samples_between_logs: int | None = None):
        self.probe_name = name
        self.samples_between_logs = samples_between_logs

    def init(self, ctx: AudioCtx, device="cpu"):
        n = self.samples_between_logs or ctx.sample_rate
        return {
            "counter": torch.zeros((), dtype=torch.int32, device=device),
            "period": torch.tensor(n, dtype=torch.int32, device=device),
            "last_value": torch.zeros((), dtype=ctx.dtype, device=device),
            "fired": torch.zeros((), dtype=torch.bool, device=device),
        }

    def process(self, ctx: AudioCtx, state, inputs, params):
        B = ctx.block_size
        period, c0 = state["period"], state["counter"]
        t = torch.arange(B, dtype=torch.int32, device=c0.device)
        fires = (c0 + t) % period == 0
        any_fire = fires.any()
        first = fires.to(torch.int8).argmax()
        new_state = {
            "counter": (c0 + B) % period,
            "period": period,
            "last_value": torch.where(any_fire, inputs[0][first], state["last_value"]),
            "fired": any_fire,
        }
        return new_state, torch.zeros((0, B), dtype=ctx.dtype, device=c0.device)
