"""Port of knaster_tpu/ugens/util.py: ``Constant`` (reference util.rs:37-67), ``DoneOnTrig`` and ``LogProbe``."""

from __future__ import annotations

import torch

from ..core.ugen import AudioCtx, UGen
from ..primitives.params import pfloat, ptrigger


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


class DoneOnTrig(UGen):
    """Sets the done flag when it receives a trigger (reference util.rs:8-34).

    Use with ``Graph.push_with_done_action`` and a ``Done`` action that frees
    more than the current node. As in the JAX package, done is marked from
    the trigger's frame on (the reference's one-sample latency collapsed,
    since triggers are sample-stamped), and in every later block."""

    may_set_done = True

    inputs = 0
    outputs = 0
    params = (ptrigger("t_done"),)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"triggered": torch.zeros((), dtype=torch.bool, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        trig = params["t_done"]
        fired = state["triggered"]
        done = trig | fired.unsqueeze(-1)
        new_state = {"triggered": fired | trig.any(dim=-1)}
        out = torch.zeros(trig.shape[:-1] + (0, ctx.block_size), dtype=ctx.dtype,
                          device=trig.device)
        return new_state, out, done


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
