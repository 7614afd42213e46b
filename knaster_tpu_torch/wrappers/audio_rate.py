"""Port of knaster_tpu/wrappers/audio_rate.py (reference: wrappers_core/audio_rate.rs).

``WrArParamToInput`` adds an extra audio *input channel* that drives a named
float parameter sample by sample (audio_rate.rs:92-171). The graph-level
``Graph.connect_param`` covers the same semantics without a wrapper; this
exists for API parity and for driving a parameter from a channel of a
multi-channel source. Inputs are ``[..., inputs, B]``, so leading batch
axes pass through.
"""

from __future__ import annotations

from ..core.ugen import AudioCtx, UGen, normalize_process_result
from .math import WrapUGen


class WrArParamToInput(WrapUGen):
    """Expose a float parameter as the last input channel.

    Example::

        osc = WrArParamToInput(SinWt(440.0), "freq")   # now has 1 input
        lfo.to(g.push(osc))                            # lfo drives freq
    """

    def __init__(self, inner: UGen, param: str):
        super().__init__(inner)
        idx = inner.param_index(param)
        if inner.params[idx].ptype != "float":
            raise TypeError("only float parameters can be audio-rate inputs")
        self.ar_param = inner.params[idx].name
        self.inputs = inner.inputs + 1

    def name(self) -> str:
        return f"WrArParamToInput({self.inner.name()}.{self.ar_param})"

    def process(self, ctx: AudioCtx, state, inputs, params):
        inner_inputs = inputs[..., : self.inner.inputs, :]
        p = dict(params)
        p[self.ar_param] = inputs[..., self.inner.inputs, :]
        return normalize_process_result(
            self.inner.process(ctx, state, inner_inputs, p), ctx
        )
