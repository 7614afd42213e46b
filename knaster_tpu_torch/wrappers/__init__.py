"""Port of knaster_tpu/wrappers: wrapper combinators (reference: knaster_core_dsp wrappers_core/*)."""

from .audio_rate import WrArParamToInput
from .math import (
    WrAdd,
    WrClosure,
    WrDiv,
    WrMul,
    WrPowf,
    WrPowi,
    WrSub,
    WrVDiv,
    WrVSub,
    WrapUGen,
)

__all__ = [
    "WrAdd",
    "WrArParamToInput",
    "WrClosure",
    "WrDiv",
    "WrMul",
    "WrPowf",
    "WrPowi",
    "WrSub",
    "WrVDiv",
    "WrVSub",
    "WrapUGen",
]
