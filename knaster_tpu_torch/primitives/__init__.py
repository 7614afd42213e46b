"""Port of knaster_tpu/primitives: float policy, parameter types and time."""

from .floats import default_dtype, enable_f64, set_default_dtype
from .params import (
    NYQUIST,
    FloatHint,
    IntegerHint,
    Nyquist,
    Param,
    ParameterKind,
    Smoothing,
    pbool,
    pfloat,
    pinteger,
    ptrigger,
)
from .time import Beats, Seconds

__all__ = [
    "default_dtype",
    "enable_f64",
    "set_default_dtype",
    "NYQUIST",
    "FloatHint",
    "IntegerHint",
    "Nyquist",
    "Param",
    "ParameterKind",
    "Smoothing",
    "Beats",
    "Seconds",
    "pbool",
    "pfloat",
    "pinteger",
    "ptrigger",
]
