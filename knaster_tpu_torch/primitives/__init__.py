"""Port of knaster_tpu/primitives: float policy and parameter types."""

from .floats import default_dtype, enable_f64, set_default_dtype
from .params import (
    NYQUIST,
    FloatHint,
    IntegerHint,
    Nyquist,
    Param,
    ParameterKind,
    pbool,
    pfloat,
    pinteger,
    ptrigger,
)

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
    "pbool",
    "pfloat",
    "pinteger",
    "ptrigger",
]
