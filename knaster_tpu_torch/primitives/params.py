"""Port of knaster_tpu/primitives/params.py: parameter value types, kinds and hints.

Framework-free (no torch either): the declarations are the same as the JAX
package's (reference: knaster_primitives/src/parameters.rs,
knaster_core/src/parameters.rs and knaster_core/src/parameters/types.rs:10-36).

Four parameter types exist, exactly as in the reference:
  * ``float``   — continuous value (PFloat); f32 on the device.
  * ``trigger`` — momentary event; sample-accurate trigger bits.
  * ``integer`` — stepped value (enum selectors etc.); i32.
  * ``bool``    — stepped on/off; i32 (0/1).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional, Tuple


class ParameterKind(enum.Enum):
    """Semantic hint for a float parameter (GUI/unit hint).

    reference: knaster_primitives/src/parameters.rs:45 (FloatParameterKind).
    """

    GENERIC = "generic"
    AMPLITUDE = "amplitude"
    FREQUENCY = "frequency"
    Q = "q"
    SECONDS = "seconds"


class Nyquist:
    """Sentinel for 'range ends at the Nyquist frequency'.

    reference: knaster_primitives/src/parameters.rs:10 (FloatParameterRange::Nyquist).
    """

    def __repr__(self):
        return "Nyquist"


NYQUIST = Nyquist()


@dataclass(frozen=True)
class FloatHint:
    """GUI/validation hints for a float parameter.

    reference: knaster_core/src/parameters.rs:109-179 (PFloatHint).
    """

    minimum: Optional[float] = None
    maximum: Any = None  # float | Nyquist | None
    default: float = 0.0
    logarithmic: bool = False
    kind: ParameterKind = ParameterKind.GENERIC

    def resolve_max(self, sample_rate: int) -> Optional[float]:
        if isinstance(self.maximum, Nyquist):
            return sample_rate / 2.0
        return self.maximum


@dataclass(frozen=True)
class IntegerHint:
    """Hints for an integer parameter, with optional per-value descriptions.

    reference: knaster_core/src/parameters.rs:190 (PIntegerHint).
    """

    minimum: int = 0
    maximum: int = 2**31 - 1
    default: int = 0
    value_descriptions: Tuple[Tuple[int, str], ...] = ()


@dataclass(frozen=True)
class Param:
    """Declaration of one parameter of a UGen.

    The TPU-native analog of the reference's ``#[param]`` attribute
    (knaster_macros/src/lib.rs:773-779): a UGen declares its parameter table
    as a tuple of ``Param`` in declaration order; the graph compiler assigns
    each (node, param) a global slot in the parameter engine.
    """

    name: str
    ptype: str = "float"  # 'float' | 'trigger' | 'integer' | 'bool'
    default: Any = 0.0
    kind: ParameterKind = ParameterKind.GENERIC
    hint: Any = None
    # Integer params backed by a Python enum (KnasterIntegerParameter parity)
    enum: Any = None
    # Integer params where *every* set event matters, even when the value is
    # unchanged (the reference applies param_apply per event; e.g. Envelope's
    # jump_to_segment re-jumps on a repeated set). The engine materializes a
    # per-sample set-event mask passed to process() as ``<name>_set``.
    retrigger: bool = False

    def __post_init__(self):
        if self.ptype not in ("float", "trigger", "integer", "bool"):
            raise ValueError(f"invalid parameter type {self.ptype!r}")

    def default_value(self) -> Any:
        if self.ptype == "trigger":
            return 0.0
        return self.default


def ptrigger(name: Optional[str] = None) -> Param:
    """Declare a trigger parameter (reference ParameterType::Trigger):
    fired sample-accurately with ``Parameter.trig*``; carries no value."""
    return Param(name, ptype="trigger")


_UNSET = object()


def _shift_name_default(name, default, unset_default):
    """Support the name-omitted @ugen form (``pfloat(440.0, ...)``). A
    numeric first argument is the default — but then a second positional
    default is ambiguous and rejected instead of silently discarded."""
    if name is None or isinstance(name, str):
        return name, (unset_default if default is _UNSET else default)
    if default is not _UNSET:
        raise TypeError(
            "value-first parameter declaration cannot also take a "
            "positional default (got both "
            f"{name!r} and {default!r})"
        )
    return None, name


def pfloat(name=None, default: float = _UNSET,
           kind: ParameterKind = ParameterKind.GENERIC,
           range: Optional[Tuple[Any, Any]] = None,
           logarithmic: Optional[bool] = None,
           hint: Optional[FloatHint] = None) -> Param:
    """Declare a float parameter, optionally with GUI/validation hints
    (``#[param(range = …, logarithmic = …, kind = …)]``,
    knaster_macros/src/lib.rs:773-779 / parameters.rs:109-179).

    ``name`` may be omitted when the declaration is used as a ``@ugen``
    keyword default — ``freq=pfloat(440.0, range=(20, NYQUIST))`` — the
    decorator fills it in from the keyword. FREQUENCY-kind parameters
    default to a logarithmic (0, Nyquist) range (our extension; the
    reference's ``kind = Frequency`` attribute sets only the kind)."""
    name, default = _shift_name_default(name, default, 0.0)
    default = float(default)
    if hint is None:
        if kind == ParameterKind.FREQUENCY and range is None:
            range = (0.0, NYQUIST)
        if logarithmic is None:
            logarithmic = kind == ParameterKind.FREQUENCY
        if range is not None:
            hint = FloatHint(minimum=range[0], maximum=range[1],
                             default=float(default), logarithmic=logarithmic,
                             kind=kind)
        elif logarithmic:
            hint = FloatHint(default=float(default), logarithmic=True,
                             kind=kind)
    return Param(name, ptype="float", default=float(default), kind=kind,
                 hint=hint)


def pinteger(name=None, default: int = _UNSET, enum: Any = None,
             range: Optional[Tuple[int, int]] = None,
             hint: Optional[IntegerHint] = None, retrigger: bool = False) -> Param:
    """Declare an integer parameter; ``enum=`` an IntEnum derives hints and
    value descriptions (the #[derive(KnasterIntegerParameter)] analog).
    ``retrigger=True`` re-applies repeated same-value sets (Envelope's
    jump_to_segment semantics)."""
    name, default = _shift_name_default(name, default, 0)
    if enum is not None and not isinstance(default, int):
        default = int(default.value)
    if hint is None:
        if enum is not None:
            vals = [int(m.value) for m in enum]
            hint = IntegerHint(
                minimum=min(vals), maximum=max(vals), default=int(default),
                value_descriptions=tuple((int(m.value), m.name) for m in enum),
            )
        elif range is not None:
            hint = IntegerHint(minimum=int(range[0]), maximum=int(range[1]),
                               default=int(default))
    return Param(name, ptype="integer", default=int(default), enum=enum,
                 hint=hint, retrigger=retrigger)


def pbool(name=None, default: bool = _UNSET) -> Param:
    """Declare a boolean parameter (reference ParameterType::Bool)."""
    name, default = _shift_name_default(name, default, False)
    return Param(name, ptype="bool", default=int(default))

