"""Port of knaster_tpu/core/signature.py: structural signatures for the program cache.

Graph edits that recur (the live-coding loop: push, free, push the same
voice structure) compile to the same plan and renderers. ``compile_graph``
keys its program and plan caches (``graph/compile.py``) by a structural
signature of the graph; this module freezes one UGen's configuration into
a hashable value for it.

Freezing happens AT PUSH TIME: a fresh UGen's ``vars()`` is pure constructor
config. Many UGens attach derived values on first use (``Envelope._segs``,
``OscWt``'s per-device tables, a fused bank's kernel spec), which would
make the same config hash differently before and after a render.

A UGen whose config cannot be frozen (closures, tensors) gets signature
``None``, which makes any graph containing it uncacheable: correct, just
slower to commit. A ``torch.Tensor`` is unfreezable as the JAX package's
device arrays are: hashing one on a card would force a device-to-host copy.
One difference: a plain function of the port's own modules freezes by its
name. The port's envelopes hold their prefix sum as one (``EnvAsr.scan``,
``ugens/envelopes.py``), where the JAX package's hold nothing callable, so
they freeze wherever the JAX package's do. Any other callable (a user's
function, a closure, a ``KernelVoiceSpec`` body) stays unfreezable.
"""

from __future__ import annotations

import enum
import hashlib
import sys
import types
from typing import Any, Optional

import numpy as np
import torch


class _Unfreezable(Exception):
    pass


_SCALARS = (bool, int, float, str, bytes, type(None))
_MAX_DEPTH = 12

# the one source of truth for which instance attributes are runtime data by
# default; UGen.signature_exclude references this (core/ugen.py) and
# subclasses extend it (VoiceBank adds voice_defaults)
DEFAULT_SIGNATURE_EXCLUDE = ("pdefaults",)


def _library_function(fn) -> bool:
    """True for a plain function of the port's own modules, bound there
    under its name: what its name says of it cannot change while the
    program runs."""
    mod = fn.__module__ or ""
    return (mod.startswith(__package__.rpartition(".")[0] + ".")
            and fn.__closure__ is None
            and getattr(sys.modules.get(mod), fn.__name__, None) is fn)


def _freeze(v: Any, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise _Unfreezable("nesting too deep")
    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, enum.Enum):
        return ("enum", type(v).__qualname__, v.value)
    if isinstance(v, np.ndarray):
        data = np.ascontiguousarray(v)
        return (
            "nd",
            tuple(data.shape),
            str(data.dtype),
            hashlib.sha1(data.tobytes()).hexdigest(),
        )
    if isinstance(v, np.generic):
        return ("npscalar", str(v.dtype), v.item())
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_freeze(x, depth + 1) for x in v))
    if isinstance(v, frozenset):
        return ("set", tuple(sorted(_freeze(x, depth + 1) for x in v)))
    if isinstance(v, dict):
        return (
            "map",
            tuple(
                (str(k), _freeze(x, depth + 1)) for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))
            ),
        )
    if isinstance(v, type):
        return ("type", v.__module__, v.__qualname__)
    if isinstance(v, torch.dtype):
        return ("dtype", str(v))
    if isinstance(v, torch.device):
        return ("device", str(v))
    if isinstance(v, types.FunctionType) and _library_function(v):
        return ("fn", v.__module__, v.__qualname__)
    if callable(v):
        raise _Unfreezable(f"callable {v!r}")
    # tensors (and anything else of torch's): hashing a card's tensor would
    # force a device-to-host copy
    if isinstance(v, torch.Tensor) or type(v).__module__.startswith("torch"):
        raise _Unfreezable(f"torch value {type(v)!r}")
    d = getattr(v, "__dict__", None)
    if d is not None:
        return (
            "obj",
            type(v).__module__,
            type(v).__qualname__,
            _freeze(d, depth + 1),
        )
    raise _Unfreezable(f"{type(v)!r}")


def ugen_signature(ugen: Any) -> Optional[Any]:
    """Hashable config signature of a freshly constructed UGen, or None
    when the config can't be frozen (the graph becomes uncacheable)."""
    custom = getattr(ugen, "program_key", None)
    if callable(custom):
        try:
            key = custom()
        except Exception:
            return None
        if key is None:
            return None
        try:
            return ("custom", type(ugen).__module__, type(ugen).__qualname__, _freeze(key))
        except _Unfreezable:
            return None
    try:
        attrs = dict(vars(ugen))
        # A pushed node's own runtime-data attributes are excluded
        # (UGen.signature_exclude, default: pdefaults): param defaults seed
        # the ParamLayout and so the param engine's init_state, and every
        # declared param reaches process() as engine rows, so two graphs
        # differing only in them share one renderer: "push the same voice
        # shape at a new freq" becomes a program-cache hit. Nested UGen
        # attributes keep their pdefaults frozen: composites (SineVoice's
        # inner EnvAsr) may read inner defaults in process.
        for k in getattr(ugen, "signature_exclude", DEFAULT_SIGNATURE_EXCLUDE):
            attrs.pop(k, None)
        return (
            type(ugen).__module__,
            type(ugen).__qualname__,
            _freeze(attrs),
        )
    except _Unfreezable:
        return None
