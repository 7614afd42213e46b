"""Port of knaster_tpu/core/decorator.py: the ``@ugen`` decorator, terse UGen declaration.

The reference's ergonomics centerpiece is the ``#[impl_ugen]`` proc-macro
(knaster_macros/src/lib.rs:74-770), which infers channel counts and the
parameter table from function signatures. This is the Python analog:
decorate a function, declare parameters as keyword-only arguments, and
their types are inferred from the defaults (float -> float param, TRIG
sentinel -> trigger, bool -> bool, int/IntEnum -> integer, a ``Param`` ->
that declaration under the keyword's name).

Block form (the function sees whole blocks; params are [block] tensors)::

    @ugen(inputs=1, outputs=1)
    def gain(ctx, state, inputs, *, amount=1.0):
        return state, inputs * amount[None, :]

Per-sample form (``sample_scan``'s Python loop over the block; params are
the sample's values)::

    @ugen.sample(inputs=0, outputs=1,
                 state=lambda ctx: {"phase": torch.zeros((), dtype=ctx.dtype)})
    def saw(carry, frame, *, freq=110.0, t_reset=TRIG):
        phase = torch.where(t_reset, 0.0, carry["phase"])
        out = phase * 2.0 - 1.0
        return {"phase": (phase + freq / 48000.0) % 1.0}, out.reshape(1)

The function sees ONE instance, as in the JAX package. The port's batched
callers (a ``VoiceBank`` passes ``[V, ...]`` state and ``[V, B]`` params)
give ``process`` leading batch axes; it maps the function over them with
``torch.func.vmap`` (``core.ugen.per_instance``). ``state(ctx)`` builds the
initial state; ``init`` moves its tensors to the device it is given.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
from typing import Callable, Optional

import torch

from ..primitives.params import Param, pbool, pfloat, pinteger, ptrigger
from .ugen import AudioCtx, UGen, per_instance, sample_scan, tree_to


class _Trig:
    """Sentinel default marking a trigger parameter."""

    def __repr__(self):
        return "TRIG"


TRIG = _Trig()


def _infer_params(fn: Callable, skip: int) -> tuple:
    sig = inspect.signature(fn)
    specs = []
    for name, p in list(sig.parameters.items()):
        if p.kind != inspect.Parameter.KEYWORD_ONLY:
            continue
        d = p.default
        if d is inspect.Parameter.empty:
            raise TypeError(
                f"@ugen parameter {name!r} needs a default to infer its type"
            )
        if isinstance(d, Param):
            # full declaration with hints: freq=pfloat(440.0, range=(20,
            # NYQUIST), logarithmic=True); the keyword supplies the name
            # (the reference macro's #[param(range=..., logarithmic=...)],
            # knaster_macros/src/lib.rs:773-779)
            specs.append(
                d if d.name == name else dataclasses.replace(d, name=name)
            )
        elif isinstance(d, _Trig):
            specs.append(ptrigger(name))
        elif isinstance(d, bool):
            specs.append(pbool(name, d))
        elif isinstance(d, enum.IntEnum):
            specs.append(pinteger(name, int(d), enum=type(d)))
        elif isinstance(d, int):
            specs.append(pinteger(name, d))
        elif isinstance(d, float):
            specs.append(pfloat(name, d))
        else:
            raise TypeError(
                f"@ugen cannot infer a parameter type from default {d!r}"
            )
    return tuple(specs)


def _positional_adapter(fn: Callable):
    """Flexible-signature adapter (the reference macro lets user fns take
    any subset of ``(&mut AudioCtx, &mut UGenFlags, input)``,
    knaster_macros/src/lib.rs:824-870): the block function may declare any
    subset of the positional args ``ctx``/``state``/``inputs`` (recognized
    by name), in any order; missing ones simply aren't passed."""
    sig = inspect.signature(fn)
    names = [
        p.name for p in sig.parameters.values()
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]
    allowed = {"ctx", "state", "st", "inputs", "inp", "input"}
    unknown = [n for n in names if n not in allowed]
    if unknown:
        raise TypeError(
            f"@ugen positional args must be a subset of ctx/state/inputs, "
            f"got {unknown!r}"
        )
    canon = {"st": "state", "inp": "inputs", "input": "inputs"}
    order = [canon.get(n, n) for n in names]

    def call(ctx, st, inp, params):
        avail = {"ctx": ctx, "state": st, "inputs": inp}
        return fn(*[avail[n] for n in order], **params)

    return call, ("state" in order)


def _ugen_class(fn, specs, inputs, outputs, state, name, process):
    """The UGen class a decorator builds: ``specs`` as its params,
    ``process`` as its block method."""

    class _DecoratedUGen(UGen):
        params = specs

        def __init__(self, **defaults):
            self.inputs = inputs
            self.outputs = outputs
            for k in defaults:
                if k not in {p.name for p in specs}:
                    raise TypeError(f"unknown parameter {k!r}")
            self.pdefaults = {
                k: (v.value if hasattr(v, "value") else v)
                for k, v in defaults.items()
            }

        def name(self):
            return name or fn.__name__

        def init(self, ctx: AudioCtx, device="cpu"):
            return tree_to(state(ctx), device) if state else {}

    _DecoratedUGen.process = process
    _DecoratedUGen.__name__ = name or fn.__name__
    _DecoratedUGen.__qualname__ = _DecoratedUGen.__name__
    _DecoratedUGen.__doc__ = fn.__doc__
    return _DecoratedUGen


def ugen(
    inputs: int = 0,
    outputs: int = 1,
    state: Optional[Callable[[AudioCtx], dict]] = None,
    name: Optional[str] = None,
):
    """Build a UGen class from a block function (see module docstring)."""

    def deco(fn: Callable) -> Callable[..., UGen]:
        specs = _infer_params(fn, 3)
        call, takes_state = _positional_adapter(fn)

        def process(self, ctx, st, inp, params):
            def one(st, inp, params):
                result = call(ctx, st, inp, params)
                if not takes_state:
                    # stateless form: the fn returns just the output block
                    return st, result
                return result

            return per_instance(one, inp)(st, inp, params)

        return _ugen_class(fn, specs, inputs, outputs, state, name, process)

    return deco


def _ugen_sample(
    inputs: int = 0,
    outputs: int = 1,
    state: Optional[Callable[[AudioCtx], dict]] = None,
    name: Optional[str] = None,
):
    """Build a UGen from a per-sample function looped over the block (the
    analog of the reference's default per-frame ``process``): ``fn(carry,
    frame [inputs], **the sample's params) -> (carry, out [outputs])``."""

    def deco(fn: Callable) -> Callable[..., UGen]:
        specs = _infer_params(fn, 2)

        def process(self, ctx, st, inp, params):
            def one(carry, inp, params):
                empty = torch.zeros((0,), dtype=ctx.dtype, device=inp.device)
                return sample_scan(lambda c, f: fn(c, f.pop("in", empty), **f),
                                   carry, ctx, inp, params)

            return per_instance(one, inp)(st, inp, params)

        return _ugen_class(fn, specs, inputs, outputs, state, name, process)

    return deco


ugen.sample = _ugen_sample
