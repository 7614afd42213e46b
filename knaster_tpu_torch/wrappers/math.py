"""Port of knaster_tpu/wrappers/math.py: scalar math wrapper combinators around an inner UGen.

Parity with knaster_core_dsp/src/wrappers_core/math.rs (WrMul/WrAdd/WrSub/
WrVSub/WrDiv/WrVDiv/WrPowf/WrPowi) and closure.rs (WrClosure): each applies
an elementwise epilogue to the inner UGen's output, so a single node needs
no extra Constant/Math nodes. The constant is a tensor of ``ctx.dtype`` (a
Python scalar on the other side of an operator would round differently,
PERF.md §6). ``WrPowi`` multiplies in XLA's ``integer_pow`` order (square and
multiply, then one reciprocal for a negative power), so it rounds as the
JAX package does.

Semantics (from the reference's wrapper_arithmetic test):
  wr_sub(c)   -> out - c          wr_v_sub(c) -> c - out
  wr_div(c)   -> out / c          wr_v_div(c) -> c / out

A wrapper batches when its inner UGen does and its constant matches; the
port's batched ``process`` takes leading batch axes and every ``post`` is
elementwise, so the batch passes through. ``WrClosure`` never batches.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.ugen import AudioCtx, UGen, normalize_process_result


class WrapUGen(UGen):
    """Base wrapper: delegates channel/param surface to the inner UGen."""

    def __init__(self, inner: UGen):
        self.inner = inner
        self.inputs = inner.inputs
        self.outputs = inner.outputs
        self.params = inner.params
        self.pdefaults = getattr(inner, "pdefaults", {})

    def name(self) -> str:
        return f"{type(self).__name__}({self.inner.name()})"

    def batch_key(self):
        # wrappers batch when their inner UGen does and the epilogue config
        # matches (the compiler's auto-batching pass)
        inner_key = self.inner.batch_key()
        if inner_key is None:
            return None
        extra = getattr(self, "c", None)
        extra = getattr(self, "n", extra)
        if type(self) is WrClosure:
            return None  # arbitrary closures aren't comparable
        return (type(self), inner_key, extra)

    def init(self, ctx: AudioCtx, device="cpu"):
        return self.inner.init(ctx, device)

    def process(self, ctx: AudioCtx, state, inputs, params):
        st, out, done = normalize_process_result(
            self.inner.process(ctx, state, inputs, params), ctx
        )
        return st, self.post(ctx, out), done

    def post(self, ctx: AudioCtx, out):
        return out


class _WrConst(WrapUGen):
    def __init__(self, inner: UGen, c):
        super().__init__(inner)
        self.c = float(c)

    def const(self, ctx: AudioCtx, out):
        """The constant as a 0-d tensor of ``ctx.dtype`` on ``out``'s device,
        filled there (no copy from the host)."""
        return torch.full((), self.c, dtype=ctx.dtype, device=out.device)


class WrMul(_WrConst):
    def post(self, ctx, out):
        return out * self.const(ctx, out)


class WrAdd(_WrConst):
    def post(self, ctx, out):
        return out + self.const(ctx, out)


class WrSub(_WrConst):
    def post(self, ctx, out):
        return out - self.const(ctx, out)


class WrVSub(_WrConst):
    def post(self, ctx, out):
        return self.const(ctx, out) - out


class WrDiv(_WrConst):
    def post(self, ctx, out):
        return out / self.const(ctx, out)


class WrVDiv(_WrConst):
    def post(self, ctx, out):
        return self.const(ctx, out) / out


class WrPowf(_WrConst):
    def post(self, ctx, out):
        return torch.pow(out, self.const(ctx, out))


def integer_pow(x, n: int):
    """``x ** n`` in XLA's ``integer_pow`` order: square and multiply over
    the bits of ``|n|``, then one reciprocal for a negative ``n``."""
    if n == 0:
        return torch.ones_like(x)
    y = abs(n)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return torch.ones_like(acc) / acc if n < 0 else acc


class WrPowi(WrapUGen):
    def __init__(self, inner: UGen, n: int):
        super().__init__(inner)
        self.n = int(n)

    def post(self, ctx, out):
        return integer_pow(out, self.n)


class WrClosure(WrapUGen):
    """Apply an arbitrary elementwise torch function (closure.rs WrClosure)."""

    def __init__(self, inner: UGen, fn: Callable):
        super().__init__(inner)
        self.fn = fn

    def post(self, ctx, out):
        return self.fn(out)
