"""Port of knaster_tpu/ugens/math.py: arithmetic UGens (reference math.rs).

``MathUGen(op, channels)`` takes 2*channels inputs (first half the left
operand, second half the right; reference math.rs:94-171 with
``Inputs = Double<Channels>``) and applies the op channel-wise;
``Math1UGen(op, channels)`` applies a unary op. Both run in the chain
kernel, except the ops the JAX package keeps out of its Pallas body
(``pow``, ``trunc``, ``fract``): a chain holding one of those takes the
scan executor, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core.ugen import AudioCtx, UGen

_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a**b,
}

_UNOPS = {
    "ceil": torch.ceil,
    "floor": torch.floor,
    "sqrt": torch.sqrt,
    "trunc": torch.trunc,
    "fract": lambda x: x - torch.trunc(x),
    "exp": torch.exp,
    "abs": torch.abs,
    "neg": lambda x: -x,
    "log": torch.log,
    "sin": torch.sin,
    "cos": torch.cos,
    "tanh": torch.tanh,
}

# the ops with a chain-kernel body, in the kernel's numbering
# (csrc/chain_kernel.cu: MATH_* and UN_*)
KERNEL_BINOPS = ("add", "sub", "mul", "div")
KERNEL_UNOPS = ("ceil", "floor", "sqrt", "exp", "abs", "neg", "log", "sin", "cos",
                "tanh")


class MathUGen(UGen):
    """Binary math over stacked channel pairs (math.rs:17-171)."""

    params = ()

    def batch_key(self):
        return (type(self), self.op, self.channels)

    def __init__(self, op: str, channels: int = 1):
        if op not in _BINOPS:
            raise ValueError(f"unknown binary op {op!r}; have {sorted(_BINOPS)}")
        self.op = op
        self.channels = int(channels)
        self.inputs = 2 * self.channels
        self.outputs = self.channels

    def name(self) -> str:
        return f"Math<{self.op}>"

    def process(self, ctx: AudioCtx, state, inputs, params):
        c = self.channels
        return state, _BINOPS[self.op](inputs[..., :c, :], inputs[..., c:, :])

    def kernel_stage(self, ctx: AudioCtx):
        if self.op not in KERNEL_BINOPS:
            return None  # pow: no kernel body, as in the JAX package
        from ..kernels.chain_kernel import BODIES

        return BODIES["math"], KERNEL_BINOPS.index(self.op)


# free constructor functions (reference knaster/src/math_ugens.rs)
def mul(channels: int = 1) -> "MathUGen":
    return MathUGen("mul", channels)


def add(channels: int = 1) -> "MathUGen":
    return MathUGen("add", channels)


def sub(channels: int = 1) -> "MathUGen":
    return MathUGen("sub", channels)


def div(channels: int = 1) -> "MathUGen":
    return MathUGen("div", channels)


class Math1UGen(UGen):
    """Unary math (math.rs:168-320 Math1UGen)."""

    params = ()

    def batch_key(self):
        return (type(self), self.op, self.channels)

    def __init__(self, op: str, channels: int = 1):
        if op not in _UNOPS:
            raise ValueError(f"unknown unary op {op!r}; have {sorted(_UNOPS)}")
        self.op = op
        self.channels = int(channels)
        self.inputs = self.channels
        self.outputs = self.channels

    def name(self) -> str:
        return f"Math1<{self.op}>"

    def process(self, ctx: AudioCtx, state, inputs, params):
        return state, _UNOPS[self.op](inputs)

    def kernel_stage(self, ctx: AudioCtx):
        if self.op not in KERNEL_UNOPS:
            return None  # trunc, fract: no kernel body, as in the JAX package
        from ..kernels.chain_kernel import BODIES

        return BODIES["math1"], KERNEL_UNOPS.index(self.op)
