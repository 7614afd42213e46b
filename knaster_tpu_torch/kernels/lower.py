"""Lower a voice's per-sample torch body to a CUDA body for the generic harness.

The counterpart of Mosaic's tracing of ``body_fn`` inside
``knaster_tpu/parallel/generic_bank.py::_generic_kernel`` (:122-133), and of
``_validate``'s refusal of a body that will not lower (:149-175). A voice
whose ``KernelVoiceSpec`` names no library ``cuda_body`` and brings no
``cuda_source`` reaches the card through ``lower_body``: its torch body
(``spec.body``) becomes CUDA C++ source that defines ``struct VoiceBody`` in
the harness's body contract (``csrc/generic_harness.cuh``), built at the
bank's first launch as a user's source is (``build.load_user_body``).

How it traces: by execution. The body runs on small CPU tensors of a
tensor subclass (``_Traced``) that records every torch op it sees through
``__torch_function__`` and computes the real result beside it, so torch
itself decides each result's dtype and every promotion. The carries,
``P[name]``, ``T[name]`` and ``i_f`` enter as leaves (``i_f`` as a 0-d f32
value); closure constants (numpy scalars, Python numbers, 0-d tensors)
become exact literals in the op's compute dtype. The body is traced twice,
with ``T`` as trigger leaves (eventful) and with ``T[name] = None``
(event-free), because a body branches on ``is None``; the source holds both
under ``if constexpr (P::kEventful)``, so each path is its torch path.

What it emits: one C statement per traced op, in trace order, so the source
keeps Python's association (the harness builds with ``--fmad=false`` and no
fast math); an f32 carry is read through ``as_f`` and written back through
``as_u``; a u32 carry, which the torch body sees as int64 in [0, 2^32), is
read as ``long long`` and truncated to its 32-bit word on the way back;
params come from ``p(k)``, the sample index from ``p.i_f``. Integer
arithmetic wraps through unsigned types, as torch's does; clamp, minimum and
maximum keep torch's CPU selects (NaN propagates); ``scalar / tensor`` is
torch's ``reciprocal`` then ``*``, and so it is emitted. The constants are
literals, so the body's ``Consts`` holds one unused float (the image).

The op set: ``+ - * /``, ``reciprocal``, ``neg``; comparisons, ``where``,
``clamp``, ``minimum``/``maximum``, ``abs``, ``floor``, ``round``; ``& | ^ ~
>> <<``; ``.to(int32 | int64 | float32 | bool)``, ``.long()``, ``.int()``,
``.float()``, ``.bool()``, ``.view`` between int32 and float32;
``full_like``/``zeros_like``/``ones_like``; ``sin``, ``cos``, ``exp``,
``tanh``, ``sqrt``. ``torch.ones``/``zeros``/``full`` of shape ``()`` take
no traced operand and are constants. Anything else raises a ``ValueError``
naming the voice and the op: a gather or indexing, an in-place op, a value
that is not ``[V]`` or a scalar, an f64 value, a Python branch on a traced
value (``bool()``), an op outside the set.

The register policy comes from the carry's size, as the library Modal body
takes it (``csrc/generic_bank.cu`` ``ModalBody``): four CTAs an SM (64
registers) up to 8 carry words, three up to 27, two up to 80, one past. A
stereo body computes its pan inside the body (``kPan = -1``, ``NoHoist``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

V_TRACE = 7  # the traced [V] axis: small and prime, no width a body's constants take

_CTYPE = {torch.float32: "float", torch.int32: "int", torch.int64: "long long",
          torch.bool: "bool"}
_UTYPE = {torch.int32: "unsigned", torch.int64: "unsigned long long"}
_BITS = {torch.int32: 32, torch.int64: 64}

# torch functions by __name__ -> the op recorded
_ADD = {"add", "__add__", "__radd__"}
_SUB = {"sub", "__sub__", "subtract"}
_RSUB = {"rsub", "__rsub__"}
_MUL = {"mul", "__mul__", "__rmul__", "multiply"}
_DIV = {"div", "__truediv__", "true_divide", "divide"}
_RDIV = {"__rdiv__", "__rtruediv__"}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
        "__lt__": "<", "__le__": "<=", "__gt__": ">", "__ge__": ">=", "__eq__": "==",
        "__ne__": "!=", "less": "<", "less_equal": "<=", "greater": ">",
        "greater_equal": ">=", "not_equal": "!="}
_BITWISE = {"__and__": "and", "__rand__": "and", "bitwise_and": "and", "logical_and": "land",
            "__or__": "or", "__ror__": "or", "bitwise_or": "or", "logical_or": "lor",
            "__xor__": "xor", "__rxor__": "xor", "bitwise_xor": "xor"}
_SHIFT = {"__lshift__": "shl", "bitwise_left_shift": "shl", "__rshift__": "shr",
          "bitwise_right_shift": "shr"}
_UNARY = {"neg": "neg", "__neg__": "neg", "negative": "neg", "abs": "abs", "__abs__": "abs",
          "floor": "floor", "round": "round", "sin": "sin", "cos": "cos", "exp": "exp",
          "tanh": "tanh", "sqrt": "sqrt", "reciprocal": "reciprocal",
          "__invert__": "not", "bitwise_not": "not", "logical_not": "lnot"}
_CASTS = {"to", "long", "int", "float", "bool", "type"}
_FILLS = {"full_like", "zeros_like", "ones_like"}
_MINMAX = {"minimum", "maximum"}
_CLAMP = {"clamp", "clip"}
# what reads a traced value back into Python
_TO_PYTHON = {"__bool__", "item", "tolist", "__float__", "__int__", "__index__",
              "__complex__", "__array__", "numpy"}
_GATHER = {"__getitem__", "gather", "index_select", "take", "take_along_dim", "select",
           "narrow", "embedding", "masked_select", "__setitem__", "index_put",
           "scatter", "scatter_add", "index_add", "put"}
# metadata reads: their result is no tensor and is returned as it is
_META = {"__get__", "dim", "size", "numel", "element_size", "is_floating_point",
         "is_complex", "__len__", "__hash__", "get_device", "is_contiguous", "__repr__",
         "__str__", "__format__"}
_INPLACE_DUNDERS = {"__iadd__", "__isub__", "__imul__", "__itruediv__", "__idiv__",
                    "__ifloordiv__", "__imod__", "__ipow__", "__iand__", "__ior__",
                    "__ixor__", "__ilshift__", "__irshift__", "__imatmul__"}


@dataclass(frozen=True)
class Lit:
    """An exact constant in the dtype of the op that reads it."""
    value: object
    dtype: torch.dtype


@dataclass
class Op:
    """One traced op. ``op``: a leaf (``carry``, ``param``, ``trig``,
    ``i_f``: ``args`` is its index), ``const`` (``args`` is one Lit) or an
    op of the set; ``args``: operands (an earlier Op's index, or a Lit in
    ``cdt``); ``dtype``: the result's; ``cdt``: the dtype the operands are
    cast to (a cast's and a bit cast's: its source's)."""
    op: str
    args: tuple
    dtype: torch.dtype
    cdt: torch.dtype


@dataclass
class Program:
    """One trace: its ops, and per carry and per output the operand that
    holds it (an op's index or a Lit)."""
    ops: list
    carry: tuple
    outs: tuple


@dataclass
class LoweredBody:
    """What ``lower_body`` returns.

    source: CUDA C++ that defines ``struct VoiceBody`` (the harness contract);
    counts: (NF, NT, NC, C); ops_per_sample: the operations a voice-sample
    of an event-free block takes, the body's traced ops (a clamp one per
    bound, a bit cast none) plus the harness's (the sample index, 4 a param
    read, 3 a channel for the active gain and the mix); image: the
    ``Consts`` image (one unused float); programs: {True: the eventful
    trace, False: the event-free one}."""
    voice_name: str
    source: str
    counts: Tuple[int, int, int, int]
    ops_per_sample: int
    image: np.ndarray
    programs: Dict[bool, Program]
    carry_kinds: Tuple[str, ...]
    float_names: Tuple[str, ...]
    trig_names: Tuple[str, ...]


class _Tracer:
    def __init__(self, voice_name):
        self.voice_name = voice_name
        self.ops = []

    def refuse(self, what):
        raise ValueError(f"{self.voice_name}: its torch body cannot be lowered to a CUDA "
                         f"body (FusedVoiceBank on the card): {what}")

    def add(self, op, args, dtype, cdt, raw):
        self.ops.append(Op(op, tuple(args), dtype, cdt))
        return _Traced(raw, self, len(self.ops) - 1)

    def leaf(self, op, index, raw):
        return self.add(op, (index,), raw.dtype, raw.dtype, raw)

    def operand(self, x, cdt, name):
        """An operand of op ``name`` in compute dtype ``cdt``: an op's index
        (cast where it is used) or an exact Lit."""
        if isinstance(x, _Traced):
            if x._tracer is not self:
                self.refuse(f"`{name}` mixes values of two traces")
            op = self.ops[x._node]
            if op.op == "const":
                return _lit(torch.tensor(op.args[0].value, dtype=op.args[0].dtype), cdt)
            return x._node
        if isinstance(x, torch.Tensor):
            if x.dim() != 0:
                self.refuse(f"`{name}` reads a constant tensor of shape {tuple(x.shape)}: "
                            "a body's values are [V] or scalars")
            return _lit(x.detach().cpu(), cdt)
        if isinstance(x, np.ndarray) and x.ndim != 0:
            self.refuse(f"`{name}` reads a numpy array of shape {x.shape}: a body's "
                        "values are [V] or scalars")
        if isinstance(x, bool):
            return _lit(torch.tensor(x), cdt)
        if isinstance(x, int):
            return _lit(torch.tensor(x, dtype=torch.int64), cdt)
        if isinstance(x, float):
            return _lit(torch.tensor(x, dtype=torch.float64), cdt)
        if isinstance(x, (np.generic, np.ndarray)):
            return _lit(torch.from_numpy(np.array(x)), cdt)
        self.refuse(f"`{name}` reads {type(x).__name__} {x!r}")


def _lit(t, cdt):
    """A constant rounded to the op's compute dtype, as torch converts a
    scalar operand."""
    return Lit(t.to(cdt).item(), cdt)


class _Traced(torch.Tensor):
    """A small CPU tensor that records the torch ops it meets."""

    @staticmethod
    def __new__(cls, raw, tracer, node):
        t = torch.Tensor._make_subclass(cls, raw)
        t._raw, t._tracer, t._node = raw, tracer, node
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _record(func, args, kwargs or {})


def _walk(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _walk(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _walk(y)
    else:
        yield x


def _unwrap(x):
    if isinstance(x, _Traced):
        return x._raw
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(y) for y in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def _record(func, args, kwargs):
    name = getattr(func, "__name__", repr(func))
    tracer = next(x._tracer for x in _walk((args, kwargs)) if isinstance(x, _Traced))
    if name in _TO_PYTHON:
        tracer.refuse(f"`{name}` reads a traced value back into Python (a Python `if` "
                      "on a traced value, bool(), .item()): use torch.where")
    if name in _INPLACE_DUNDERS or (name.endswith("_") and not name.startswith("__")) \
            or kwargs.get("out") is not None:
        tracer.refuse(f"`{name}` is an in-place op")
    if name in _GATHER:
        tracer.refuse(f"`{name}` is a gather or an indexing: a body reads [V] values "
                      "elementwise")
    with torch._C.DisableTorchFunctionSubclass():
        out = func(*_unwrap(args), **_unwrap(kwargs))
    if not isinstance(out, torch.Tensor):
        if name in _META and not any(isinstance(x, torch.Tensor) for x in _walk(out)):
            return out
        tracer.refuse(f"`{name}` gives {type(out).__name__}, not a tensor")
    if out.device.type != "cpu":
        tracer.refuse(f"`{name}` moves a value to {out.device}")
    if out.dtype == torch.float64:
        tracer.refuse(f"`{name}` gives an f64 value: the body runs in f32")
    if out.dtype not in _CTYPE:
        tracer.refuse(f"`{name}` gives a {out.dtype} value (f32, int32, int64 and bool lower)")
    if tuple(out.shape) not in ((), (V_TRACE,)):
        shape = ["V" if n == V_TRACE else n for n in out.shape]
        tracer.refuse(f"`{name}` gives a value of shape {shape}, not [V]")
    return _lower_op(tracer, name, args, kwargs, out)


def _arg(args, kwargs, i, key, default=None):
    return args[i] if len(args) > i else kwargs.get(key, default)


def _lower_op(tr, name, args, kwargs, out):
    dt = out.dtype

    def binary(op, a, b, cdt=dt):
        return tr.add(op, (tr.operand(a, cdt, name), tr.operand(b, cdt, name)), dt, cdt, out)

    if name in _ADD | _SUB | _RSUB | _MUL:
        if _arg(args, kwargs, 2, "alpha", 1) != 1:
            tr.refuse(f"`{name}` with alpha")
        if dt == torch.bool:
            tr.refuse(f"`{name}` on bool values")
        op = "add" if name in _ADD else "mul" if name in _MUL else "sub"
        a, b = args[0], args[1]
        return binary(op, b, a) if name in _RSUB else binary(op, a, b)
    if name in _DIV:
        if kwargs.get("rounding_mode") is not None:
            tr.refuse(f"`{name}` with rounding_mode")
        return binary("div", args[0], args[1])
    if name in _RDIV:
        # torch's Tensor.__rdiv__ is ``self.reciprocal() * other``: two roundings
        with torch._C.DisableTorchFunctionSubclass():
            recip = args[0]._raw.reciprocal()
        r = tr.add("reciprocal", (tr.operand(args[0], recip.dtype, name),), recip.dtype,
                   recip.dtype, recip)
        return binary("mul", r, args[1])
    if name in _CMP:
        a, b = args[0], args[1]
        cdt = torch.result_type(*(_scalar_or_raw(x) for x in (a, b)))
        return binary(_CMP[name], a, b, cdt)
    if name in _BITWISE:
        op = _BITWISE[name]
        if op in ("land", "lor"):
            return binary("and" if op == "land" else "or", args[0], args[1], torch.bool)
        return binary(op, args[0], args[1])
    if name in _SHIFT:
        return binary(_SHIFT[name], args[0], args[1])
    if name in _UNARY:
        if name == "round" and _arg(args, kwargs, 1, "decimals", 0) != 0:
            tr.refuse("`round` with decimals")
        op = _UNARY[name]
        if op == "lnot":
            return tr.add("not", (tr.operand(args[0], torch.bool, name),), dt, torch.bool, out)
        return tr.add(op, (tr.operand(args[0], dt, name),), dt, dt, out)
    if name == "where":
        if len(args) + len(kwargs) < 3:
            tr.refuse("`where` with one argument (a gather of indices)")
        c, a, b = (_arg(args, kwargs, i, k) for i, k in enumerate(("condition", "input", "other")))
        return tr.add("where", (tr.operand(c, torch.bool, name), tr.operand(a, dt, name),
                                tr.operand(b, dt, name)), dt, dt, out)
    if name in _MINMAX:
        return binary(name, args[0], args[1])
    if name in _CLAMP:
        lo, hi = _arg(args, kwargs, 1, "min"), _arg(args, kwargs, 2, "max")
        ops = (tr.operand(args[0], dt, name),
               None if lo is None else tr.operand(lo, dt, name),
               None if hi is None else tr.operand(hi, dt, name))
        return tr.add("clamp", ops, dt, dt, out)
    if name in _CASTS:
        src = args[0]._raw.dtype
        if src == dt and tr.ops[args[0]._node].op != "const":
            return _Traced(out, tr, args[0]._node)
        return tr.add("cast", (tr.operand(args[0], src, name),), dt, src, out)
    if name == "view":
        src, to = args[0]._raw.dtype, _arg(args, kwargs, 1, "dtype")
        if not isinstance(to, torch.dtype) or len(args) > 2:
            tr.refuse("`view` to a shape: a body's values are [V]")
        if {src, dt} != {torch.int32, torch.float32}:
            tr.refuse(f"`view` from {src} to {dt} (int32 <-> float32 bit casts lower)")
        return tr.add("bitcast", (tr.operand(args[0], src, name),), dt, src, out)
    if name in _FILLS:
        return tr.add("const", (Lit(out.reshape(-1)[0].item(), dt),), dt, dt, out)
    tr.refuse(f"`{name}` is not in the op set that lowers (elementwise arithmetic, "
              "compare, where, clamp, min/max, bitwise, casts, sin/cos/exp/tanh/sqrt)")


def _scalar_or_raw(x):
    if isinstance(x, _Traced):
        return x._raw
    if isinstance(x, (np.generic, np.ndarray)):
        return np.asarray(x).item()
    return x


class _TraceParams:
    """``P`` of a trace: a float param's leaf at its first read."""

    def __init__(self, tracer, float_names):
        self._tracer = tracer
        self._index = {n: k for k, n in enumerate(float_names)}
        self._leaves = {}

    def __getitem__(self, name):
        if name not in self._leaves:
            raw = torch.full((V_TRACE,), 0.5, dtype=torch.float32)
            self._leaves[name] = self._tracer.leaf("param", self._index[name], raw)
        return self._leaves[name]


def _trace(spec, float_names, trig_names, n_out, eventful):
    tr = _Tracer(spec.voice_name)
    carry = {}
    for k, (name, (kind, _)) in enumerate(spec.carry.items()):
        raw = (torch.ones(V_TRACE, dtype=torch.int64) if kind == "u32"
               else torch.full((V_TRACE,), 0.5, dtype=torch.float32))
        carry[name] = tr.leaf("carry", k, raw)
    T = {name: (tr.leaf("trig", k, torch.zeros(V_TRACE, dtype=torch.bool)) if eventful
                else None) for k, name in enumerate(trig_names)}
    i_f = tr.leaf("i_f", 0, torch.zeros((), dtype=torch.float32))
    new, outs = spec.body(i_f, carry, _TraceParams(tr, float_names), T)
    roots = []
    for name, (kind, _) in spec.carry.items():
        if name not in new:
            tr.refuse(f"the body returns no carry {name!r}")
        x = new[name]
        if not isinstance(x, _Traced) or x._tracer is not tr or x._raw.dim() != 1:
            tr.refuse(f"carry {name!r} is not a [V] value of the body")
        want = (torch.float32,) if kind == "f32" else (torch.int32, torch.int64)
        if x._raw.dtype not in want:
            tr.refuse(f"carry {name!r} ({kind}) comes back as {x._raw.dtype}")
        roots.append(tr.operand(x, x._raw.dtype, f"carry {name}"))
    if len(outs) < n_out:
        tr.refuse(f"the body returns {len(outs)} outputs for the voice's {n_out}")
    out_roots = []
    for ch in range(n_out):
        x = outs[ch]
        dt = _unwrap(x).dtype if isinstance(x, torch.Tensor) else torch.float32
        out_roots.append(tr.operand(x, dt, f"output {ch}"))
    return _prune(Program(tr.ops, tuple(roots), tuple(out_roots)))


def _prune(prog):
    """The program with only the ops its carries and outputs read,
    renumbered in trace order."""
    live = set()
    stack = [r for r in prog.carry + prog.outs if isinstance(r, int)]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        op = prog.ops[i]
        if op.op not in ("carry", "param", "trig", "i_f", "const"):
            stack.extend(a for a in op.args if isinstance(a, int))
    order = sorted(live)
    new_index = {old: new for new, old in enumerate(order)}

    def remap(a):
        return new_index[a] if isinstance(a, int) else a

    ops = []
    for i in order:
        op = prog.ops[i]
        if op.op in ("carry", "param", "trig", "i_f", "const"):
            ops.append(op)
        else:
            ops.append(Op(op.op, tuple(remap(a) for a in op.args), op.dtype, op.cdt))
    return Program(ops, tuple(remap(r) for r in prog.carry), tuple(remap(r) for r in prog.outs))


# --------------------------------------------------------------------------
# the CUDA source
# --------------------------------------------------------------------------

def _flit(v):
    """An f32 value as an exact C literal."""
    v = float(v)
    if not np.isfinite(v):
        bits = int(np.array(v, np.float32).view(np.uint32))
        return f"as_f(0x{bits:08x}u)"
    h = v.hex()  # [-]0x1.8000000000000p+0
    sign = "-" if h.startswith("-") else ""
    mant, exp = h.lstrip("-")[2:].split("p")
    head, _, frac = mant.partition(".")
    frac = frac.rstrip("0")
    text = f"{sign}0x{head}{'.' + frac if frac else ''}p{exp}f"
    return f"({text})" if sign else text


def _literal(lit):
    dt, v = lit.dtype, lit.value
    if dt == torch.float32:
        return _flit(v)
    if dt == torch.bool:
        return "true" if v else "false"
    v = int(v)
    suffix = "LL" if dt == torch.int64 else ""
    if v == -(1 << (_BITS[dt] - 1)):
        return f"(-{(1 << (_BITS[dt] - 1)) - 1}{suffix} - 1)"
    return f"({v}{suffix})" if v < 0 else f"{v}{suffix}"


def _cast_expr(expr, src, dst):
    if src == dst:
        return expr
    return f"static_cast<{_CTYPE[dst]}>({expr})"


def _emit_program(prog, carry_kinds, indent):
    """C statements of one trace."""
    lines = []
    types = [op.dtype for op in prog.ops]

    def val(a, cdt):
        if isinstance(a, Lit):
            return _literal(a)
        return _cast_expr(f"v{a}", types[a], cdt)

    for i, op in enumerate(prog.ops):
        T = _CTYPE[op.dtype]
        name = f"v{i}"
        k = op.op
        if k == "carry":
            (j,) = op.args
            rhs = f"static_cast<long long>(c[{j}])" if carry_kinds[j] == "u32" else f"as_f(c[{j}])"
        elif k == "param":
            rhs = f"p({op.args[0]})"
        elif k == "trig":
            rhs = f"trig[{op.args[0]}]"
        elif k == "i_f":
            rhs = "p.i_f"
        elif k == "const":
            rhs = _literal(op.args[0])
        else:
            rhs = _expr(op, [None if a is None else val(a, _operand_dtype(op, j))
                             for j, a in enumerate(op.args)])
        lines.append(f"const {T} {name} = {rhs};")
    for j, (root, kind) in enumerate(zip(prog.carry, carry_kinds)):
        if isinstance(root, int) and prog.ops[root].op == "carry" and prog.ops[root].args[0] == j:
            continue  # written back as it was read
        if kind == "u32":
            src = root.dtype if isinstance(root, Lit) else types[root]
            lines.append(f"c[{j}] = static_cast<uint32_t>({val(root, src)});")
        else:
            lines.append(f"c[{j}] = as_u({val(root, torch.float32)});")
    for ch, root in enumerate(prog.outs):
        src = root.dtype if isinstance(root, Lit) else types[root]
        lines.append(f"out[{ch}] = {_cast_expr(val(root, src), src, torch.float32)};")
    return "\n".join(indent + ln for ln in lines)


def _operand_dtype(op, j):
    """The dtype operand ``j`` of ``op`` is read in: a where's condition in
    bool, every other operand in the op's compute dtype."""
    return torch.bool if op.op == "where" and j == 0 else op.cdt


def _expr(op, a):
    """The C expression of one op over its operand expressions (each
    already in ``op.cdt``)."""
    k, cdt, T = op.op, op.cdt, _CTYPE[op.dtype]
    is_f = cdt == torch.float32
    if k in ("add", "sub", "mul"):
        sym = {"add": "+", "sub": "-", "mul": "*"}[k]
        if is_f:
            return f"{a[0]} {sym} {a[1]}"
        U = _UTYPE[cdt]  # wraps as torch's does
        return f"static_cast<{T}>(static_cast<{U}>({a[0]}) {sym} static_cast<{U}>({a[1]}))"
    if k == "div":
        return f"{a[0]} / {a[1]}"
    if k == "reciprocal":
        return f"1.0f / {a[0]}"
    if k in ("<", "<=", ">", ">=", "==", "!="):
        return f"{a[0]} {k} {a[1]}"
    if k == "where":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    if k in ("minimum", "maximum"):
        if cdt == torch.bool:
            return f"{a[0]} {'&&' if k == 'minimum' else '||'} {a[1]}"
        pick = f"({a[1]} < {a[0]} ? {a[1]} : {a[0]})" if k == "minimum" else \
            f"({a[0]} < {a[1]} ? {a[1]} : {a[0]})"
        if not is_f:
            return pick
        return f"({a[0]} != {a[0]} || {a[1]} != {a[1]}) ? as_f(0x7fc00000u) : {pick}"
    if k == "clamp":
        x, lo, hi = a
        if lo is not None:
            x = f"({x} < {lo} ? {lo} : {x})"
        if hi is not None:
            x = f"({hi} < {x} ? {hi} : {x})"
        return x
    if k in ("and", "or", "xor"):
        if cdt == torch.bool:
            return f"{a[0]} {'&&' if k == 'and' else '||' if k == 'or' else '!='} {a[1]}"
        return f"{a[0]} {'&' if k == 'and' else '|' if k == 'or' else '^'} {a[1]}"
    if k == "not":
        return f"!{a[0]}" if cdt == torch.bool else f"~{a[0]}"
    if k in ("shl", "shr"):
        bits, U = _BITS[cdt], _UTYPE[cdt]
        x, s = a
        lit = op.args[1].value if isinstance(op.args[1], Lit) else None
        if k == "shl":
            shifted = f"static_cast<{T}>(static_cast<{U}>({x}) << {s})"
            if lit is not None and 0 <= lit < bits:
                return shifted
            return f"({s} < 0 || {s} >= {bits}) ? static_cast<{T}>(0) : {shifted}"
        if lit is not None and 0 <= lit < bits - 1:
            return f"{x} >> {s}"
        return f"({s} < 0 || {s} >= {bits - 1}) ? ({x} >> {bits - 1}) : ({x} >> {s})"
    if k == "neg":
        if is_f:
            return f"-{a[0]}"
        return f"static_cast<{T}>(static_cast<{_UTYPE[cdt]}>(0) - static_cast<{_UTYPE[cdt]}>({a[0]}))"
    if k == "abs":
        if is_f:
            return f"fabsf({a[0]})"
        U = _UTYPE[cdt]
        return f"{a[0]} < 0 ? static_cast<{T}>(static_cast<{U}>(0) - static_cast<{U}>({a[0]})) : {a[0]}"
    if k in ("floor", "round"):
        return f"{'floorf' if k == 'floor' else 'rintf'}({a[0]})" if is_f else a[0]
    if k in ("sin", "cos", "exp", "tanh", "sqrt"):
        return f"{k}f({a[0]})"
    if k == "cast":  # from the source's dtype: the C conversion is torch's
        return f"static_cast<{T}>({a[0]})"
    if k == "bitcast":
        if op.dtype == torch.float32:
            return f"as_f(static_cast<uint32_t>({a[0]}))"
        return f"static_cast<int>(as_u({a[0]}))"
    raise AssertionError(k)


def _min_blocks(nc):
    """CTAs an SM the launch bounds ask for, from the carry's size."""
    return 4 if nc <= 8 else 3 if nc <= 27 else 2 if nc <= 80 else 1


def _source(voice_name, counts, programs, carry_kinds):
    nf, nt, nc, c = counts
    blocks = _min_blocks(nc)
    name = " ".join(str(voice_name).split()).replace("*/", "")
    return f"""// The torch body of {name}, lowered by knaster_tpu_torch/kernels/lower.py
// (lower_body): one statement a traced op, Python's association kept.
struct VoiceBody : NoHoist, NoTable {{
  static constexpr int NF = {nf}, NT = {nt}, NC = {nc}, C = {c}, kPan = -1;
  // a carry of {nc} words: {blocks} CTA(s) an SM
  static constexpr int kMinBlocks = {blocks}, kMinBlocksEventful = {blocks};
  struct Consts {{
    float unused;  // the constants are literals
  }};
  __device__ VoiceBody(const Consts&, const float4*, const float*) {{}}
  template <class P>
  __device__ __forceinline__ void step(const Consts&, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {{
    if constexpr (P::kEventful) {{
{_emit_program(programs[True], carry_kinds, " " * 6)}
    }} else {{
{_emit_program(programs[False], carry_kinds, " " * 6)}
    }}
  }}
}};
"""


def _ops_count(prog, n_out):
    body = 0
    for op in prog.ops:
        if op.op in ("carry", "param", "trig", "i_f", "const", "bitcast"):
            continue
        body += sum(a is not None for a in op.args[1:]) if op.op == "clamp" else 1
    n_params = sum(op.op == "param" for op in prog.ops)
    return body + 1 + 4 * n_params + 3 * n_out


def lower_body(spec, float_names, trig_names, n_out) -> LoweredBody:
    """Lower ``spec.body`` (a ``KernelVoiceSpec``'s per-sample torch body)
    for a voice with float params ``float_names``, triggers ``trig_names``
    and ``n_out`` outputs. Raises ValueError, naming the voice and the op,
    for a body outside the op set."""
    float_names, trig_names = tuple(float_names), tuple(trig_names)
    programs = {ev: _trace(spec, float_names, trig_names, n_out, ev) for ev in (True, False)}
    kinds = tuple(kind for kind, _ in spec.carry.values())
    counts = (len(float_names), len(trig_names), len(spec.carry), int(n_out))
    return LoweredBody(
        voice_name=spec.voice_name, source=_source(spec.voice_name, counts, programs, kinds),
        counts=counts, ops_per_sample=_ops_count(programs[False], n_out),
        image=np.zeros(1, np.float32), programs=programs, carry_kinds=kinds,
        float_names=float_names, trig_names=trig_names)
