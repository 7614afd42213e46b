"""The collapsed-chain kernel: program, bodies, wrapper, plain torch version, launch count.

Replaces the Pallas kernel of ``knaster_tpu/graph/chain_kernel.py::run``
(kernel :265, call :333) with the CUDA C++ kernel in
``csrc/chain_kernel.cu``. The kernel is compiled once; what a chain does
arrives as a ``ChainProgram``, the int32 program
``graph/chain_kernel.py::lower`` builds from a chain plan (layout in the
kernel source). ``chain_kernel_plain`` runs the same program in torch.

``BODIES`` are the stage bodies the kernel's ``switch`` knows, each with
its opcode and its plain torch version (what a UGen's ``kernel_stage``
names): ``constant`` (Constant), ``sinwt`` (SinWt's no-reset path),
``math`` (MathUGen add/sub/mul/div) and ``math1`` (Math1UGen's unary ops but
trunc and fract). A new body is one more case in the kernel and one more
entry here; the program and the harness stay as they are.

What bounds it on an H100: K*p dependent bodies on one SM; see the kernel
source.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``chain_kernel_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import bank_common as bc

KERNEL = "chain_kernel"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p]

HEADER = 6
SRC_SLOT, SRC_CARRY, SRC_ROW, SRC_PLANE = 0, 1, 2, 3


@dataclass(frozen=True)
class Body:
    """A stage body of the kernel: its opcode, the param names it reads (in
    order), its state words and its plain torch version
    ``plain(arg, ins, pars, words, consts) -> (outs, new_words)`` over [B]
    rows (``words`` are int64 u32 values, ``consts`` = (f2pi, scale))."""

    name: str
    op: int
    params: Tuple[str, ...]
    n_words: int
    plain: Callable


def _constant_plain(arg, ins, pars, words, consts):
    return [pars[0]], []


def _sinwt_plain(arg, ins, pars, words, consts):
    """SinWt.process without resets (osc.py), on one [B] row."""
    from ..ugens.osc import U32_MASK, _f32_to_u32

    f2pi, scale = consts
    freq, poff = pars
    (ph0,) = words
    inc = _f32_to_u32(freq * f2pi)
    csum = torch.cumsum(inc, dim=0)
    phases = ph0 + csum - inc
    off = _f32_to_u32(poff * 65536.0)
    idx = ((phases + off) >> 16) & 16383
    return [torch.sin(idx.to(torch.float32) * scale)], [(ph0 + csum[-1]) & U32_MASK]


def _math_plain(arg, ins, pars, words, consts):
    from ..ugens.math import _BINOPS, KERNEL_BINOPS

    op, c = _BINOPS[KERNEL_BINOPS[arg]], len(ins) // 2
    return [op(ins[i], ins[c + i]) for i in range(c)], []


def _math1_plain(arg, ins, pars, words, consts):
    from ..ugens.math import _UNOPS, KERNEL_UNOPS

    op = _UNOPS[KERNEL_UNOPS[arg]]
    return [op(x) for x in ins], []


BODIES: Dict[str, Body] = {
    b.name: b for b in (
        Body("constant", 0, ("value",), 0, _constant_plain),
        Body("sinwt", 1, ("freq", "phase_offset"), 1, _sinwt_plain),
        Body("math", 2, (), 0, _math_plain),
        Body("math1", 3, (), 0, _math1_plain),
    )
}
_BY_OP = {b.op: b for b in BODIES.values()}


@dataclass
class ChainProgram:
    """A lowered chain: the int32 program (host copy) and its header counts.
    ``on(device)`` is the device copy, uploaded once."""

    words: Tuple[int, ...]
    n_planes: int  # planes the program reads (1 + the largest plane index)
    _device: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def period(self):
        return self.words[0]

    @property
    def n_carry(self):
        return self.words[1]

    @property
    def n_slots(self):
        return self.words[2]

    @property
    def n_ext(self):
        return self.words[3]

    @property
    def n_state(self):
        return self.words[4]

    @property
    def n_out(self):
        return self.words[5]

    def on(self, device) -> torch.Tensor:
        key = str(device)
        t = self._device.get(key)
        if t is None:
            t = self._device[key] = torch.tensor(self.words, dtype=torch.int32,
                                                 device=device)
        return t

    def records(self):
        """Per offset: (body, arg, inputs [[(kind, idx)]], params
        [(kind, idx)], outputs [(slot, plane)], state_row)."""
        w = self.words
        recs = []
        for j in range(self.period):
            r = w[HEADER + self.n_carry + j]
            op, arg, n_in, n_par, n_out, srow, in_tab, par_tab, out_tab = w[r:r + 9]
            ins = []
            for c in range(n_in):
                start, count = w[in_tab + 2 * c], w[in_tab + 2 * c + 1]
                ins.append([(w[start + 2 * i], w[start + 2 * i + 1])
                            for i in range(count)])
            pars = [(w[par_tab + 2 * i], w[par_tab + 2 * i + 1]) for i in range(n_par)]
            outs = [(w[out_tab + 2 * c], w[out_tab + 2 * c + 1]) for c in range(n_out)]
            recs.append((_BY_OP[op], arg, ins, pars, outs, srow))
        return recs


def _validate(program, planes, state, rows, K, block_size):
    """Check the operands against the program; returns (K, B)."""
    if not isinstance(program, ChainProgram):
        raise TypeError(f"{KERNEL}: program must be a ChainProgram")
    if not isinstance(state, torch.Tensor):
        raise TypeError(f"{KERNEL}: state must be a tensor")
    K, B = int(K), int(block_size)
    if K < 1 or B < 1:
        raise ValueError(f"{KERNEL}: K and block_size must be at least 1, got {K}, {B}")
    dev = state.device
    bc.check(KERNEL, "state", state, torch.int32, (program.n_state, K), dev)
    if planes.dim() != 3 or planes.shape[0] < program.n_planes:
        raise ValueError(f"{KERNEL}: planes must be [>= {program.n_planes}, K, B]")
    bc.check(KERNEL, "planes", planes, torch.float32, (planes.shape[0], K, B), dev)
    bc.check(KERNEL, "rows", rows, torch.float32,
             (program.n_ext + program.n_carry, B), dev)
    return K, B


def chain_kernel(program, *, planes, state, rows, K, block_size, f2pi, scale):
    """One block of one collapsed chain.

    program: the ``ChainProgram`` of the chain.
    planes:  f32 [n_planes, K, B] — the stage-stacked float param planes.
    state:   int32 [n_state, K] — the state words (u32 bit patterns).
    rows:    f32 [n_ext + n_carry, B] — the external rows, then the carry
             rows stage 0 reads.
    f2pi, scale: f32-representable floats (SinWt's phase units per Hz and
             radians per table index).

    Returns (out f32 [n_out, K, B], state_out int32 [n_state, K]), new
    tensors. CPU tensors run ``chain_kernel_plain``; CUDA tensors launch the
    kernel."""
    operands = dict(planes=planes, state=state, rows=rows, K=K,
                    block_size=block_size, f2pi=f2pi, scale=scale)
    if state.device.type == "cpu":
        return chain_kernel_plain(program, **operands)
    outs = empty_outputs(program, state.device, K, block_size)
    launch(outs, program, **operands)
    return outs


def empty_outputs(program, device, K, block_size):
    """The kernel's output buffers: (out [n_out, K, B], state_out [n_state, K])."""
    return (torch.empty((program.n_out, int(K), int(block_size)), dtype=torch.float32,
                        device=device),
            torch.empty((program.n_state, int(K)), dtype=torch.int32, device=device))


def launch(outs, program, *, planes, state, rows, K, block_size, f2pi, scale):
    """Launch the CUDA kernel on the current stream, writing ``outs`` (from
    ``empty_outputs``). Raises for anything but CUDA tensors of the layout the
    program needs, and if the launch fails."""
    global LAUNCHES
    K, B = _validate(program, planes, state, rows, K, block_size)
    device = state.device
    bc.require_cuda(KERNEL, device)
    out, state_out = outs
    bc.check(KERNEL, "out", out, torch.float32, (program.n_out, K, B), device)
    bc.check(KERNEL, "state_out", state_out, torch.int32, (program.n_state, K), device)
    smem_floats = (program.n_slots + program.n_carry) * B
    if smem_floats * 4 > 227 * 1024:
        raise ValueError(
            f"{KERNEL}: {program.n_slots + program.n_carry} rows of {B} samples "
            "exceed the 227 KB of shared memory a block can hold")

    from .build import load_library

    lib = load_library(KERNEL)
    prog = program.on(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_chain_kernel(
            bc.ptr(prog), bc.ptr(planes), bc.ptr(state), bc.ptr(rows), bc.ptr(out),
            bc.ptr(state_out), K, B, smem_floats, ctypes.c_float(f2pi),
            ctypes.c_float(scale), ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1


def chain_kernel_plain(program, *, planes, state, rows, K, block_size, f2pi, scale):
    """``chain_kernel`` in plain torch: the same program, a Python loop over
    the K stages and p offsets with [B]-wide ops, each body's plain version
    in the kernel's order, on whatever device the tensors are on."""
    K, B = _validate(program, planes, state, rows, K, block_size)
    consts = (float(np.float32(f2pi)), float(np.float32(scale)))
    recs = program.records()
    n_ext = program.n_ext
    carry_src = program.words[HEADER:HEADER + program.n_carry]
    carry = [rows[n_ext + i] for i in range(program.n_carry)]
    words = bc.u32_of(state)
    new_words = [[None] * K for _ in range(program.n_state)]
    out = torch.zeros((program.n_out, K, B), dtype=torch.float32, device=state.device)
    for k in range(K):
        slots = {}

        def fetch(kind, idx):
            if kind == SRC_SLOT:
                return slots[idx]
            if kind == SRC_CARRY:
                return carry[idx]
            if kind == SRC_ROW:
                return rows[idx]
            return planes[idx, k]

        for body, arg, ins, pars, outs, srow in recs:
            in_rows = []
            for srcs in ins:
                if not srcs:
                    in_rows.append(torch.zeros((B,), dtype=torch.float32,
                                               device=state.device))
                    continue
                acc = fetch(*srcs[0])
                for s in srcs[1:]:
                    acc = acc + fetch(*s)
                in_rows.append(acc)
            st = [words[srow + i, k] for i in range(body.n_words)]
            vals, new = body.plain(arg, in_rows, [fetch(*s) for s in pars], st, consts)
            for i, w in enumerate(new):
                new_words[srow + i][k] = w
            for (slot, plane), v in zip(outs, vals):
                slots[slot] = v
                if plane >= 0:
                    out[plane, k] = v
        carry = [slots[s] for s in carry_src]
    state_out = (bc.i32_of(torch.stack([torch.stack(r) for r in new_words]))
                 if program.n_state else torch.empty_like(state))
    return out, state_out
