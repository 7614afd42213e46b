"""BufferReader's block kernel: wrapper and launch count (the plain version in the UGen's module).

No Pallas kernel precedes it: the JAX package renders ``BufferReader`` as a
``lax.scan`` in XLA (``knaster_tpu/ugens/buffer.py:109``). The plain version,
``ugens/buffer.py buffer_reader_block``, is a loop over the block's samples
of ~25 small torch operations each; on the card the host spends its time
launching them. ``csrc/buffer_reader.cu`` computes the same block in one
launch, bit-equal to the plain version (see the kernel source).

The block's window arithmetic stays with the caller
(``ugens/buffer.py BufferReader.process``); both versions take it as
``[..., B]`` planes: ``s_int`` (int32) and ``s_frac``, the window's start
frame split into its floor and fraction; ``end``, the end frame; ``step``,
the pointer's step a sample; ``looping`` and ``restart`` (bool).

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``buffer_reader_block``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..ugens.buffer import buffer_reader_block
from . import bank_common as bc

KERNEL = "buffer_reader"
# kernel launches since import (or since a caller reset it), and their
# tally by block length (B: launches)
LAUNCHES = 0
LAUNCHES_BY_BLOCK = {}

ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def buffer_reader(buf, state, s_int, s_frac, end, step, looping, restart):
    """One block of BufferReader instances of any leading shape ``[...]``.

    buf:   the samples, ``[channels, frames]`` of the state's float dtype.
    state: ``ptr_int`` int32, ``ptr_frac`` f32 or f64, ``finished`` bool,
           each ``[...]``.
    The planes broadcast to ``[..., B]`` (see the module docstring).

    Returns (the next state, out ``[..., channels, B]``, done ``[..., B]``
    bool). CPU tensors run ``buffer_reader_block``; CUDA tensors launch
    the kernel."""
    if state["ptr_frac"].device.type == "cpu":
        return buffer_reader_block(buf, state, s_int, s_frac, end, step, looping, restart)
    return launch(buf, state, s_int, s_frac, end, step, looping, restart)


_LIB = []


def _planes(lead, B, dtype, device, s_int, s_frac, end, step, looping, restart):
    """The planes as contiguous ``[n, B]`` tensors of the kernel's types:
    int32, the float dtype (the plain version's promotions: its ``where``,
    add and compare take the wider type, into which these convert
    exactly) and bytes for the flags."""
    shape = lead + (B,)

    def plane(x, dt):
        x = x.to(device=device, dtype=dt)
        return x.expand(shape).contiguous() if tuple(x.shape) != shape else x.contiguous()

    return (plane(s_int, torch.int32), plane(s_frac, dtype), plane(end, dtype),
            plane(step, dtype), plane(looping, torch.bool), plane(restart, torch.bool))


def launch(buf, state, s_int, s_frac, end, step, looping, restart):
    """Launch the CUDA kernel on the current stream into new tensors;
    returns what ``buffer_reader`` returns. Raises for anything but CUDA
    tensors of the documented layout, and if the launch fails."""
    global LAUNCHES
    pf = state["ptr_frac"]
    device, dtype, lead = pf.device, pf.dtype, tuple(pf.shape)
    bc.require_cuda(KERNEL, device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{KERNEL}: the state must be f32 or f64, not {dtype}")
    B = int(restart.shape[-1])
    if B < 1 or buf.dim() != 2 or buf.shape[1] < 1:
        raise ValueError(f"{KERNEL}: needs B >= 1 and a [channels, frames] buffer, got "
                         f"B = {B} and {tuple(buf.shape)}")
    C, frames = int(buf.shape[0]), int(buf.shape[1])
    bc.check(KERNEL, "buf", buf, dtype, (C, frames), device)
    bc.check(KERNEL, "ptr_int", state["ptr_int"], torch.int32, lead, device)
    bc.check(KERNEL, "ptr_frac", pf, dtype, lead, device)
    bc.check(KERNEL, "finished", state["finished"], torch.bool, lead, device)
    planes = _planes(lead, B, dtype, device, s_int, s_frac, end, step, looping, restart)
    if not _LIB:
        from .build import load_library

        _LIB.append(load_library(KERNEL))
    lib = _LIB[0]
    n = pf.numel()
    out = torch.empty(lead + (C, B), dtype=dtype, device=device)
    done = torch.empty(lead + (B,), dtype=torch.bool, device=device)
    new = {"ptr_int": torch.empty_like(state["ptr_int"]), "ptr_frac": torch.empty_like(pf),
           "finished": torch.empty_like(state["finished"])}
    p = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_buffer_reader(
            p(buf), p(state["ptr_int"]), p(pf), p(state["finished"]), *map(p, planes),
            p(out), p(done), p(new["ptr_int"]), p(new["ptr_frac"]), p(new["finished"]), n, B,
            C, frames, int(dtype == torch.float64), ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1
    LAUNCHES_BY_BLOCK[B] = LAUNCHES_BY_BLOCK.get(B, 0) + 1
    return new, out, done
