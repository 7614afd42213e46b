"""Galactic's blockwise kernel: wrapper and launch count (the plain version in the UGen's module).

No Pallas kernel precedes it: the JAX package renders ``Galactic`` in XLA
(``knaster_tpu/airwindows/galactic.py:113``). The port's blockwise path
(``airwindows/galactic.py Galactic._process_blockwise``) keeps the block's
rates, line lengths and vibrato and dither streams as torch operations and
hands the rest of the block (the detune delay, both lowpasses' scans, the
three banks, the wet/dry mix and the dither) to ``galactic_block``: its
plain version, ``blockwise_rest``, is ~350 small torch operations, which on
the card leave the host launching. ``csrc/galactic.cu`` computes that rest
in one launch, bit-equal to the plain version (see the kernel source).

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``blockwise_rest``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..airwindows.galactic import blockwise_rest
from . import bank_common as bc

KERNEL = "galactic"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

ARGTYPES = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# the float leaves of the state and their shapes past the channel axis
_FLOAT_LEAVES = ("vib_buf", "feedback", "iir_a", "iir_b")


def galactic_block(state, inputs, attenuate, lowpass, regen, wet, off, tiny, fpd_seq, eff):
    """The rest of one blockwise Galactic block (see the module docstring).

    state: ``dbuf`` [2, 12, L], ``dpos`` int32 [2, 12], ``vib_buf`` [2,
    256], ``vib_pos`` int32 [2], ``feedback`` [2, 4], ``iir_a``, ``iir_b``
    [2]; inputs [2, B]; the rows attenuate, lowpass, regen, wet [B]; off and
    tiny [B, 2]; fpd_seq [B, 2] (u32 values as int64); eff int64 [12], each
    above B (the caller clamps them to B + 1: the kernel does not read them
    back to check). Returns (those seven leaves anew, the output [2, B]). CPU
    tensors run ``blockwise_rest``; CUDA tensors launch the kernel."""
    if inputs.device.type == "cpu":
        return blockwise_rest(state, inputs, attenuate, lowpass, regen, wet, off, tiny,
                              fpd_seq, eff)
    return launch(state, inputs, attenuate, lowpass, regen, wet, off, tiny, fpd_seq, eff)


_LIB = []


def launch(state, inputs, attenuate, lowpass, regen, wet, off, tiny, fpd_seq, eff):
    """Launch the CUDA kernel on the current stream into new tensors;
    returns what ``galactic_block`` returns. Raises for anything but CUDA
    tensors of the documented layout, and if the launch fails."""
    global LAUNCHES
    device, dtype = inputs.device, inputs.dtype
    bc.require_cuda(KERNEL, device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{KERNEL}: the input must be f32 or f64, not {dtype}")
    B = int(inputs.shape[-1])
    dbuf = state["dbuf"]
    L = int(dbuf.shape[-1])
    if tuple(inputs.shape) != (2, B) or B < 1 or tuple(eff.shape) != (12,):
        raise ValueError(f"{KERNEL}: needs a [2, B] input and 12 line lengths, got "
                         f"{tuple(inputs.shape)} and {tuple(eff.shape)}")
    bc.check(KERNEL, "dbuf", dbuf, dtype, (2, 12, L), device)
    bc.check(KERNEL, "dpos", state["dpos"], torch.int32, (2, 12), device)
    bc.check(KERNEL, "vib_pos", state["vib_pos"], torch.int32, (2,), device)
    for name, shape in zip(_FLOAT_LEAVES, ((2, 256), (2, 4), (2,), (2,))):
        bc.check(KERNEL, name, state[name], dtype, shape, device)
    rows = [r.to(device, dtype).expand(B).contiguous()
            for r in (attenuate, lowpass, regen, wet)]
    off, tiny = (x.to(device, dtype).contiguous() for x in (off, tiny))
    fpd = bc.i32_of(fpd_seq).contiguous()
    inputs = inputs.contiguous()
    eff = eff.to(device, torch.int64).contiguous()
    for name, x, shape in (("off", off, (B, 2)), ("tiny", tiny, (B, 2)), ("fpd_seq", fpd,
                                                                          (B, 2))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{KERNEL}: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not _LIB:
        from .build import load_library

        _LIB.append(load_library(KERNEL))
    lib = _LIB[0]
    out = torch.empty((2, B), dtype=dtype, device=device)
    new = {"dbuf": dbuf.clone(), "dpos": torch.empty_like(state["dpos"]),
           "vib_buf": torch.empty_like(state["vib_buf"]),
           "vib_pos": torch.empty_like(state["vib_pos"]),
           "feedback": torch.empty_like(state["feedback"]),
           "iir_a": torch.empty_like(state["iir_a"]), "iir_b": torch.empty_like(state["iir_b"])}
    ws = torch.empty(48 * B + 512, dtype=dtype, device=device)
    p = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_galactic(
            p(inputs), *map(p, rows), p(off), p(tiny), p(fpd), p(eff), p(dbuf),
            p(state["dpos"]), p(state["vib_buf"]), p(state["vib_pos"]), p(state["feedback"]),
            p(state["iir_a"]), p(state["iir_b"]), p(out), p(new["dbuf"]), p(new["dpos"]),
            p(new["vib_buf"]), p(new["vib_pos"]), p(new["feedback"]), p(new["iir_a"]),
            p(new["iir_b"]), p(ws), B, int(dtype == torch.float64), L, ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1
    return new, out
