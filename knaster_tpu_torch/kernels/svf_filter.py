"""SvfFilter's block kernel: wrapper and launch count (the plain version in the UGen's module).

No Pallas kernel precedes it: the JAX package renders ``SvfFilter.process``
in XLA (``knaster_tpu/ugens/filters.py:158``). Its plain version here is
``ugens/filters.py svf_block``: the coefficients of every sample
(``svf_coefficients``, ~140 small torch operations) and a prefix scan of
the SVF's affine maps with the outputs (``core/dsp.py
affine_scan_2x2_rows``, ~30 a Hillis-Steele step), which on the card leave
the host launching. ``csrc/svf_filter.cu`` computes the whole block in one
launch, bit-equal to the plain version (see the kernel source).

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``svf_block``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..ugens.filters import svf_block
from . import bank_common as bc

KERNEL = "svf_filter"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def svf_filter(ic, x, ty, cutoff, q, gain, sample_rate):
    """One block of SvfFilter instances of any leading shape ``[...]``: ic
    ``[..., 2]``; the input x and the params' rows (the filter type, int;
    cutoff, q and gain in dB) broadcasting to ``[..., B]``. Returns (the
    next ic, y ``[..., B]``). CPU tensors run ``svf_block``; CUDA tensors
    launch the kernel."""
    if x.device.type == "cpu":
        return svf_block(ic, x, ty, cutoff, q, gain, sample_rate)
    return launch(ic, x, ty, cutoff, q, gain, sample_rate)


_LIB = []


def launch(ic, x, ty, cutoff, q, gain, sample_rate):
    """Launch the CUDA kernel on the current stream into new tensors;
    returns what ``svf_filter`` returns. Raises for anything but CUDA
    tensors of one float dtype, and if the launch fails."""
    global LAUNCHES
    device, dtype = x.device, x.dtype
    bc.require_cuda(KERNEL, device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{KERNEL}: the input must be f32 or f64, not {dtype}")
    if int(sample_rate) != sample_rate:
        raise ValueError(f"{KERNEL}: the sample rate must be a whole number, not {sample_rate}")
    rows = (x, cutoff, q, gain)
    shape = torch.broadcast_shapes(ic.shape[:-1] + (1,), ty.shape, *(r.shape for r in rows))
    lead, B = tuple(shape[:-1]), int(shape[-1])
    if B < 1 or ic.shape[-1] != 2:
        raise ValueError(f"{KERNEL}: needs B >= 1 and ic [..., 2], got B = {B}, ic "
                         f"{tuple(ic.shape)}")
    for name, r in zip(("ic", "x", "cutoff", "q", "gain", "ty"), (ic,) + rows + (ty,)):
        want = torch.int32 if name == "ty" else dtype
        if r.device != device or (r.dtype != want and name != "ty"):
            raise ValueError(f"{KERNEL}: {name} is {r.dtype} on {r.device}, expected {want} "
                             f"on {device}")
    ic = ic.expand(lead + (2,)).contiguous()
    ty = ty.to(torch.int32).expand(shape).contiguous()
    rows = [r.expand(shape).contiguous() for r in rows]
    if not _LIB:
        from .build import load_library

        _LIB.append(load_library(KERNEL))
    lib = _LIB[0]
    n = ic.numel() // 2
    y = torch.empty(shape, dtype=dtype, device=device)
    ic_out = torch.empty_like(ic)
    ws = torch.empty((n, 12, B), dtype=dtype, device=device)
    p = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_svf_filter(p(ic), p(rows[0]), p(ty), *map(p, rows[1:]), p(y), p(ic_out),
                                 p(ws), n, B, int(sample_rate), int(dtype == torch.float64),
                                 ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1
    return ic_out, y
