"""The fused FM cascade kernel: wrapper, plain torch version and launch count.

Replaces ``knaster_tpu/models/voices.py::FMCascade._process_pallas`` (the
Pallas TPU kernel at :661) with the CUDA C++ kernel in
``csrc/fm_cascade.cu``, built for sm_90a by ``kernels/build.py``.

Per block it computes what the Pallas kernel computes: stage 0 at ``freq``,
stage k at ``base + depth * out[k-1]``, each stage's u32 phase from the
prefix sum of its saturating increments, the sine of the 16384-grid table
index, and the last stage times ``amp``. The four params are block-rate
scalars; the phases are updated in place.

Saturation: the Pallas kernel clips ``freq * f2pi`` to
``[0, np.float32(2**31 - 1)]`` (= [0, 2^31]) and converts to int32, which
XLA saturates, so a stage at 96 kHz or more advances by 2^31 - 1 per sample
(the scan form's uint32 convert gives 2^31 instead). Both the kernel and
``fm_cascade_plain`` write that rule out explicitly.

What bounds it on an H100: N dependent stages, each one block scan and one
``sinf`` per sample, on one SM; see the kernel source.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``fm_cascade_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bank_common as bc

KERNEL = "fm_cascade"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p]

_TWO31 = float(np.float32(2.0**31 - 1))  # = 2^31


def _validate(params, phases, block_size):
    """Check the operands against the layout the kernel reads; returns (N, B)."""
    if not isinstance(phases, torch.Tensor) or phases.dim() != 1 or phases.shape[0] < 1:
        raise ValueError(f"{KERNEL}: phases must be a non-empty [N] tensor")
    N, B = phases.shape[0], int(block_size)
    if B < 1:
        raise ValueError(f"{KERNEL}: block_size must be at least 1, got {B}")
    dev = phases.device
    bc.check(KERNEL, "phases", phases, torch.int32, (N,), dev)
    bc.check(KERNEL, "params", params, torch.float32, (4,), dev)
    return N, B


def fm_cascade(*, params, phases, block_size, f2pi, scale):
    """One block of the cascade.

    params: f32 [4] — freq, base, depth, amp (block rate).
    phases: int32 [N] — the stages' u32 phases as bit patterns; updated in
            place.
    f2pi, scale: f32-representable floats (phase units per Hz, radians per
            table index).

    Returns the block f32 [B]. CPU tensors run ``fm_cascade_plain``; CUDA
    tensors launch the kernel."""
    if phases.device.type == "cpu":
        return fm_cascade_plain(params=params, phases=phases, block_size=block_size,
                                f2pi=f2pi, scale=scale)
    out = torch.empty((int(block_size),), dtype=torch.float32, device=phases.device)
    launch(out, params=params, phases=phases, block_size=block_size, f2pi=f2pi,
           scale=scale)
    return out


def launch(out, *, params, phases, block_size, f2pi, scale):
    """Launch the CUDA kernel on the current stream, writing ``out`` f32 [B]
    and the phases in place. Raises for anything but CUDA tensors of the
    documented layout, and if the launch fails."""
    global LAUNCHES
    N, B = _validate(params, phases, block_size)
    device = phases.device
    bc.require_cuda(KERNEL, device)
    bc.check(KERNEL, "out", out, torch.float32, (B,), device)

    from .build import load_library

    lib = load_library(KERNEL)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_fm_cascade(
            bc.ptr(params), bc.ptr(phases), bc.ptr(out), N, B,
            ctypes.c_float(f2pi), ctypes.c_float(scale), ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1


def inc_i32_sat(x):
    """The Pallas kernel's increment of a f32 row: clip to [0, 2^31], then
    int32 with saturation (2^31 -> 2^31 - 1); int64 values."""
    return x.clamp(0.0, _TWO31).to(torch.int64).clamp(max=2**31 - 1)


def fm_cascade_plain(*, params, phases, block_size, f2pi, scale):
    """``fm_cascade`` in plain torch, op for op in the kernel's order, on
    whatever device the tensors are on: a Python loop over the N stages with
    [B]-wide ops. u32 phases are carried as int64 (``cumsum`` of the
    increments is exact there) and written back in place as int32 bits."""
    N, B = _validate(params, phases, block_size)
    f2pi, scale = float(np.float32(f2pi)), float(np.float32(scale))
    freq, base, depth, amp = params[0], params[1], params[2], params[3]
    ph = bc.u32_of(phases)
    new_ph = []
    mod = None
    for k in range(N):
        f = freq.expand(B) if k == 0 else base + depth * mod
        inc = inc_i32_sat(f * f2pi)
        csum = torch.cumsum(inc, dim=0)
        phase_t = (ph[k] + csum - inc) & bc._U32_MASK
        idx = (phase_t >> 16) & 16383
        mod = torch.sin(idx.to(torch.float32) * scale)
        new_ph.append((ph[k] + csum[-1]) & bc._U32_MASK)
    phases.copy_(bc.i32_of(torch.stack(new_ph)))
    return mod * amp
