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

What bounds it on an H100: the N dependent stages, each one block scan of
the increments and one sine a sample: N times a stage's latency, far from
the card's arithmetic rate or bandwidth. The kernel spreads a long block
over a thread-block cluster of CTAs that each own a slice of the samples
and exchange only their increment totals once a stage (``launch_plan``),
and reads the sines from a table of ``sinf`` at every grid index where a
CTA evaluates at least twice as many sines as the table holds; see the
kernel source.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``fm_cascade_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import bank_common as bc
from .chain_kernel import MAX_CLUSTER

KERNEL = "fm_cascade"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p]

_TWO31 = float(np.float32(2.0**31 - 1))  # = 2^31
# the longest block the kernel takes (FMCascade's superblock cap): a [B]
# row of shared memory within the 227 KB a block can hold, less 32 static
# words, as the one-CTA kernel took before its second scan buffer; one CTA
# now holds ONE_CTA_MAX samples, a cluster up to MAX_BLOCK and past it
MAX_BLOCK = (227 * 1024 - 128) // 4
ONE_CTA_MAX = (227 * 1024 - 256) // 4
# The layout rule (launch_plan), the chain kernel's values measured again
# for this kernel on an H100 (PERF.md §6): one CTA up to SHARED_SAMPLES
# samples (at 1024 it beat every cluster), past that a cluster of CTAs of at
# most CLUSTER_CHUNK samples each (16 of 512 the fastest at 8192)
SHARED_SAMPLES = 1024
CLUSTER_CHUNK = 512


@dataclass(frozen=True)
class LaunchPlan:
    """The CTAs of a launch (1: one CTA, no cluster), the samples each owns
    (``chunk``: B for one CTA, else a multiple of 32; the last CTAs hold
    what is left of B, maybe nothing) and its threads a CTA."""

    cluster: int
    chunk: int
    threads: int


def launch_plan(block_size, *, cluster=None, max_cluster=MAX_CLUSTER) -> LaunchPlan:
    """The layout of a launch at ``block_size``, chosen before it: one CTA
    where B is at most ``SHARED_SAMPLES``, else a cluster of the smallest
    power of two C (up to ``max_cluster``) whose chunks hold at most
    ``CLUSTER_CHUNK`` samples. ``cluster`` forces a size: 1 (one CTA, up
    to ``ONE_CTA_MAX`` samples) up to ``MAX_CLUSTER``; a forced layout that
    cannot hold the row raises ValueError. Every plan computes the same
    phases and block: u32 sums are exact in any split."""
    B = int(block_size)
    if not 1 <= B <= MAX_BLOCK:
        raise ValueError(f"{KERNEL}: block_size must be in [1, {MAX_BLOCK}], got {B}")
    if cluster is None:
        C = 1
        if B > SHARED_SAMPLES:
            C = 2
            while -(-B // C) > CLUSTER_CHUNK and C < max_cluster:
                C *= 2
    else:
        C = int(cluster)
        if not 1 <= C <= MAX_CLUSTER:
            raise ValueError(f"{KERNEL}: a cluster takes 1 to {MAX_CLUSTER} CTAs, not {C}")
        if C == 1 and B > ONE_CTA_MAX:
            raise ValueError(f"{KERNEL}: one CTA holds at most {ONE_CTA_MAX} samples, not {B}")
    chunk = B if C == 1 else _round32(-(-B // C))
    return LaunchPlan(C, chunk, min(1024, _round32(chunk)))


def _round32(n):
    return -(-n // 32) * 32


def _validate(params, phases, block_size):
    """Check the operands against the layout the kernel reads; returns (N, B)."""
    if not isinstance(phases, torch.Tensor) or phases.dim() != 1 or phases.shape[0] < 1:
        raise ValueError(f"{KERNEL}: phases must be a non-empty [N] tensor")
    N, B = phases.shape[0], int(block_size)
    if not 1 <= B <= MAX_BLOCK:
        raise ValueError(f"{KERNEL}: block_size must be in [1, {MAX_BLOCK}], got {B}")
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


_MAX_CLUSTER = {}


def card_max_cluster(lib, device) -> int:
    """The largest cluster ``launch_plan`` may take on ``device``'s card:
    ``MAX_CLUSTER`` where the card can hold a non-portable cluster that
    large, else the portable 8 (asked once per device)."""
    key = device.index
    if key not in _MAX_CLUSTER:
        got = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.ktt_fm_cascade_max_cluster(ctypes.byref(got))
        bc.raise_on_error(KERNEL, lib, err)
        _MAX_CLUSTER[key] = got.value
    return _MAX_CLUSTER[key]


_LIB = []


def _load():
    """The kernel library, its extra entry point declared (once)."""
    if not _LIB:
        from .build import load_library

        lib = load_library(KERNEL)
        lib.ktt_fm_cascade_max_cluster.restype = ctypes.c_int
        lib.ktt_fm_cascade_max_cluster.argtypes = [ctypes.POINTER(ctypes.c_int)]
        _LIB.append(lib)
    return _LIB[0]


def launch(out, *, params, phases, block_size, f2pi, scale, cluster=None):
    """Launch the CUDA kernel on the current stream, writing ``out`` f32 [B]
    and the phases in place, in the layout ``launch_plan`` picks for the
    card (``cluster`` forces one, as there). Raises for anything but CUDA
    tensors of the documented layout, and if the launch fails (a cluster the
    card refuses is reported, never replaced). Returns the plan."""
    global LAUNCHES
    N, B = _validate(params, phases, block_size)
    device = phases.device
    bc.require_cuda(KERNEL, device)
    bc.check(KERNEL, "out", out, torch.float32, (B,), device)
    lib = _load()
    plan = launch_plan(B, cluster=cluster, max_cluster=card_max_cluster(lib, device))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_fm_cascade(
            bc.ptr(params), bc.ptr(phases), bc.ptr(out), N, B, plan.cluster, plan.chunk,
            ctypes.c_float(f2pi), ctypes.c_float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{KERNEL}: the launch of {plan.cluster} CTA(s) of {plan.chunk} samples failed "
            f"with CUDA error {err} ({lib.ktt_error_string(err).decode()})")
    LAUNCHES += 1
    return plan


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
