"""EnvAsr's block kernel: wrapper and launch count (the plain version in the UGen's module).

No Pallas kernel precedes it: the JAX package renders ``EnvAsr.process``
in XLA (``knaster_tpu/ugens/envelopes.py:157``). The port's plain version
(``ugens/envelopes.py asr_block``: ``EnvAsr._step`` sample by sample, or
event-free the closed form ``asr_closed_form``) is ~20 small torch operations a sample on
the first path and ~190 a block on the second, which on the card leave the
host launching. ``csrc/env_asr.cu`` computes the block in one launch on
either path, bit-equal to the plain version (see the kernel source).

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``asr_block``. Nothing falls back.

The closed form keeps an instance's rows in shared memory where they fit
(``workspace_len`` is 0) and otherwise in a global workspace the wrapper
allocates; ``launch_global`` forces that layout (tests and timing).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.dsp import cumsum, cumsum_base16
from ..ugens.envelopes import asr_block
from . import bank_common as bc

KERNEL = "env_asr"
# kernel launches since import (or since a caller reset it), and their
# tally by block length and path ("704 base16": launches)
LAUNCHES = 0
LAUNCHES_BY_BLOCK = {}

ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# the kernel's modes: the state machine, the closed form over either scan
STEP, HILLIS_STEELE, BASE16 = 0, 1, 2
_SCANS = {cumsum: HILLIS_STEELE, cumsum_base16: BASE16}
PATHS = {STEP: "step", HILLIS_STEELE: "hillis_steele", BASE16: "base16"}


def env_asr(state, atk, rel, restart, release, closed_form, scan=cumsum):
    """One block of EnvAsr instances of any leading shape ``[...]``.

    state: ``stage`` int32, ``t`` and ``release_scale`` ``[...]``; atk and
    rel the rates, restart and release (bool) broadcasting to ``[..., B]``;
    ``closed_form``: the event-free closed form (``asr_closed_form`` over
    the prefix sum ``scan``, core/dsp ``cumsum`` or ``cumsum_base16``), else
    the state machine sample by sample. Returns (stage, t, release_scale,
    out [..., B], done [..., B]). CPU tensors run ``asr_block`` (the plain
    version); CUDA tensors launch the kernel."""
    if state["t"].device.type == "cpu":
        return asr_block(state, atk, rel, restart, release, closed_form, scan)
    return launch(state, atk, rel, restart, release, closed_form, scan)


_LIB = []


def _lib():
    if not _LIB:
        from .build import load_library

        lib = load_library(KERNEL)
        lib.ktt_env_asr_workspace.restype = ctypes.c_longlong
        lib.ktt_env_asr_workspace.argtypes = [ctypes.c_int] * 4
        _LIB.append(lib)
    return _LIB[0]


def workspace_len(B, dtype, mode, global_rows=False):
    """The global workspace values an instance takes at B on the path
    ``mode`` (the kernel's own rule, ``ktt_env_asr_workspace``): 0 where
    the closed form's rows fit shared memory and for the state machine;
    ``global_rows`` forces the workspace on the closed form."""
    return int(_lib().ktt_env_asr_workspace(int(B), int(mode), int(dtype == torch.float64),
                                            int(bool(global_rows))))


def launch(state, atk, rel, restart, release, closed_form, scan):
    """Launch the CUDA kernel on the current stream into new tensors;
    returns what ``env_asr`` returns. Raises for anything but CUDA tensors
    of one float dtype or an unknown scan, and if the launch fails."""
    return _launch(state, atk, rel, restart, release, closed_form, scan, False)


def launch_global(state, atk, rel, restart, release, closed_form, scan):
    """``launch`` with the closed form's rows in the global workspace
    whatever B (the layout past shared memory)."""
    return _launch(state, atk, rel, restart, release, closed_form, scan, True)


def _launch(state, atk, rel, restart, release, closed_form, scan, global_rows):
    global LAUNCHES
    t = state["t"]
    device, dtype, lead = t.device, t.dtype, tuple(t.shape)
    bc.require_cuda(KERNEL, device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{KERNEL}: the state must be f32 or f64, not {dtype}")
    mode = STEP
    if closed_form:
        if scan not in _SCANS:
            raise ValueError(f"{KERNEL}: no kernel for the scan {scan}")
        mode = _SCANS[scan]
    B = int(atk.shape[-1])
    shape = lead + (B,)
    bc.check(KERNEL, "stage", state["stage"], torch.int32, lead, device)
    bc.check(KERNEL, "release_scale", state["release_scale"], dtype, lead, device)
    rows = [r.to(device, dtype).expand(shape).contiguous() for r in (atk, rel)]
    trig = [r.to(device, torch.bool).expand(shape).contiguous() for r in (restart, release)]
    lib = _lib()
    n = max(1, t.numel())
    out = torch.empty(shape, dtype=dtype, device=device)
    done = torch.empty(shape, dtype=torch.bool, device=device)
    stage_out = torch.empty_like(state["stage"])
    t_out, rs_out = torch.empty_like(t), torch.empty_like(state["release_scale"])
    per = workspace_len(B, dtype, mode, global_rows)
    ws = torch.empty((n, per), dtype=dtype, device=device) if per else None
    p = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_env_asr(p(state["stage"]), p(t), p(state["release_scale"]), *map(p, rows),
                              *map(p, trig), p(out), p(done), p(stage_out), p(t_out), p(rs_out),
                              p(ws), n, B, mode, int(dtype == torch.float64),
                              ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1
    key = f"{B} {PATHS[mode]}"
    LAUNCHES_BY_BLOCK[key] = LAUNCHES_BY_BLOCK.get(key, 0) + 1
    return stage_out, t_out, rs_out, out, done
