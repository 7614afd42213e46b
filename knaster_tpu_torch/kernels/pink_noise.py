"""PinkNoise's block kernel: wrapper, plain torch version and launch count.

No Pallas kernel precedes it: the JAX package renders ``PinkNoise`` in XLA
(``knaster_tpu/ugens/noise.py``). The plain version below is the port's
block function for it, ~700 small torch operations a block (three
Threefry-2x32 evaluations in u32 arithmetic, the Voss-McCartney octaves,
the base-16 prefix sum); on the card the host spends its time launching
them. ``csrc/pink_noise.cu`` computes the same block in one launch, bit-equal
to the plain version (see the kernel source).

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``pink_noise_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.dsp import cumsum_base16, recip
from ..ugens.noise import PINK_NOISE_OCTAVES as OCTAVES
from ..ugens.noise import advance_frame, block_uniforms
from . import bank_common as bc

KERNEL = "pink_noise"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

_STATE_DTYPES = {"seed": torch.int32, "frame": torch.int32, "counter": torch.int32}


def _validate(state, block_size):
    """Check the state against the layout the kernel reads; returns (leading
    shape, B, float dtype)."""
    lead = tuple(state["seed"].shape)
    B = int(block_size)
    if B < 1:
        raise ValueError(f"{KERNEL}: block_size must be at least 1, got {B}")
    dtype = state["pink"].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{KERNEL}: the state must be f32 or f64, not {dtype}")
    dev = state["seed"].device
    for name, want in _STATE_DTYPES.items():
        bc.check(KERNEL, name, state[name], want, lead, dev)
    for name, shape in (("whites", lead + (OCTAVES,)), ("always_on", lead), ("pink", lead)):
        bc.check(KERNEL, name, state[name], dtype, shape, dev)
    return lead, B, dtype


def pink_noise(state, block_size):
    """One block of PinkNoise instances of any leading shape ``[...]``.

    state: ``seed``, ``frame``, ``counter`` int32 ``[...]``; ``whites``
           ``[..., 9]``, ``always_on`` and ``pink`` ``[...]``, f32 or f64.

    Returns (the next state, out ``[..., 1, B]``). CPU tensors run
    ``pink_noise_plain``; CUDA tensors launch the kernel."""
    if state["seed"].device.type == "cpu":
        return pink_noise_plain(state, block_size)
    return launch(state, block_size)


_LIB = []


def launch(state, block_size):
    """Launch the CUDA kernel on the current stream into new tensors;
    returns (the next state, out ``[..., 1, B]``). Raises for anything but
    CUDA tensors of the documented layout, and if the launch fails."""
    global LAUNCHES
    lead, B, dtype = _validate(state, block_size)
    device = state["seed"].device
    bc.require_cuda(KERNEL, device)
    if not _LIB:
        from .build import load_library

        _LIB.append(load_library(KERNEL))
    lib = _LIB[0]
    n = state["seed"].numel()
    out = torch.empty(lead + (1, B), dtype=dtype, device=device)
    ws = torch.empty((n, 2, B), dtype=dtype, device=device)
    new = {"seed": state["seed"],
           "frame": torch.empty_like(state["frame"]),
           "whites": torch.empty_like(state["whites"]),
           "always_on": torch.empty_like(state["always_on"]),
           "counter": torch.empty_like(state["counter"]),
           "pink": torch.empty_like(state["pink"])}
    p = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_pink_noise(
            p(state["seed"]), p(state["frame"]), p(state["whites"]), p(state["always_on"]),
            p(state["counter"]), p(state["pink"]), p(out), p(ws), p(new["whites"]),
            p(new["always_on"]), p(new["counter"]), p(new["frame"]), p(new["pink"]), n, B,
            int(dtype == torch.float64), ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1
    return new, out


def pink_noise_plain(state, block_size):
    """``pink_noise`` in plain torch on whatever device the state is on: the
    JAX package's vectorized recurrence, pink_t = pink_{t-1} - (octave
    i_t's previous x0) + x0_t - x1_{t-1} + x1_t, with i_t the trailing
    zeros of the counter and each octave's previous x0 found by a running
    max over the samples where it fired."""
    B = int(block_size)
    dtype = state["pink"].dtype
    u = block_uniforms(state["seed"], state["frame"], B, 2, dtype) * 2.0 - 1.0
    x0, x1 = u[..., 0], u[..., 1]
    dev = x0.device
    span = 2 ** (OCTAVES - 1)
    t = torch.arange(B, device=dev)
    counter = ((state["counter"].long().unsqueeze(-1) - 1 + t) & (span - 1)) + 1
    lsb = counter & -counter
    # its trailing zeros: the population count of lsb - 1
    idx = sum(((lsb - 1) >> b) & 1 for b in range(OCTAVES))
    octaves = torch.arange(OCTAVES, device=dev)
    fired = idx.unsqueeze(-2) == octaves.unsqueeze(-1)  # [..., O, B]
    occ = torch.where(fired, t, torch.full_like(t, -1))
    cm = torch.cummax(occ, dim=-1).values
    prev = torch.cat([torch.full_like(cm[..., :1], -1), cm[..., :-1]], dim=-1)
    x0o = x0.unsqueeze(-2).expand(fired.shape)
    whites = state["whites"].unsqueeze(-1)
    val = torch.where(prev >= 0, torch.gather(x0o, -1, prev.clamp(min=0)), whites)
    removed = torch.where(fired, val, torch.zeros((), dtype=dtype, device=dev)).sum(-2)
    last = cm[..., -1:]
    new_whites = torch.where(last >= 0, torch.gather(x0o, -1, last.clamp(min=0)),
                             whites)[..., 0]
    x1_prev = torch.cat([state["always_on"].unsqueeze(-1), x1[..., :-1]], dim=-1)
    pink = state["pink"].unsqueeze(-1) + cumsum_base16(x0 - removed + x1 - x1_prev)
    out = pink * recip(OCTAVES + 1.0, pink)
    new_counter = ((state["counter"].long() - 1 + B) & (span - 1)) + 1
    new_state = {"seed": state["seed"], "frame": advance_frame(state["frame"], B),
                 "whites": new_whites, "always_on": x1[..., -1],
                 "counter": new_counter.to(torch.int32), "pink": pink[..., -1]}
    return new_state, out.unsqueeze(-2)
