"""Carry a sine bank's state between the JAX package and this port.

The JAX ``PallasSineVoiceBank`` state holds ``fvals/ftarget/fstep`` f32
``[3, V]``, ``felapsed/fdur/fsdur`` i32 ``[3, V]``, ``ivals`` i32 ``[0, V]``,
``active/idle`` bool ``[V]``, ``phase`` u32 ``[R, 128]`` and
``stage/t/rscale`` f32 ``[R, 128]``. The port keeps the per-voice tiles flat
as ``[V]`` (row-major, voice = r * 128 + lane) and the phase as the int32
bit pattern of the u32. Events need no converter: both packages'
``node_events_from_lists`` return the same numpy dict.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128
_TILE_KEYS = ("phase", "stage", "t", "rscale")


def bank_state_from_jax(np_state, device):
    """The port's state on ``device`` from a JAX bank state given as numpy
    arrays (``{k: np.asarray(v)}``)."""
    out = {}
    for k, v in np_state.items():
        v = np.array(v)  # a writable copy: arrays from JAX are read-only
        if k == "phase":
            v = v.astype(np.uint32).view(np.int32)
        if k in _TILE_KEYS:
            v = v.reshape(-1)
        out[k] = torch.from_numpy(v).to(device)
    return out


def bank_state_to_numpy(state):
    """The inverse of ``bank_state_from_jax``: numpy arrays in the JAX
    layout (needs V to be a multiple of 128, as the JAX bank does)."""
    out = {}
    for k, v in state.items():
        v = v.detach().cpu().numpy()
        if k in _TILE_KEYS:
            if v.shape[0] % LANES:
                raise ValueError(
                    f"{k}: V={v.shape[0]} is not a multiple of {LANES}, "
                    "which the JAX layout needs")
            v = v.reshape(-1, LANES)
        if k == "phase":
            v = v.view(np.uint32)
        out[k] = v
    return out
