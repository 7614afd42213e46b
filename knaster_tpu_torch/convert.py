"""Carry state between the JAX package and this port: a fused bank's, a compiled graph's.

A JAX kernel bank's state (``PallasSineVoiceBank``, ``PallasFMVoiceBank``,
``PallasSubtractiveVoiceBank``, ``PallasWavetableVoiceBank``,
``PallasVoiceBank``) holds the ramp state ``fvals/ftarget/fstep`` f32
``[nf, V]`` and ``felapsed/fdur/fsdur`` i32 ``[nf, V]``, ``ivals`` i32
``[0, V]``, the flags ``active/idle`` bool ``[V]``, and the kernel's
per-voice state as ``[R, 128]`` tiles (R = V / 128): u32 phases and f32
envelope, filter and generic carry values. The port keeps the per-voice
tiles flat as ``[V]`` (row-major, voice = r * 128 + lane) and every u32 as
its int32 bit pattern.

The conversion decides by dtype and shape, not by key names, so every
bank's state (``phase``, ``phm``, ``phc``, ``ic1``, ``ic2``, ``et``, a
generic carry...) crosses alike: uint32 becomes int32 bits, and a 2-D
array of shape ``(V / 128, 128)`` is a tile (V from ``active``). Events
need no converter: both packages' ``node_events_from_lists`` return the
same numpy dict.

A compiled graph's state ``{"nodes", "pe", "fb"}`` has the same keys in
both packages for the same graph (the plan, and so every state, group and
chain key, is the JAX package's), so it crosses leaf by leaf: batched
groups and chain stacks keep their leading axes, uint32 leaves (oscillator
phases) become int32 bit patterns, everything else keeps its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128


def _is_tile(v, n_voices):
    return v.ndim == 2 and v.shape == (n_voices // LANES, LANES)


def bank_state_from_jax(np_state, device):
    """The port's state on ``device`` from a JAX bank state given as numpy
    arrays (``{k: np.asarray(v)}``). A ramp array of shape [1, 128] (one
    float param at V = 128) would read as a tile; no bank has one."""
    n_voices = np.asarray(np_state["active"]).shape[0]
    out = {}
    for k, v in np_state.items():
        v = np.array(v)  # a writable copy: arrays from JAX are read-only
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        if _is_tile(v, n_voices) and n_voices % LANES == 0:
            v = v.reshape(-1)
        out[k] = torch.from_numpy(v).to(device)
    return out


def bank_state_to_numpy(state):
    """The inverse of ``bank_state_from_jax``: numpy arrays in the JAX
    layout. Every 1-D per-voice tensor but the bool flags becomes a
    ``[V/128, 128]`` tile, int32 ones as uint32 (needs V to be a multiple
    of 128, as the JAX banks do)."""
    out = {}
    for k, v in state.items():
        v = v.detach().cpu().numpy()
        if v.ndim == 1 and v.dtype != np.bool_:
            if v.shape[0] % LANES:
                raise ValueError(
                    f"{k}: V={v.shape[0]} is not a multiple of {LANES}, "
                    "which the JAX layout needs")
            v = v.reshape(-1, LANES)
            if v.dtype == np.int32:
                v = v.view(np.uint32)
        out[k] = v
    return out


def graph_state_from_jax(np_state, device):
    """The port's graph state on ``device`` from a JAX ``CompiledGraph``
    state given as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    proc.state)``), for the same graph compiled by the port."""
    if isinstance(np_state, dict):
        return {k: graph_state_from_jax(v, device) for k, v in np_state.items()}
    v = np.array(np_state)  # a writable copy: arrays from JAX are read-only
    if v.dtype == np.uint32:
        v = v.view(np.int32)
    return torch.from_numpy(v).to(device)


def graph_state_to_numpy(state, like=None):
    """The inverse of ``graph_state_from_jax``: numpy arrays, int32 leaves
    viewed as uint32 where ``like`` (a JAX state of the same graph) holds
    uint32, kept as int32 without it."""
    if isinstance(state, dict):
        return {k: graph_state_to_numpy(v, None if like is None else like[k])
                for k, v in state.items()}
    v = state.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32 and v.dtype == np.int32:
        v = v.view(np.uint32)
    return v
