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
same numpy dict. A sharded bank's state crosses as its bank's: the JAX
package's global state is the full bank's, and the port's per-shard
state is that state split over the port's mesh (``parallel/mesh.py``).

A compiled graph's state ``{"nodes", "pe", "fb"}`` has the same keys in
both packages for the same graph (the plan, and so every state, group and
chain key, is the JAX package's), so it crosses leaf by leaf: batched
groups and chain stacks keep their leading axes, uint32 leaves (oscillator
and PolyBlep phases) become int32 bit patterns, everything else keeps its
dtype (the SVF's ``ic`` [..., 2] and the one-poles' ``last`` as f32, the
envelopes' ``stage`` as int32 beside their f32 ``t`` and ``release_scale``,
the multi-segment ``Envelope``'s ``running`` bool, ``seg`` and
``last_jump`` int32, ``time`` and ``from_value``, a
``ModalResonator``'s ``s0``/``s1`` [..., M], a ``BufferReader``'s int32
``ptr_int``, ``ptr_frac`` and bool ``finished``, a ``GrainPlayer``'s u32
``seed`` and ``counter`` as int32 bits beside its per-slot ``age`` and
grain values, a ``Convolver``'s spectra ``Hr``/``Hi`` and delay line
``fdl_r``/``fdl_i``/``prev``). A kernel bank node's state
crosses as a bank's does: its ``[R, 128]`` tiles (the generic bank's
carries, the Envelope and Modal bodies' included) flat in voice order.

The composable ``VoiceBank`` (the JAX package's vmap bank) holds the same
ramp arrays and flags and, under ``voices``, its voice's state tree
replicated over the voice axis. That subtree crosses leaf by leaf in both
directions: ``[V, ...]`` leaves keep their axes (no tiles), a uint32 leaf
(an oscillator or PolyBlep phase, a PluckedVoice frame) becomes its int32
bit pattern, and the voice's unbatched ``shared_state_keys`` leaves stay
scalars (a ``SamplerVoice``'s ``pos_int``, ``pos_frac``, ``playing`` and
nested ``env`` cross as ``[V]`` leaves). Going back, an int32 leaf becomes uint32 where ``like`` (the JAX
state) holds uint32.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128


def _is_tile(v, n_voices):
    return v.ndim == 2 and v.shape == (n_voices // LANES, LANES)


def _leaf_from_jax(v, device):
    v = np.array(v)  # a writable copy: arrays from JAX are read-only
    if v.dtype == np.uint32:
        v = v.view(np.int32)
    return torch.from_numpy(v).to(device)


def _tree_from_jax(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_jax(v, device) for k, v in tree.items()}
    return _leaf_from_jax(tree, device)


def _tree_to_numpy(tree, like=None):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v, None if like is None else like[k])
                for k, v in tree.items()}
    v = tree.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32 and v.dtype == np.int32:
        v = v.view(np.uint32)
    return v


def bank_state_from_jax(np_state, device):
    """The port's state on ``device`` from a JAX bank state given as numpy
    arrays (``{k: np.asarray(v)}``; a vmap bank's ``voices`` subtree as a
    nested dict of them). A ramp array of shape [1, 128] (one float param
    at V = 128) would read as a tile; no bank has one."""
    n_voices = np.asarray(np_state["active"]).shape[0]
    out = {}
    for k, v in np_state.items():
        if isinstance(v, dict):  # a vmap bank's voices: leaf by leaf
            out[k] = _tree_from_jax(v, device)
            continue
        v = np.array(v)  # a writable copy: arrays from JAX are read-only
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        if _is_tile(v, n_voices) and n_voices % LANES == 0:
            v = v.reshape(-1)
        out[k] = torch.from_numpy(v).to(device)
    return out


def bank_state_to_numpy(state, like=None):
    """The inverse of ``bank_state_from_jax``: numpy arrays in the JAX
    layout. Every 1-D per-voice tensor but the bool flags becomes a
    ``[V/128, 128]`` tile, int32 ones as uint32 (needs V to be a multiple
    of 128, as the JAX banks do). A vmap bank's ``voices`` subtree keeps
    its shapes, its int32 leaves uint32 where ``like`` (the JAX bank's
    state) holds uint32."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = _tree_to_numpy(v, None if like is None else like[k])
            continue
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


def sharded_state_from_jax(np_state, sharded):
    """The port's per-shard state for ``sharded`` (a ``ShardedVoiceBank``)
    from a JAX ``ShardedVoiceBank``'s global state given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, state)``): the bank's state as
    ``bank_state_from_jax`` has it, split over the port's mesh, each shard
    on its device."""
    return sharded.node.split(sharded.ctx, bank_state_from_jax(np_state, "cpu"))


def sharded_state_to_numpy(state, sharded, like=None):
    """The inverse of ``sharded_state_from_jax``: the shards joined into the
    full bank's state and given as ``bank_state_to_numpy`` gives it, in the
    JAX layout of the global state."""
    return bank_state_to_numpy(sharded.node.join(sharded.ctx, state), like)


def _is_bank_state(tree):
    return isinstance(tree, dict) and "fvals" in tree and "active" in tree


def graph_state_from_jax(np_state, device):
    """The port's graph state on ``device`` from a JAX ``CompiledGraph``
    state given as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    proc.state)``), for the same graph compiled by the port. A kernel
    bank's node state crosses as ``bank_state_from_jax`` has it (its tiles
    flat in voice order)."""
    if _is_bank_state(np_state):
        return bank_state_from_jax(np_state, device)
    if isinstance(np_state, dict):
        return {k: graph_state_from_jax(v, device) for k, v in np_state.items()}
    return _leaf_from_jax(np_state, device)


def graph_state_to_numpy(state, like=None):
    """The inverse of ``graph_state_from_jax``: numpy arrays, int32 leaves
    viewed as uint32 where ``like`` (a JAX state of the same graph) holds
    uint32, kept as int32 without it; a bank's node state as
    ``bank_state_to_numpy`` has it."""
    if _is_bank_state(state):
        return bank_state_to_numpy(state, like)
    if isinstance(state, dict):
        return {k: graph_state_to_numpy(v, None if like is None else like[k])
                for k, v in state.items()}
    return _tree_to_numpy(state, like)
