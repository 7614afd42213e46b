"""Port of knaster_tpu/core/ugen.py: ``AudioCtx`` and the UGen protocol.

A UGen instance holds only static configuration (Python numbers, enums,
declared ``params``); runtime state lives in the dict of tensors its
``init`` returns, on the device the caller names.

* ``inputs`` / ``outputs`` — channel counts.
* ``params`` — the declared ``Param`` table, in order.
* ``init(ctx, device) -> state`` — a dict of tensors (``{}``: stateless).
* ``process(ctx, state, inputs, params) -> (state, out[, done])`` — one
  block. ``inputs`` is ``[..., inputs, B]``, ``params`` maps each name to a
  ``[..., B]`` tensor (ctx.dtype for floats, bool for triggers, int32 for
  integer and bool params), ``out`` is ``[..., outputs, B]`` and ``done``
  (optional) a bool ``[..., B]``. Where the JAX package ``vmap``s a batch of
  same-kind nodes, the port writes the batch out: every leading axis is a
  batch axis, and state leaves carry the same leading axes.
* ``host_int_params`` — int params whose value at a block's first sample
  ``process`` branches on: the graph renderer also passes each as
  ``params[name + "_host"]``, numpy of the leading shape, from the param
  engine's host copy, so that the branch costs no device-to-host read.
* ``kernel_stage(ctx)`` — the port's counterpart of ``mosaic_stage``: the
  chain-kernel body of this UGen (``graph/chain_kernel.py``), or None.

u32 state (oscillator phases) is held as its int32 bit pattern, as the
fused banks hold it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..primitives.params import Param


@dataclass(frozen=True)
class AudioCtx:
    """Static per-graph context (reference: knaster_core/src/ugen.rs:8 AudioCtx)."""

    sample_rate: int = 48000
    block_size: int = 64
    dtype: torch.dtype = torch.float32
    # True inside the event-free fast program: every trigger param is
    # all-False, so nodes may skip trigger machinery. Must not change what
    # ``process`` computes.
    no_events: bool = False
    # True when ``process`` runs over a WIDE batch (a voice bank): the
    # envelopes then keep their per-sample loop instead of the event-free
    # closed form, as in the JAX package. Must not change what ``process``
    # computes beyond float reassociation.
    wide_batch: bool = False

    @property
    def nyquist(self) -> float:
        return self.sample_rate / 2.0


class UGen:
    """Base class for unit generators. See the module docstring for the contract."""

    inputs: int = 0
    outputs: int = 1
    params: Tuple[Param, ...] = ()
    # Nodes with a private event channel (VoiceBank's per-voice events) set
    # this > 0 and build events with empty_node_events / node_events_from_lists.
    event_capacity: int = 0
    # True when ``process`` over k*B samples equals k calls of B samples
    # (state carried through). Nodes that are not keep their graph out of
    # superblocks unless they declare ``superblock_cap``.
    block_invariant: bool = True
    # The longest block (in samples) ``process`` takes as one superblock,
    # or None for no limit: a kernel's shared-memory ceiling, a blockwise
    # node's shortest delay. May be set in ``init``.
    superblock_cap: Optional[int] = None
    # True when ``process`` can return a done mask.
    may_set_done: bool = False
    # int params the renderer also passes on the host (module docstring)
    host_int_params: Tuple[str, ...] = ()

    def empty_node_events(self, dtype=None):
        raise NotImplementedError

    def node_events_from_lists(self, events, dtype=None):
        raise NotImplementedError

    def batch_key(self):
        """Key for the compiler's auto-batching and chain-collapse passes, or
        None: nodes at one dataflow depth with equal keys run as ONE call
        with a leading batch axis. Return a tuple identifying everything
        ``process`` reads from the instance; state shapes must agree."""
        return None

    # ---- overridable ------------------------------------------------------
    def init(self, ctx: AudioCtx, device="cpu"):
        """The initial state: a dict of tensors on ``device``. Default: stateless."""
        return {}

    def process(self, ctx: AudioCtx, state, inputs, params):
        raise NotImplementedError

    def kernel_stage(self, ctx: AudioCtx):
        """The chain-kernel body of this UGen, or None (default).

        When every unit of a collapsed chain has one, the event-free fast
        program runs the whole stage loop in ONE CUDA kernel
        (``csrc/chain_kernel.cu``) instead of the scan executor. Returns
        ``(body, arg)``: ``body`` is one of ``kernels.chain_kernel.BODIES`` (its
        opcode in the kernel's ``switch`` and its plain torch version), ``arg``
        an int the body reads (the Math op). The body must equal ``process``
        under the fast program's guarantees (no events)."""
        return None

    # ---- introspection ----------------------------------------------------
    def param_index(self, name_or_idx) -> int:
        if isinstance(name_or_idx, int):
            if not 0 <= name_or_idx < len(self.params):
                raise KeyError(f"param index {name_or_idx} out of range")
            return name_or_idx
        for i, p in enumerate(self.params):
            if p.name == name_or_idx:
                return i
        raise KeyError(f"{type(self).__name__} has no parameter {name_or_idx!r}")

    def param_names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    def name(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return (
            f"<{type(self).__name__} in={self.inputs} out={self.outputs} "
            f"params={[p.name for p in self.params]}>"
        )


# ---------------------------------------------------------------------------
# Helpers for writing UGens
# ---------------------------------------------------------------------------

def zeros_block(ctx: AudioCtx, channels: int, device="cpu") -> torch.Tensor:
    return torch.zeros((channels, ctx.block_size), dtype=ctx.dtype, device=device)


def ensure_done(done, ctx: AudioCtx, like: torch.Tensor):
    """``done`` or an all-False ``[..., B]`` mask shaped like ``like``'s
    leading axes (``like`` is the ``[..., outputs, B]`` output)."""
    if done is None:
        return torch.zeros(like.shape[:-2] + (ctx.block_size,), dtype=torch.bool,
                           device=like.device)
    return done


def normalize_process_result(result, ctx: AudioCtx):
    """Normalize a process() return to (state, out, done[..., B])."""
    if len(result) == 2:
        state, out = result
        done = None
    else:
        state, out, done = result
    return state, out, ensure_done(done, ctx, out)
