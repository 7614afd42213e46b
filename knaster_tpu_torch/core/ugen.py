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
* ``wr_mul(c)`` ... ``wr(fn)`` — the fluent wrapper combinators
  (``wrappers/math.py``); ``smooth_params``, ``ar_params`` and
  ``precise_timing`` are identities, since the param engine gives every
  node smoothing, audio-rate params and sample-accurate changes.

UGens written per sample use :func:`sample_scan` (the reference's default
``process_block`` loop, ugen.rs:263-284): a Python loop over the block.

u32 state (oscillator phases) is held as its int32 bit pattern, as the
fused banks hold it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

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

    # ---- fluent wrapper combinators (parity with UGenWrapperCoreExt,
    #      knaster_core_dsp/src/wrappers_core.rs:26-120) ---------------------
    def wr_mul(self, c):
        from ..wrappers.math import WrMul

        return WrMul(self, c)

    def wr_add(self, c):
        from ..wrappers.math import WrAdd

        return WrAdd(self, c)

    def wr_sub(self, c):
        from ..wrappers.math import WrSub

        return WrSub(self, c)

    def wr_v_sub(self, c):
        from ..wrappers.math import WrVSub

        return WrVSub(self, c)

    def wr_div(self, c):
        from ..wrappers.math import WrDiv

        return WrDiv(self, c)

    def wr_v_div(self, c):
        from ..wrappers.math import WrVDiv

        return WrVDiv(self, c)

    def wr_powf(self, c):
        from ..wrappers.math import WrPowf

        return WrPowf(self, c)

    def wr_powi(self, c):
        from ..wrappers.math import WrPowi

        return WrPowi(self, int(c))

    def wr(self, fn):
        from ..wrappers.math import WrClosure

        return WrClosure(self, fn)

    # In the reference these opt into per-node features
    # (wrappers_core/smooth_params.rs, audio_rate.rs, precise_timing.rs);
    # here the parameter engine gives every node smoothing, audio-rate and
    # sample-accurate changes, so they are identities kept for the API.
    def smooth_params(self):
        return self

    def ar_params(self):
        return self

    def precise_timing(self, max_changes_per_block: int = 0):
        return self

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


def tree_to(tree, device):
    """``tree`` (dicts, lists and tuples of tensors) with every tensor moved
    to ``device``: a user's state builder makes its tensors where it likes."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def per_instance(fn: Callable, inputs: torch.Tensor) -> Callable:
    """``fn(state, inputs, params)`` mapped over the leading batch axes of
    ``inputs`` (``[..., inputs, B]``) and of every state and param leaf
    with ``torch.func.vmap``, once per axis; ``fn`` itself where there are
    none. Where the JAX package ``vmap``s a user's function over a batch
    (a voice bank), the user's function here sees one instance too, never
    a shape the JAX package would not give it."""
    for _ in range(inputs.dim() - 2):
        fn = torch.func.vmap(fn)
    return fn


def sample_scan(
    fn: Callable,
    state,
    ctx: AudioCtx,
    inputs: Optional[torch.Tensor] = None,
    params: Optional[Dict[str, torch.Tensor]] = None,
    n_out: int = 1,
    with_done: bool = False,
):
    """Run a per-sample function over one block: a Python loop over the
    ``ctx.block_size`` samples (the JAX package's ``lax.scan``; the
    reference's default ``process_block`` loop, ugen.rs:263-284).

    ``fn(carry, frame) -> (carry, out)``, or ``(carry, (out, done))`` when
    ``with_done``; ``frame`` is a dict with ``frame["in"]`` = the sample's
    ``[inputs]`` column (when there are inputs) and one entry per param,
    each the sample's value. ``out`` is ``[n_out]``. Returns ``(carry, out
    [n_out, B])`` or ``(carry, out, done [B])``. Samples are read along the
    last axis and the outputs stacked along it, so leading batch axes pass
    through.

    Prefer closed-form block ``process`` implementations where possible;
    use this for genuinely sequential recurrences."""
    carry = state
    ys, dones = [], []
    for t in range(ctx.block_size):
        frame = {}
        if inputs is not None and inputs.shape[-2] > 0:
            frame["in"] = inputs[..., t]
        if params:
            for k, v in params.items():
                frame[k] = v[..., t]
        carry, y = fn(carry, frame)
        if with_done:
            y, d = y
            dones.append(d)
        ys.append(y)
    out = torch.stack(ys, dim=-1)
    if with_done:
        return carry, out, torch.stack(dones, dim=-1)
    return carry, out
