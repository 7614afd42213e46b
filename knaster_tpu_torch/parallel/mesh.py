"""Port of knaster_tpu/parallel/mesh.py: voice banks sharded over a list of devices in one process.

Voice synthesis is embarrassingly parallel over voices: each shard renders a
contiguous range of the bank's voices and the mix bus is the sum of the
shards' mixes. The JAX package runs one controller over many local devices
(``jax.make_mesh`` and ``shard_map``); the port does the same in plain
torch: one local bank (``make_local``) renders each shard's state on that
shard's device, and the shards' ``[C, B]`` mixes are summed onto the output
device in shard order (the JAX package's ``psum``). No process group, no
collective library and no network are involved.

Layout: a mesh is one axis, ``"voices"``, over a list of devices, which may
name one device more than once (the counterpart of XLA's virtual host
devices). A sharded state is one dict per shard under ``"shard<i>"``; in
it each state leaf's voice axis, inferred structurally from the full and
the local bank's state shapes, holds the shard's voices, and a leaf with no
voice axis is copied to every shard. Events stay in the full bank's layout
(global voice ids) and are localized per shard on the host: ``voice - lo``,
and voices outside the shard become the pad ``-1``, which every bank skips.

The fused kernel banks refuse a block past ``MAX_BLOCK``, so a
``MeshVoiceBank`` carries the wrapped bank's ``superblock_cap``. The JAX
package's ``MeshVoiceBank`` carries none and hands its local bank longer
superblocks; the audio is the same, because the fused banks render every
partition of a render bit-identically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.ugen import AudioCtx
from ..graph.compile import _tree_map
from .voicebank import VoiceBank


@dataclass(frozen=True)
class Mesh:
    """The port's counterpart of a one-axis ``jax.sharding.Mesh``: the
    devices of the shards, in shard order, and the axis's name."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("voices",)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}


def make_mesh(devices, axis_names=("voices",)) -> Mesh:
    """A mesh of one shard per entry of ``devices`` (``"cpu"``,
    ``"cuda:0"``, ``torch.device``s; an entry may repeat), the counterpart of
    ``jax.make_mesh((len(devices),), axis_names)``."""
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len(tuple(axis_names)) != 1:
        raise ValueError(f"a mesh has one axis (got {tuple(axis_names)})")
    return Mesh(devices, tuple(axis_names))


def _voice_axis(full, local):
    """The one axis where a full-bank leaf's shape differs from a local
    bank's, or None where they agree (a voice-independent leaf)."""
    gs, ls = tuple(full.shape), tuple(local.shape)
    if gs == ls:
        return None
    diff = [d for d in range(min(len(gs), len(ls))) if gs[d] != ls[d]]
    if len(gs) != len(ls) or len(diff) != 1:
        raise ValueError(
            f"cannot infer the voice axis of a state leaf: full bank shape {gs} "
            f"vs local shard shape {ls}")
    return diff[0]


class MeshVoiceBank(VoiceBank):
    """A voice bank sharded over a mesh that is a graph node.

    Wraps any bank (the vmap ``VoiceBank``, a fused kernel bank): its state
    is split over the mesh's shards, each shard's block runs the local
    bank's ``process`` on its device, and the mix is the shards' mixes
    summed onto the graph's device. Per-voice control works through the
    bank's event channel in the full bank's layout (``Handle.voice_param``,
    ``VoicePool``).

    Its structural signature is None, as the JAX package's is (a JAX mesh
    cannot be frozen): a graph holding one compiles afresh on every
    commit, and a cached renderer never runs another mesh's local bank."""

    def __init__(self, bank: VoiceBank, mesh: Mesh, axis: str = "voices"):
        if bank.mix != "sum":
            raise ValueError("sharded banks must use mix='sum'")
        n_dev = mesh.shape[axis]
        if bank.n_voices % n_dev:
            raise ValueError(
                f"n_voices ({bank.n_voices}) must divide the mesh axis ({n_dev})")
        self.bank = bank
        self.mesh = mesh
        self.axis = axis
        self.inputs = 0
        self.outputs = bank.outputs
        self.mix = "sum"
        self.event_capacity = bank.event_capacity
        self.n_voices = bank.n_voices
        self.voice = bank.voice
        self.local_voices = bank.n_voices // n_dev
        self._local = bank.make_local(self.local_voices)
        self._float_names = bank._float_names
        self._trig_names = bank._trig_names
        self._int_names = bank._int_names
        self.block_invariant = bank.block_invariant
        self.partition_exact = bank.partition_exact
        # the local bank refuses a block past the wrapped bank's cap (the
        # fused banks' MAX_BLOCK); the JAX package copies no cap
        self.superblock_cap = bank.superblock_cap
        self._axes = None

    def name(self):
        return f"Mesh[{self.bank.name()}]"

    def batch_key(self):
        return None

    def program_key(self):
        return None

    # event construction: the full bank's layout (voice ids are global)
    def empty_node_events(self, dtype=np.float32):
        return self.bank.empty_node_events(dtype=dtype)

    def node_events_from_lists(self, events, dtype=np.float32):
        return self.bank.node_events_from_lists(events, dtype=dtype)

    # ------------------------------------------------------------ layout
    def voice_axes(self, ctx: AudioCtx):
        """Each state leaf's voice axis (an int), or None for a leaf copied
        to every shard: the full bank's and the local bank's CPU inits
        compared leaf by leaf, once per bank."""
        if self._axes is None:
            self._axes = _tree_map(_voice_axis, self.bank.init(ctx, "cpu"),
                                   self._local.init(ctx, "cpu"))
        return self._axes

    def shards(self, state):
        """The per-shard states of a sharded state, in shard order."""
        return [state[f"shard{i}"] for i in range(len(self.mesh.devices))]

    def split(self, ctx: AudioCtx, full):
        """A sharded state from a full-bank state: shard i holds voices
        [i * local_voices, (i + 1) * local_voices) of every voice-axis leaf
        and a copy of every other leaf, on its device."""
        axes = self.voice_axes(ctx)
        n = self.local_voices

        def shard(i, dev):
            def leaf(x, ax):
                if ax is None:
                    return x.to(dev, copy=True)
                return x.narrow_copy(ax, i * n, n).to(dev)

            return _tree_map(leaf, full, axes)

        return {f"shard{i}": shard(i, dev) for i, dev in enumerate(self.mesh.devices)}

    def join(self, ctx: AudioCtx, state):
        """The full-bank state, on the CPU, of a sharded state: voice-axis
        leaves concatenated in shard order, the others from shard 0."""
        def leaf(ax, *xs):
            if ax is None:
                return xs[0].cpu()
            return torch.cat([x.cpu() for x in xs], dim=ax)

        return _tree_map(leaf, self.voice_axes(ctx), *self.shards(state))

    def idle_vector(self, state) -> np.ndarray:
        """The per-voice idle latch on the host: the shards' latches joined
        in shard order (voice order), one device-to-host copy a shard."""
        return np.concatenate([self._local.idle_vector(s) for s in self.shards(state)])

    def init(self, ctx: AudioCtx, device=None):
        """The full bank's state, built on the CPU and split over the mesh:
        each shard's leaves on that shard's device, whatever ``device`` the
        graph renders on."""
        state = self.split(ctx, self.bank.init(ctx, "cpu"))
        # a voice may set its cap in init (VoiceBank.init)
        self.superblock_cap = self.bank.superblock_cap
        return state

    # ------------------------------------------------------------ process
    def localize(self, events, shard: int):
        """The full bank's event dict (numpy) with voice ids local to
        ``shard``; out-of-shard events go to the pad -1."""
        n = self.local_voices
        v = np.asarray(events["voice"])
        local = v - shard * n
        ev = dict(events)
        ev["voice"] = np.where((v >= 0) & (local >= 0) & (local < n), local,
                               -1).astype(v.dtype)
        return ev

    def process(self, ctx: AudioCtx, state, inputs=None, params=None, events=None):
        """Render one block: (new state, mix [outputs, B]). Each shard runs
        the local bank on its device with its localized events (None: an
        event-free block); the mixes are summed in shard order onto the
        device of ``inputs`` (the graph's), or the first shard's."""
        out_dev = inputs.device if inputs is not None else self.mesh.devices[0]
        new, mix = {}, None
        for i, st in enumerate(self.shards(state)):
            ev = None if events is None else self.localize(events, i)
            r = self._local.process(ctx, st, None, {}, events=ev)
            new[f"shard{i}"] = r[0]
            out = r[1].to(out_dev)
            mix = out if mix is None else mix + out
        return new, mix


class ShardedVoiceBank:
    """A voice bank whose voices are sharded over a mesh, stepped on its own
    (no graph).

    Usage::

        mesh = make_mesh(["cuda:0", "cuda:1"])
        sb = ShardedVoiceBank(FusedSineVoiceBank(131072), mesh, ctx)
        state = sb.init_state()
        state, out = sb.step(state, sb.empty_events())   # out: [ch, block]

    The mix is summed on the mesh's first device."""

    def __init__(self, bank: VoiceBank, mesh: Mesh, ctx: AudioCtx,
                 axis: str = "voices"):
        self.node = MeshVoiceBank(bank, mesh, axis)
        self.bank = bank
        self.mesh = mesh
        self.ctx = ctx
        self.axis = axis
        self.n_devices = mesh.shape[axis]
        self.local_voices = self.node.local_voices
        self._specs = self.node.voice_axes(ctx)
        self.device = mesh.devices[0]
        self._np_dtype = np.float32 if ctx.dtype == torch.float32 else np.float64

    def init_state(self):
        """The full bank's state split over the mesh."""
        return self.node.init(self.ctx)

    def empty_events(self):
        return self.bank.empty_node_events(dtype=self._np_dtype)

    def events_from_lists(self, events):
        return self.bank.node_events_from_lists(events, dtype=self._np_dtype)

    def step(self, state, events=None):
        """Render one block: (state', mixed [channels, block] on
        ``device``). ``events`` None is an event-free block."""
        no_inputs = torch.zeros((0, self.ctx.block_size), dtype=self.ctx.dtype,
                                device=self.device)
        return self.node.process(self.ctx, state, no_inputs, {}, events=events)

    def render(self, n_blocks: int, events_per_block=None, state=None,
               return_state: bool = False):
        """Render ``n_blocks`` blocks step by step: [channels, n_blocks *
        block]. ``events_per_block`` is an event dict whose arrays are
        stacked over a leading block axis, or None for event-free blocks.

        Pass ``state`` (and ``return_state=True`` to get it back) to make
        consecutive renders sample-continuous; with no state a fresh one is
        used. The state passed in is not modified."""
        if state is None:
            state = self.init_state()
        outs = []
        for i in range(n_blocks):
            ev = (None if events_per_block is None
                  else {k: np.asarray(v)[i] for k, v in events_per_block.items()})
            state, out = self.step(state, ev)
            outs.append(out)
        audio = torch.cat(outs, dim=1)
        return (audio, state) if return_state else audio
