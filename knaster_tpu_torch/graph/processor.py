"""Port of knaster_tpu/graph/processor.py: the block runner and offline render loop.

``AudioProcessor`` runs a Graph one block at a time (``run``) and bounces
it offline (``render``). Graph edits are picked up between blocks: when
the graph's revision changed, it is recompiled and node state is carried
over by node id (the functional equivalent of swapping TaskData and
``TakeFromTask``, graph_gen.rs:93-109 / task.rs:101-131).

The device is the card: ``AudioProcessor.new(..., device=...)`` defaults
to "cuda" and raises where there is none. The CPU is taken only when the
caller passes ``device="cpu"`` (the tests do); nothing falls back to it.

``render`` splits a bounce as the JAX package's does
(knaster_tpu/graph/processor.py:841-1092, the paths an offline bounce
takes): each chunk of ``render_chunk_blocks`` into runs of eventful and
event-free blocks. Eventful blocks render one by one through ``render``
(the JAX package's full scan is the same per-block program). Event-free
runs are covered by lengths halving from the chunk: a length of 2 or more
renders as one superblock (``compile.get_super_fn``) or, past the graph's
cap, as a loop of capped superblocks (``get_super_scan_fn``); a length of 1,
and every block of a superblock-ineligible graph, through ``render_fast``.
Where collapsed chains run, they take the chain kernel on a card. Float
sums such as ``SinNumeric``'s phase depend on the partition, so taking the
JAX package's keeps the port on its reference's samples;
``AudioProcessorOptions(render_chunk_blocks=1)`` renders block by block.
The programs that the JAX bounce runs only once a stream has warmed them
(``existing_only``: the eventful-chunk, eventful-superblock and float-event
programs), async recompile, the streaming backend, probes and save/load
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .compile import (CompiledGraph, compile_graph, get_super_fn, get_super_scan_fn,
                      resolve_device, superblock_eligible)
from .graph import Done, Graph
from .scheduling import ScheduledEvent

# run pieces of at least this many blocks render with one done-flag check
# (the JAX package's one-dispatch scans); shorter eventful pieces, and short
# event-free pieces without a superblock, go one block at a time
MIN_SCAN = 16

# the voice_* payloads of a node's own event channel -> the bank's event
# kinds (parallel/voicebank.py): 0 float set, 1 trigger, 2 int set,
# 3 set-active, 4 smoothing config, 5 note-on (clears the idle latch)
_VOICE_KINDS = {"voice_float": 0, "voice_trig": 1, "voice_int": 2, "voice_active": 3,
                "voice_smooth": 4, "voice_idle_clear": 5}


@dataclass
class AudioProcessorOptions:
    """reference processor.rs:23-45 AudioProcessorOptions."""

    block_size: int = 64
    sample_rate: int = 48000
    # max scheduled events applied per block (ring_buffer_size analog)
    event_capacity: int = 64
    # compiler: batch same-kind nodes at equal depth into one call
    auto_batch: bool = True
    # render: blocks whose events are collected (and slot-resolved) at once,
    # and the longest superblock; 1 renders block by block
    render_chunk_blocks: int = 128


class AudioProcessor:
    """Runs a Graph one block at a time; also the offline bounce engine."""

    def __init__(self, graph: Graph, options: Optional[AudioProcessorOptions] = None,
                 device="cuda"):
        self.graph = graph.root()
        self.options = options or AudioProcessorOptions()
        self.device = resolve_device(device)
        self.compiled: Optional[CompiledGraph] = None
        self.state = None
        self._last_out = None
        self.freed = False
        # leftover samples from a render() that wasn't block-aligned; the
        # next render() consumes them first so bounces are sample-continuous
        self._pending: Optional[np.ndarray] = None

    # ------------------------------------------------------------- factory
    @staticmethod
    def new(
        inputs: int = 0,
        outputs: int = 2,
        options: Optional[AudioProcessorOptions] = None,
        dtype=None,
        device="cuda",
    ) -> Tuple[Graph, "AudioProcessor"]:
        """Create a top-level Graph + processor (processor.rs:69-116)."""
        options = options or AudioProcessorOptions()
        device = resolve_device(device)
        g = Graph(
            inputs=inputs,
            outputs=outputs,
            sample_rate=options.sample_rate,
            block_size=options.block_size,
            dtype=dtype,
        )
        return g, AudioProcessor(g, options, device=device)

    # ------------------------------------------------------------ internals
    def _ensure_compiled(self) -> None:
        if self.compiled is not None and self.compiled.revision == self.graph.revision:
            return
        prev_compiled = self.compiled
        prev_state = self.state
        self.compiled = compile_graph(
            self.graph, self.options.event_capacity, self.options.auto_batch,
            device=self.device,
        )
        self.state = self.compiled.init_state(prev_state, prev_compiled)

    def _collect_due_events(self, horizon_blocks: int = 1):
        """Pop events due within the next ``horizon_blocks`` blocks and
        convert them to per-block event lists (slot-resolved).

        Overflow is graceful: when a block's events exceed the engine
        capacity, the *tail* of that block's bucket spills into the following
        block — floats/ints clamp to frame 0 of the next block, triggers keep
        their intra-block frame — and past the horizon it is re-queued for the
        next collection.

        Each block's lists are (float, trigger, int, {node id: node events}):
        the ``voice_*`` payloads ride the addressed node's own event channel
        (a voice bank's per-voice control) as (frame, voice, param, kind,
        value) with the bank's kinds 0-5, up to the node's
        ``event_capacity`` a block.
        """
        B = self.graph.block_size
        clock = self.graph.clock.frames
        end = clock + B * horizon_blocks
        with self.graph.event_lock:
            pending = self.graph.event_queue
            self.graph.event_queue = []
        due, keep = [], []
        for ev in pending:
            if ev.due_frame < end:
                due.append(ev)
            else:
                keep.append(ev)
        if keep:
            with self.graph.event_lock:
                self.graph.event_queue.extend(keep)

        per_block: List[Tuple[list, list, list, dict]] = [
            ([], [], [], {}) for _ in range(horizon_blocks)
        ]
        cap = self.compiled.event_capacity
        layout = self.compiled.layout

        def place(ev, bi, frame, which, item, capacity, keep_frame):
            """Append ``item`` to bucket ``bi`` (list ``which``, or the node's
            list for 3); cascade to later blocks when full; re-queue past the
            horizon."""
            while bi < horizon_blocks:
                bucket = per_block[bi]
                lst = bucket[which] if which < 3 else bucket[3].setdefault(ev.node_id, [])
                if len(lst) < capacity:
                    lst.append(item)
                    return
                bi += 1
                if not keep_frame:
                    frame = 0
                item = (frame,) + item[1:]
            self.graph.event_queue.append(ScheduledEvent(
                end + (frame if keep_frame else 0), ev.node_id, ev.param_idx,
                ev.payload, order=ev.order))

        for ev in sorted(due, key=lambda e: (max(e.due_frame, clock), e.order)):
            frame_abs = max(ev.due_frame, clock)
            bi = (frame_abs - clock) // B
            frame = frame_abs - clock - bi * B
            p = ev.payload
            if p[0] in _VOICE_KINDS:
                # the node's own event channel; a freed node's expire
                entry = self.compiled.entries.get(ev.node_id)
                if entry is None:
                    continue
                kind = _VOICE_KINDS[p[0]]
                if kind in (3, 5):  # set-active / note-on: (voice, [flag])
                    value = 0.0 if kind == 5 else (1.0 if p[2] else 0.0)
                    item = (frame, p[1], 0, kind, value)
                else:
                    value = 0.0 if kind == 1 else float(p[3])
                    item = (frame, p[1], p[2], kind, value)
                place(ev, bi, frame, 3, item, entry.ugen.event_capacity,
                      keep_frame=kind == 1)
                continue
            # events for freed nodes expire silently (graph_gen.rs:122-126)
            key = layout.slots.get((ev.node_id, ev.param_idx))
            if key is None:
                continue
            typ, slot = key
            if p[0] == "set_float" and typ == "float":
                place(ev, bi, frame, 0, (frame, slot, p[1], 0, 0, 0, 0), cap, False)
            elif p[0] == "smooth_cfg" and typ == "float":
                place(ev, bi, frame, 0, (frame, slot, 0.0, 1, p[1], p[2], p[3]), cap,
                      False)
            elif p[0] == "trig" and typ == "trigger":
                place(ev, bi, frame, 1, (frame, slot), cap, True)
            elif p[0] == "set_int" and typ == "int":
                place(ev, bi, frame, 2, (frame, slot, p[1]), cap, False)
        return per_block

    def _events(self, lists):
        return self.compiled.events_from_lists(*lists)

    def _zero_inputs(self, frames=None):
        """Zero inputs of ``frames`` samples (one block by default), one
        cached tensor per length: they are only read."""
        n = frames or self.graph.block_size
        cache = self.__dict__.setdefault("_zero_in", {})
        key = (n, self.graph.dtype)
        if key not in cache:
            cache[key] = torch.zeros((self.graph.inputs, n), dtype=self.graph.dtype,
                                     device=self.device)
        return cache[key]

    def _super_scan_k(self, sub: int) -> int:
        """Largest power-of-two superblock multiple k (>= 2) that divides
        ``sub`` and fits the graph's superblock cap, or 0 (the JAX package's
        ``_super_scan_k``)."""
        cg = self.compiled
        if not superblock_eligible(cg):
            return 0
        B = self.graph.block_size
        k = 1
        while k * 2 <= sub and k * 2 * B <= cg.superblock_max and sub % (k * 2) == 0:
            k *= 2
        return k if k >= 2 else 0

    def _block(self, lists, inputs):
        """Render one block with its event lists; returns the output [ch, B]."""
        if any(lists):
            self.state, out, done = self.compiled.render(
                self.state, self._events(lists), inputs)
        else:
            # the cheap steady-state renderer (no event machinery)
            self.state, out, done = self.compiled.render_fast(self.state, inputs)
        if self.compiled.has_done_actions:
            self._apply_done_flags(done.cpu().numpy())
        self.graph.clock.frames += self.graph.block_size
        return out

    # ------------------------------------------------------------------ run
    def run(self, inputs=None):
        """Process exactly one block (processor.rs:119-179 run)."""
        if self.freed:
            self._last_out = torch.zeros(
                (self.graph.outputs, self.graph.block_size), dtype=self.graph.dtype)
            self.graph.clock.frames += self.graph.block_size
            return
        self._ensure_compiled()
        (lists,) = self._collect_due_events(1)
        if inputs is None:
            inputs = self._zero_inputs()
        else:
            inputs = torch.as_tensor(np.asarray(inputs), dtype=self.graph.dtype,
                                     device=self.device)
        self._last_out = self._block(lists, inputs)

    def run_without_inputs(self):
        self.run(None)

    def output_block(self) -> np.ndarray:
        """The last rendered block as a numpy array [channels, block_size]."""
        if self._last_out is None:
            return np.zeros(
                (self.graph.outputs, self.graph.block_size),
                dtype=np.float64 if self.graph.dtype == torch.float64 else np.float32)
        return self._last_out.cpu().numpy()

    # ---------------------------------------------------------- done/free
    def _apply_done_flags(self, done_vec: np.ndarray) -> None:
        if self.compiled is None or not done_vec.any():
            return
        freed_any = False
        for i, nid in enumerate(self.compiled.done_order):
            if not done_vec[i]:
                continue
            entry = self.compiled.entries.get(nid)
            if entry is None:
                continue
            action = entry.done_action
            if action == Done.NONE:
                continue
            target = nid
            if action == Done.FREE_PARENT:
                chain = self.compiled.enclosing.get(nid, [])
                if chain:
                    target = chain[0]  # innermost enclosing subgraph node
                else:
                    # freeing the top-level graph: output silence from now on
                    self.freed = True
                    self.graph.freed = True
                    continue
            try:
                self.graph.free_node(target)
                freed_any = True
            except Exception:
                pass
        if freed_any:
            self.graph.commit()

    # ------------------------------------------------------------- bounce
    def render(
        self,
        seconds: Optional[float] = None,
        frames: Optional[int] = None,
        inputs: Optional[np.ndarray] = None,
        check_done_every: Optional[int] = None,
        fetch: bool = True,
    ):
        """Offline bounce: render ``seconds`` (or ``frames``) of audio.

        Returns ``[channels, frames]`` as numpy, or with ``fetch=False`` as a
        tensor on the processor's device (no device-to-host copy; needs
        block-aligned ``frames`` and no pending remainder). Events are
        collected for ``render_chunk_blocks`` blocks at a time (16 when the
        graph has done actions, or ``check_done_every``), and each chunk is
        split into runs as the module docstring says: done-action frees land
        after the superblock or run piece that raised them, and take effect
        in the graph at the next chunk. With external ``inputs``, a trailing
        partial block is rendered with the missing input samples
        zero-padded.
        """
        B = self.graph.block_size
        if frames is None:
            if seconds is None:
                raise ValueError("give seconds or frames")
            frames = int(round(seconds * self.graph.sample_rate))

        prefix = None
        if self._pending is not None:
            take = min(frames, self._pending.shape[1])
            prefix = self._pending[:, :take]
            self._pending = (
                self._pending[:, take:] if take < self._pending.shape[1] else None
            )
            if take == frames:
                return prefix
            frames_needed = frames - take
        else:
            frames_needed = frames
        if not fetch and (prefix is not None or frames_needed % B):
            raise ValueError(
                "fetch=False requires block-aligned frames and no pending remainder")

        n_blocks = (frames_needed + B - 1) // B
        self._ensure_compiled()
        chunk = self.options.render_chunk_blocks
        if check_done_every is None and self.compiled.has_done_actions:
            check_done_every = 16
        if check_done_every:
            chunk = min(chunk, check_done_every)
        in_all = None
        if inputs is not None:
            seg = np.zeros((self.graph.inputs, n_blocks * B),
                           dtype=np.float64 if self.graph.dtype == torch.float64
                           else np.float32)
            avail = np.asarray(inputs)[:, :n_blocks * B]
            seg[:, :avail.shape[1]] = avail
            in_all = torch.from_numpy(seg).to(self.device)

        def inputs_for(start, count):
            """[inputs, count * B] from block ``start``."""
            if in_all is None:
                return self._zero_inputs(count * B)
            return in_all[:, start * B:(start + count) * B]

        outs = []
        rendered = 0
        # as in the JAX package: a chunk is compiled and its events
        # collected once (done-action frees recompile at the next chunk);
        # eventful runs and the event-free runs of graphs without
        # superblocks go block by block, and below MIN_SCAN blocks their
        # done flags are applied per block, else per run piece
        while rendered < n_blocks and not self.freed:
            n = min(chunk, n_blocks - rendered)
            self._ensure_compiled()
            cg = self.compiled
            per_block = self._collect_due_events(n)
            eventful = [any(pb) for pb in per_block]
            bi = 0
            while bi < n:
                flag, run = eventful[bi], 1
                while bi + run < n and eventful[bi + run] == flag:
                    run += 1
                while run:
                    sub = chunk
                    while sub > run:
                        sub //= 2
                    fn = None
                    if not flag and sub >= 2:
                        fn = get_super_fn(cg, sub)
                        if fn is None and sub >= MIN_SCAN:
                            k = self._super_scan_k(sub)
                            fn = get_super_scan_fn(cg, k) if k else None
                    if fn is not None:
                        self.state, out, done = fn(self.state, inputs_for(rendered, sub))
                        outs.append(out)
                        dones = [done]
                    else:
                        if sub < MIN_SCAN:
                            sub = 1
                        dones = []
                        for i in range(sub):
                            inp = inputs_for(rendered + i, 1)
                            if flag:
                                self.state, out, done = cg.render(
                                    self.state, self._events(per_block[bi + i]), inp)
                            else:
                                self.state, out, done = cg.render_fast(self.state, inp)
                            outs.append(out)
                            dones.append(done)
                    if cg.has_done_actions:
                        self._apply_done_flags(torch.stack(dones).any(dim=0).cpu().numpy())
                    self.graph.clock.frames += sub * B
                    rendered += sub
                    run -= sub
                    bi += sub

        dtype = self.graph.dtype
        audio = (torch.cat(outs, dim=1) if outs
                 else torch.zeros((self.graph.outputs, 0), dtype=dtype, device=self.device))
        if audio.shape[1] < n_blocks * B:
            # a FREE_PARENT done action freed the top-level graph mid-render:
            # pad with silence so callers always get [channels, frames]
            pad = torch.zeros((self.graph.outputs, n_blocks * B - audio.shape[1]),
                              dtype=dtype, device=audio.device)
            audio = torch.cat([audio, pad], dim=1)
        if not fetch:
            return audio
        audio = audio.cpu().numpy()
        if audio.shape[1] > frames_needed:
            self._pending = audio[:, frames_needed:]
            audio = audio[:, :frames_needed]
        if prefix is not None:
            audio = np.concatenate([prefix, audio], axis=1)
        return audio
