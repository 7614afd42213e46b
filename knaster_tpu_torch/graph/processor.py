"""Port of knaster_tpu/graph/processor.py: the block runner, the offline render loop and the live path's runner.

``AudioProcessor`` runs a Graph one block at a time (``run``) and bounces
it offline (``render``). Graph edits are picked up between blocks: when
the graph's revision changed, it is recompiled and node state is carried
over by node id (the functional equivalent of swapping TaskData and
``TakeFromTask``, graph_gen.rs:93-109 / task.rs:101-131).

The device is the card: ``AudioProcessor.new(..., device=...)`` defaults
to "cuda" and raises where there is none. The CPU is taken only when the
caller passes ``device="cpu"`` (the tests do); nothing falls back to it.

``render`` splits a bounce as the JAX package's does
(knaster_tpu/graph/processor.py:841-1092): collect each chunk's events
(``render_chunk_blocks`` blocks, 16 with done actions), then

* events in block 0 only: one eventful-chunk program, the float-event one
  (``get_float_evchunk_fn``) when block 0 carries no trigger, else
  ``get_evchunk_fn``;
* events anywhere: the eventful superblock over the whole chunk
  (``get_full_super_fn``), else for capped graphs a loop of eventful
  k-superblocks (``get_full_super_scan_fn``), else, for graphs without
  superblocks, the whole chunk block by block when that chunk length was
  warmed (``full_scan_warm``);
* otherwise runs of eventful and event-free blocks: an event-free run of a
  length already built renders as that one superblock; the rest in lengths
  halving from the chunk, each of 2 or more blocks as one superblock or,
  past the graph's cap, a loop of capped superblocks
  (``get_super_scan_fn``); eventful blocks and single blocks one by one,
  through ``render`` or, where ``run`` meets a trigger-free batch and the
  float-event program exists, ``get_float_fn``.

The first three take a program only if it exists (``existing_only``):
``_warm_programs`` builds and executes them, as a stream's start and every
async recompile do, and so does an earlier bounce that built the same
length. The JAX package gates its bounce the same way, so the port takes
its reference's partition before a stream and after one; float sums such
as ``SinNumeric``'s phase depend on it. Collapsed chains take the chain
kernel on a card in every event-free renderer and in the float-event
programs, and in an eventful block whose triggers touch some of their
stages, every stage but those (``compile._build_render``). ``AudioProcessorOptions(render_chunk_blocks=1)`` renders block by
block.

Live editing (``enable_async_recompile``, which ``StreamBackend`` turns
on): an edit is compiled on a worker thread from a ``copy_state`` snapshot
of the live state, every program the runner can take is warmed on copies
(``_warm_programs``: on a program-cache hit only what its cache entry has
not warmed yet), and the result is published tagged with the revision
it compiled; the runner swaps it in between blocks, carrying state as the
synchronous path does, and drops a stale result. A failure in the worker is
raised on the thread that swaps. The JAX package's undo-carry prewarm
(``prewarm_undo_carry``, ``_pending_prewarm``) saves a jit compile of the
reverse state carry; eager torch compiles nothing, so it is not ported.
Probes (``probe_log``: every ``LogProbe`` in one device-to-host copy) and
checkpoints (``save_state``/``load_state``) complete the live path.
"""

from __future__ import annotations

import collections
import pickle
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .compile import (CompiledGraph, _tree_map, compile_graph, get_evchunk_fn,
                      get_float_evchunk_fn,
                      get_float_fn, get_full_scan_fn, get_full_super_fn,
                      get_full_super_scan_fn, get_scan_fn, get_super_fn,
                      get_super_scan_fn, resolve_device, superblock_eligible)
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
    # capacity of a log channel (core/log.py ArLogReceiver.sender)
    log_channel_capacity: int = 100
    # compiler: batch same-kind nodes at equal depth into one call
    auto_batch: bool = True
    # render: blocks whose events are collected (and slot-resolved) at once,
    # and the longest superblock; 1 renders block by block
    render_chunk_blocks: int = 128


def copy_state(state):
    """A deep copy of a state tree: every tensor leaf cloned on its device.
    A warm renders on one, so the live state is never read by two renders
    at once."""
    return _tree_map(torch.clone, state)


def _flatten(tree, path=()):
    """[(path, leaf)] of nested dicts, in order; a path is the keys down to
    the leaf."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    return [(path, tree)]


def _unflatten(items):
    """The nested dicts of ``_flatten``'s (path, leaf) pairs."""
    root = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


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
        # (revision, frame) of the latest async program swaps: the frame
        # from which a live edit renders
        self.swaps = collections.deque(maxlen=256)
        # the latest compiles: {"revision", "hit" (a program-cache hit),
        # "plan_ms", "build_ms" (CompiledGraph.compile_ms), "carry_ms"
        # (init_state), "warm_ms" (the async worker's warm; None for a
        # synchronous compile)}, host ms
        self.compiles = collections.deque(maxlen=256)

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
        if self._async_recompile and self.compiled is not None:
            # live edits: keep rendering the old program while a worker
            # compiles the new one; swap between blocks
            self._kick_async_compile()
            return
        with self.graph.edit_lock:
            compiled = compile_graph(
                self.graph, self.options.event_capacity, self.options.auto_batch,
                device=self.device,
            )
        t0 = time.perf_counter()
        self.state = compiled.init_state(self.state, self.compiled)
        self._log_compile(compiled, None, 1e3 * (time.perf_counter() - t0))
        self.compiled = compiled

    def _log_compile(self, cg: CompiledGraph, warm_ms, carry_ms) -> None:
        self.compiles.append({"revision": cg.revision, "hit": cg.cache_hit,
                              "plan_ms": cg.compile_ms.get("plan"),
                              "build_ms": cg.compile_ms.get("build"),
                              "carry_ms": carry_ms, "warm_ms": warm_ms})

    # -- async recompile (the streaming backend turns it on) ---------------
    _async_recompile = False
    _compile_thread = None
    _compiled_next = None
    _compile_error = None
    # the event-free run lengths (blocks) the runner will take and the
    # stream's chunk length: ``_warm_programs`` builds their programs
    _warm_scan_lengths: Tuple[int, ...] = ()
    _warm_chunk_len: int = 0

    def enable_async_recompile(self, enabled: bool = True) -> None:
        """Compile graph edits on a worker thread and swap between blocks,
        so a running stream keeps playing the old program while the new
        one is compiled and warmed."""
        self._async_recompile = bool(enabled)

    def join_background(self, timeout: float = 120.0) -> None:
        """Wait for the compile worker; raise what it raised, if nothing
        has yet."""
        t = self._compile_thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        self._raise_compile_error()

    def _raise_compile_error(self) -> None:
        err, self._compile_error = self._compile_error, None
        if err is not None:
            raise RuntimeError("async recompile failed in the worker") from err

    def warm_for_stream(self, chunk_blocks: int) -> None:
        """Warm what a stream of ``chunk_blocks``-block chunks takes: the
        superblock of every power of two up to the chunk and the chunk's
        eventful programs (``_warm_programs``), and record those lengths, so
        that the async-recompile worker warms the same on every new
        program (``StreamBackend.start_processing`` calls it)."""
        self._ensure_compiled()
        cap = min(int(chunk_blocks), self.options.render_chunk_blocks)
        lengths, sub = [], 2
        while sub <= cap:
            lengths.append(sub)
            sub *= 2
        self._warm_scan_lengths = tuple(lengths)
        self._warm_chunk_len = cap
        self._warm_programs(self.compiled, self.state)

    def _warm_programs(self, cg: CompiledGraph, base_state) -> None:
        """Build and execute once, each on a ``copy_state`` copy of
        ``base_state``, every renderer the runner can take: the two block
        renderers, the superblock or block-loop of each of
        ``_warm_scan_lengths``, and at the stream's chunk length the
        eventful-chunk, float-event and eventful-superblock programs (the
        JAX package's ``_warm_programs``, step for step, registering the
        same lengths). Executing them builds what first use builds (the
        kernel libraries, the chain kernel's program, cuBLAS's handle) off
        the thread that renders. A loop of one renderer (the block loops,
        the loop of capped superblocks) runs one step: its other steps run
        nothing that step did not.

        A program-cache hit shares its programs with the compile it hit
        (``compile_graph``): each program executes once per cache entry,
        whose ``warmed`` set records it once the warm has synchronized, so
        a hit executes only what an earlier warm of its entry did not (the
        JAX package's warm after a hit finds its programs compiled)."""
        B = self.graph.block_size
        ev = cg.events_from_lists([], [], [], {})
        entry = cg.cache_entry
        done = entry["warmed"] if entry is not None else set()
        ran = []

        def zeros(n_blocks):
            return self._zero_inputs(n_blocks * B)

        def run(key, fn, *args):
            """Execute ``fn`` on a copy of the state, once per entry."""
            if key not in done:
                fn(copy_state(base_state), *args)
                ran.append(key)

        run("fast", cg.render_fast, zeros(1))
        run("full", cg.render, ev, zeros(1))
        if self._warm_scan_lengths:
            for sub in self._warm_scan_lengths:
                super_fn = get_super_fn(cg, sub)
                if super_fn is not None:
                    run(("super", sub), super_fn, zeros(sub))
                elif sub >= MIN_SCAN:
                    run("scan", get_scan_fn(cg), zeros(1))
                if sub >= MIN_SCAN:  # eventful runs below this go block by block
                    run("full_scan", get_full_scan_fn(cg), [ev], zeros(1))
                    cg.full_scan_warm.add(sub)
            n = min(self._warm_chunk_len or max(self._warm_scan_lengths),
                    self.options.render_chunk_blocks)
            if cg.has_done_actions:
                n = min(n, 16)
            # the eventful chunk's event-free tail, also taken alone
            tail = get_super_fn(cg, n - 1) if n - 1 >= 2 else None
            if tail is not None:
                run(("super", n - 1), tail, zeros(n - 1))
            evfn = get_evchunk_fn(cg, n)
            if evfn is not None:
                run(("evchunk", n), evfn, ev, zeros(1), zeros(n - 1))
            ffn = get_float_fn(cg)
            if ffn is not None:
                run("float", ffn, ev, zeros(1))
                fev = get_float_evchunk_fn(cg, n)
                if fev is not None:
                    run(("float_evchunk", n), fev, ev, zeros(1), zeros(n - 1))
            fsfn = get_full_super_fn(cg, n)
            if fsfn is not None:
                run(("full_super", n), fsfn, ev, zeros(n))
            else:
                k = self._super_scan_k(n, cg)
                ssfn = get_full_super_scan_fn(cg, k) if k >= 2 else None
                if ssfn is not None:
                    run(("full_super_scan", k), ssfn, [ev], zeros(k))
                elif n >= 2:
                    # no superblocks (feedback edges): the whole eventful
                    # chunk block by block, at this length only
                    run("full_scan", get_full_scan_fn(cg), [ev], zeros(1))
                    cg.full_scan_warm.add(n)
        if self.device.type == "cuda" and ran:
            # a launch that failed surfaces here, on the warming thread
            torch.cuda.current_stream(self.device).synchronize()
        done.update(ran)

    def _kick_async_compile(self) -> None:
        """Swap in a finished compile of the current revision; else start a
        worker unless one runs (a stale result is dropped and compiled
        again). The worker's failure is raised here."""
        self._raise_compile_error()
        ready = self._compiled_next
        if ready is not None and ready.revision == self.graph.revision:
            # the swap between blocks, carrying state (TakeFromTask)
            self.state = ready.init_state(self.state, self.compiled)
            self.compiled = ready
            self._compiled_next = None
            self.swaps.append((ready.revision, self.graph.clock.frames))
            return
        if self._compile_thread is not None and self._compile_thread.is_alive():
            return  # still compiling (maybe an older revision; kicked again after)
        self._compiled_next = None
        # a snapshot of the live state: the producer renders on while the
        # worker warms, and the warm must not read what a render replaces
        live_state = copy_state(self.state)
        live_compiled = self.compiled

        def worker():
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                with self.graph.edit_lock:
                    cg = compile_graph(self.graph, self.options.event_capacity,
                                       self.options.auto_batch, device=self.device)
                t0 = time.perf_counter()
                base = cg.init_state(live_state, live_compiled)
                t1 = time.perf_counter()
                self._warm_programs(cg, base)
                self._log_compile(cg, 1e3 * (time.perf_counter() - t1),
                                  1e3 * (t1 - t0))
            except BaseException as exc:  # carried to the thread that swaps
                self._compile_error = exc
                return
            self._compiled_next = cg

        self._compile_thread = threading.Thread(target=worker, daemon=True,
                                                name="knaster-compile")
        self._compile_thread.start()

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

    def _merged_events_lists(self, per_block):
        """The blocks' event lists merged into one set with frames relative
        to the first block's start (the eventful superblock's), or None when
        a merged list exceeds its capacity (a superblock holds the union of
        its blocks; each block was capped alone)."""
        B = self.graph.block_size
        cap = self.compiled.event_capacity
        fl, tl, il, nd = [], [], [], {}
        for bi, (f, t, i, n) in enumerate(per_block):
            off = bi * B
            fl.extend((e[0] + off,) + tuple(e[1:]) for e in f)
            tl.extend((e[0] + off, e[1]) for e in t)
            il.extend((e[0] + off,) + tuple(e[1:]) for e in i)
            for nid, evs in n.items():
                nd.setdefault(nid, []).extend((e[0] + off,) + tuple(e[1:]) for e in evs)
        if len(fl) > cap or len(tl) > cap or len(il) > cap:
            return None
        for nid, evs in nd.items():
            entry = self.compiled.entries.get(nid)
            if entry is None or len(evs) > entry.ugen.event_capacity:
                return None
        return fl, tl, il, nd

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

    def _super_scan_k(self, sub: int, cg: Optional[CompiledGraph] = None) -> int:
        """Largest power-of-two superblock multiple k (>= 2) that divides
        ``sub`` and fits the graph's superblock cap, or 0 (the JAX package's
        ``_super_scan_k``)."""
        cg = cg or self.compiled
        if not superblock_eligible(cg):
            return 0
        B = self.graph.block_size
        k = 1
        while k * 2 <= sub and k * 2 * B <= cg.superblock_max and sub % (k * 2) == 0:
            k *= 2
        return k if k >= 2 else 0

    def _chunk_program(self, per_block, eventful):
        """The one program that renders a whole eventful chunk, as
        fn(state, inputs [in, n*B]) -> (state, out, done), or None: the
        eventful-chunk program when only block 0 has events (its
        float-event sibling when they hold no trigger), the eventful
        superblock, the loop of eventful k-superblocks, the whole chunk
        block by block where that length was warmed. Each only if built."""
        cg, n, B = self.compiled, len(per_block), self.graph.block_size
        if eventful[0] and not any(eventful[1:]):
            fn = None
            if not per_block[0][1]:  # no trigger in the batch
                fn = get_float_evchunk_fn(cg, n, existing_only=True)
            if fn is None:
                fn = get_evchunk_fn(cg, n, existing_only=True)
            if fn is not None:
                ev = self._events(per_block[0])
                return lambda st, inp: fn(st, ev, inp[:, :B], inp[:, B:])
        fn = get_full_super_fn(cg, n, existing_only=True)
        if fn is not None:
            lists = self._merged_events_lists(per_block)
            if lists is not None:
                ev = self._events(lists)
                return lambda st, inp: fn(st, ev, inp)
        k = self._super_scan_k(n)
        fn = get_full_super_scan_fn(cg, k, existing_only=True) if k >= 2 else None
        if fn is not None:
            groups = [self._merged_events_lists(per_block[i:i + k]) for i in range(0, n, k)]
            if all(g is not None for g in groups):
                evs = [self._events(g) for g in groups]
                return lambda st, inp: fn(st, evs, inp)
        if n in cg.full_scan_warm:
            evs = [self._events(lists) for lists in per_block]
            return lambda st, inp: get_full_scan_fn(cg)(st, evs, inp)
        return None

    def _block(self, lists, inputs):
        """Render one block with its event lists; returns the output [ch, B].
        A batch without triggers takes the float-event program if it was
        built, so collapsed chains stay on the chain kernel."""
        cg = self.compiled
        if any(lists):
            fn = get_float_fn(cg, existing_only=True) if not lists[1] else None
            self.state, out, done = (fn or cg.render)(self.state, self._events(lists),
                                                      inputs)
        else:
            # the cheap steady-state renderer (no event machinery)
            self.state, out, done = cg.render_fast(self.state, inputs)
        self._done(done)
        self.graph.clock.frames += self.graph.block_size
        return out

    def _done(self, done) -> None:
        if self.compiled.has_done_actions and done is not None:
            self._apply_done_flags(done.cpu().numpy())

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
        with self.graph.edit_lock:
            self._free_done(done_vec)

    def _free_done(self, done_vec: np.ndarray) -> None:
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

    # ---------------------------------------------------------------- logs
    def probe_log(self, retries: int = 3):
        """The latest ``LogProbe`` captures, all probes in one device-to-host
        copy (``core.log.collect_probes``). Safe from a control thread while
        a stream renders: a read that meets a program swap half done (the
        new state beside the old program) is retried."""
        from ..core.log import collect_probes

        for _ in range(max(retries, 1)):
            compiled, state = self.compiled, self.state
            if compiled is None or state is None:
                return []
            try:
                return collect_probes(compiled, state)
            except (KeyError, IndexError):
                continue
        return []

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
        block-aligned ``frames`` and no pending remainder: the streaming
        producer's call). Events are collected for ``render_chunk_blocks``
        blocks at a time (16 when the graph has done actions, or
        ``check_done_every``), and each chunk renders as the module
        docstring says: done-action frees land after the program or run
        piece that raised them, and take effect in the graph at the next
        chunk. With external ``inputs``, a trailing partial block is
        rendered with the missing input samples zero-padded.
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
        while rendered < n_blocks and not self.freed:
            n = min(chunk, n_blocks - rendered)
            self._ensure_compiled()
            cg = self.compiled
            per_block = self._collect_due_events(n)
            eventful = [any(pb) for pb in per_block]
            program = self._chunk_program(per_block, eventful) if (
                n >= 2 and any(eventful)) else None
            if program is not None:
                self.state, out, done = program(self.state, inputs_for(rendered, n))
                outs.append(out)
                self._done(done)
                self.graph.clock.frames += n * B
                rendered += n
                continue
            bi = 0
            while bi < n:
                flag, run = eventful[bi], 1
                while bi + run < n and eventful[bi + run] == flag:
                    run += 1
                if not flag and run >= 2:
                    # an event-free run of a length built before: one superblock
                    exact = get_super_fn(cg, run, existing_only=True)
                    if exact is not None:
                        self.state, out, done = exact(self.state, inputs_for(rendered, run))
                        outs.append(out)
                        self._done(done)
                        self.graph.clock.frames += run * B
                        rendered += run
                        bi += run
                        continue
                while run:
                    sub = chunk
                    while sub > run:
                        sub //= 2
                    inp = inputs_for(rendered, sub)
                    fn = None
                    if sub >= MIN_SCAN and flag:
                        evs = [self._events(lists) for lists in per_block[bi:bi + sub]]
                        fn = (lambda st, x, f=get_full_scan_fn(cg), evs=evs:
                              f(st, evs, x))
                    elif sub >= 2 and not flag:
                        fn = get_super_fn(cg, sub)
                        if fn is None and sub >= MIN_SCAN:
                            k = self._super_scan_k(sub)
                            fn = (get_super_scan_fn(cg, k) if k else None) or get_scan_fn(cg)
                    if fn is not None:
                        self.state, out, done = fn(self.state, inp)
                    else:
                        sub = 1
                        inp = inputs_for(rendered, 1)
                        if flag:
                            self.state, out, done = cg.render(
                                self.state, self._events(per_block[bi]), inp)
                        else:
                            self.state, out, done = cg.render_fast(self.state, inp)
                    outs.append(out)
                    self._done(done)
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

    # ------------------------------------------------------- checkpoints
    def save_state(self, path: str) -> None:
        """Checkpoint the complete DSP state to ``path`` (the JAX package's
        ``save_state``): a pickle of the state's leaves as numpy arrays, each
        beside its path of keys, with the frame clock, the revision and the
        sub-block remainder, so a bounce resumes sample-exactly. Restore
        into a processor whose graph has the same topology."""
        self._ensure_compiled()
        leaves = _flatten(self.state)
        blob = {
            "paths": [p for p, _ in leaves],
            "leaves": [x.detach().cpu().numpy() for _, x in leaves],
            "clock": self.graph.clock.frames,
            "revision": self.graph.revision,
            "pending": self._pending,
        }
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load_state(self, path: str) -> None:
        """Restore a checkpoint of ``save_state``: each leaf onto the device
        and dtype of the leaf at its path in the processor's own state; the
        clock and the remainder too. Where the structure changed, the
        checkpoint's tree is restored as it was saved (on the processor's
        device), as the JAX package does."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        self._ensure_compiled()
        saved = dict(zip(blob["paths"], blob["leaves"]))
        ref = _flatten(self.state)

        def restore(x, like=None):
            t = torch.from_numpy(np.array(x))
            return (t.to(self.device) if like is None
                    else t.to(device=like.device, dtype=like.dtype))

        if set(saved) == {p for p, _ in ref}:
            state = _unflatten((p, restore(saved[p], like)) for p, like in ref)
        else:
            state = _unflatten((p, restore(x)) for p, x in saved.items())
        self.state = state
        self.graph.clock.frames = blob["clock"]
        self._pending = blob.get("pending")

