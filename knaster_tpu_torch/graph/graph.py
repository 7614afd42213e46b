"""Port of knaster_tpu/graph/graph.py: the control-side editor of the audio node DAG.

Plain Python, as in the JAX package (a re-design of knaster_graph/src/graph.rs
as a plain Python structure). Committing a Graph bumps its revision; the
processor then compiles it into a block renderer (see compile.py). Node
state survives recompiles by being carried in a dict keyed by stable node
ids — the functional equivalent of the reference's
``UGenEnum::TakeFromTask`` state migration (knaster_graph/src/node.rs:132-150).

Feature parity map:
* additive connections (graph.rs connect_to_node_internal:768-822): multiple
  edges per sink channel are summed by the renderer, so no synthetic Add
  nodes are needed.
* feedback edges (graph.rs new_feedback_nodes:882-909): an edge flagged
  ``feedback=True`` reads the source's *previous block* output from the
  state — the FeedbackSink/Source node pair collapses into one state entry.
* cycle detection (graph.rs has_path:1462-1483): DFS, raises GraphError.
* node mortality (graph.rs:179, set_mortality:2082) and done actions
  (wrappers_graph/done.rs WrDone): per-node policy; done flags come back from
  the device each block and the processor frees accordingly.
* auto-created Constant/Math nodes from operator sugar are garbage-collected
  when orphaned (graph.rs evaluate_if_node_should_be_removed:1098-1161).
* subgraphs (graph.rs subgraph_init:1436-1459): a child Graph pushed as a
  node; compilation inlines it.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..core.ugen import UGen
from ..primitives.floats import as_torch_dtype
from .handles import K_GRAPH_IN, K_NODE, Handle, Source
from .scheduling import ScheduledEvent, Time


class GraphError(Exception):
    """Base class for control-side graph errors (reference
    knaster_graph GraphError, graph.rs:533). Raised on the editing
    thread; the render path itself never throws."""


class CircularConnection(GraphError):
    """Connecting here would create a cycle without a feedback edge
    (reference GraphError::CircularConnection). Use ``to_feedback`` for
    intentional loops — it inserts the one-block feedback delay."""


class NodeFreed(GraphError):
    """A handle's node no longer exists (reference: abandoned-channel
    detection, handle.rs:56-60). Raised when scheduling on, connecting,
    or inspecting a freed node."""


class Done(enum.Enum):
    """Action when a node flags done (reference knaster_core lib.rs:72)."""

    NONE = 0
    FREE_SELF = 1
    FREE_PARENT = 2


@dataclass
class Edge:
    """One input edge: where a sink channel reads from.

    kind: 'node' (same-block output), 'graph_in' (graph input channel) or
    'feedback' (source node's previous-block output).
    """

    kind: str
    src: Optional[int]  # node id (node/feedback) or None (graph_in)
    ch: int


@dataclass
class NodeEntry:
    nid: int
    ugen: Optional[UGen]
    name: str
    inputs: int
    outputs: int
    done_action: Done = Done.NONE
    mortal: bool = True
    auto: bool = False  # auto-created by operator sugar; GC'd when orphaned
    subgraph: Optional["Graph"] = None


class _FrameClock:
    """Shared frame clock (reference scheduling.rs:51-66 SharedFrameClock)."""

    def __init__(self):
        self.frames: int = 0


class Graph:
    """A dynamically editable audio graph."""

    _GLOBAL_GRAPH_ID = [0]

    def __init__(
        self,
        inputs: int = 0,
        outputs: int = 2,
        sample_rate: int = 48000,
        block_size: int = 64,
        dtype=None,
        name: str = "graph",
        parent: Optional["Graph"] = None,
    ):
        self.inputs = int(inputs)
        self.outputs = int(outputs)
        self.sample_rate = int(sample_rate)
        self.block_size = int(block_size)
        self.dtype = as_torch_dtype(dtype)
        self.name = name
        self.parent = parent
        self.graph_id = Graph._GLOBAL_GRAPH_ID[0]
        Graph._GLOBAL_GRAPH_ID[0] += 1

        self.nodes: Dict[int, NodeEntry] = {}
        # sink node id -> per input channel -> list of additive edges
        self.in_edges: Dict[int, List[List[Edge]]] = {}
        # graph outputs: per out channel -> list of additive edges
        self.out_edges: List[List[Edge]] = [[] for _ in range(self.outputs)]
        # (sink nid, param idx) -> Edge  — audio-rate param modulation
        # (reference WrArParamToInput, wrappers_core/audio_rate.rs:92-171)
        self.param_edges: Dict[Tuple[int, int], Edge] = {}

        self.event_queue: List[ScheduledEvent] = []
        # guards event_queue swaps/appends AND the _event_order counter:
        # the processor's drain swaps the list out while control threads
        # append/extend, and a load-then-call (`q = root.event_queue;
        # q.extend(...)`) can straddle the swap and land events on the
        # abandoned list (CPython can switch threads between the attribute
        # load and the method call — the GIL does not make that atomic)
        self.event_lock = threading.Lock()
        self._event_order = 0
        self.revision = 0  # bumped on every structural change
        self.clock = parent.clock if parent else _FrameClock()
        self._id_counter = parent._id_counter if parent else [0]
        self.freed = False

    # ------------------------------------------------------------------ ids
    def root(self) -> "Graph":
        g = self
        while g.parent is not None:
            g = g.parent
        return g

    def _alloc_id(self) -> int:
        self._id_counter[0] += 1
        return self._id_counter[0]

    def _node(self, nid: int) -> NodeEntry:
        try:
            return self.nodes[nid]
        except KeyError:
            # search subgraphs so handles work from the root
            for e in self.nodes.values():
                if e.subgraph is not None:
                    try:
                        return e.subgraph._node(nid)
                    except NodeFreed:
                        pass
            raise NodeFreed(f"node {nid} does not exist (freed?)") from None

    def _owning_graph(self, nid: int) -> "Graph":
        if nid in self.nodes:
            return self
        for e in self.nodes.values():
            if e.subgraph is not None:
                try:
                    return e.subgraph._owning_graph(nid)
                except NodeFreed:
                    pass
        raise NodeFreed(f"node {nid} does not exist (freed?)")

    # ------------------------------------------------------------------ edit
    def edit(self, fn: Callable[["Graph"], Any]):
        """Run ``fn(self)`` and commit (reference graph.rs:1410 Graph::edit)."""
        result = fn(self)
        self.commit()
        return result

    def commit(self) -> None:
        """Finalize pending structural edits (graph.rs commit_changes:1707).

        Garbage-collects orphaned auto nodes and bumps the revision so the
        processor recompiles before the next block.
        """
        self._gc_auto_nodes()
        self._touch()

    def _touch(self) -> None:
        self.revision += 1
        if self.parent is not None:
            self.parent._touch()

    # ------------------------------------------------------------------ push
    def push(self, ugen: UGen, name: Optional[str] = None) -> Handle:
        return self.push_with_done_action(ugen, Done.NONE, name=name)

    def push_with_done_action(
        self, ugen: UGen, done_action: Done, name: Optional[str] = None
    ) -> Handle:
        """Push a UGen; with a done action it frees itself/its graph when done
        (reference graph_edit.rs:102 push_with_done_action + WrDone)."""
        if not isinstance(ugen, UGen):
            raise TypeError(f"push expects a UGen, got {type(ugen)!r}")
        nid = self._alloc_id()
        entry = NodeEntry(
            nid=nid,
            ugen=ugen,
            name=name or f"{ugen.name()}_{nid}",
            inputs=ugen.inputs,
            outputs=ugen.outputs,
            done_action=done_action,
        )
        self.nodes[nid] = entry
        self.in_edges[nid] = [[] for _ in range(entry.inputs)]
        self._touch()
        return Handle(self, nid)

    def subgraph(
        self,
        inputs: int = 0,
        outputs: int = 2,
        name: str = "subgraph",
        done_action: Done = Done.NONE,
    ) -> Tuple["Graph", Handle]:
        """Create a child Graph usable as a node (graph.rs subgraph_init:1436)."""
        child = Graph(
            inputs=inputs,
            outputs=outputs,
            sample_rate=self.sample_rate,
            block_size=self.block_size,
            dtype=self.dtype,
            name=name,
            parent=self,
        )
        nid = self._alloc_id()
        entry = NodeEntry(
            nid=nid,
            ugen=None,
            name=name,
            inputs=inputs,
            outputs=outputs,
            done_action=done_action,
            subgraph=child,
        )
        self.nodes[nid] = entry
        self.in_edges[nid] = [[] for _ in range(inputs)]
        child.node_id_in_parent = nid
        self._touch()
        return child, Handle(self, nid)

    def handle(self, nid: int) -> Handle:
        self._node(nid)
        return Handle(self, nid)

    def handle_from_name(self, name: str) -> Optional[Handle]:
        """Find a node by name, searching subgraphs depth-first (consistent
        with ``handle(nid)``, which also resolves into subgraphs)."""
        for nid, e in self.nodes.items():
            if e.name == name:
                return Handle(self, nid)
        for e in self.nodes.values():
            if e.subgraph is not None:
                h = e.subgraph.handle_from_name(name)
                if h is not None:
                    return h
        return None

    def from_inputs(self, chs) -> Source:
        """Handle over graph input channels (graph_edit.rs:189 from_inputs)."""
        if isinstance(chs, int):
            chs = [chs]
        for c in chs:
            if not 0 <= c < self.inputs:
                raise GraphError(f"graph has no input channel {c}")
        return Source(self, [(K_GRAPH_IN, None, c) for c in chs])

    # ------------------------------------------------------------ connections
    def connect(
        self,
        src: Union[Handle, int],
        src_ch: int,
        dst_ch: int,
        dst: Union[Handle, int, str],
        *,
        replace: bool = False,
        feedback: bool = False,
    ) -> None:
        """Low-level connect (reference Graph::connect2). dst may be 'graph'."""
        src_nid = src.node_id if isinstance(src, Handle) else int(src)
        self._node(src_nid)
        if isinstance(dst, str) and dst == "graph":
            self._add_out_edge(Edge(K_NODE if not feedback else "feedback", src_nid, src_ch), dst_ch, replace)
            return
        dst_nid = dst.node_id if isinstance(dst, Handle) else int(dst)
        self._add_edge(src_nid, src_ch, dst_nid, dst_ch, replace=replace, feedback=feedback)

    def connect_param(
        self, src: Union[Handle, int], src_ch: int, dst: Union[Handle, int], param
    ) -> None:
        """Audio-rate parameter modulation: the named float parameter of
        ``dst`` follows ``src``'s output signal sample-by-sample (reference
        WrArParams/set_ar_param_buffer, wrappers_core/audio_rate.rs:11-85)."""
        src_nid = src.node_id if isinstance(src, Handle) else int(src)
        dst_nid = dst.node_id if isinstance(dst, Handle) else int(dst)
        entry = self._node(dst_nid)
        pidx = entry.ugen.param_index(param)
        if entry.ugen.params[pidx].ptype != "float":
            raise GraphError("audio-rate modulation only applies to float params")
        if self._would_cycle(src_nid, dst_nid):
            raise CircularConnection(
                f"audio-rate param edge {src_nid}->{dst_nid} would create a cycle"
            )
        self.param_edges[(dst_nid, pidx)] = Edge(K_NODE, src_nid, src_ch)
        self._touch()

    def disconnect_param(self, dst: Union[Handle, int], param) -> None:
        dst_nid = dst.node_id if isinstance(dst, Handle) else int(dst)
        entry = self._node(dst_nid)
        pidx = entry.ugen.param_index(param)
        self.param_edges.pop((dst_nid, pidx), None)
        self._touch()

    def _add_edge(self, src_nid, src_ch, dst_nid, dst_ch, *, replace, feedback):
        src_e = self._node(src_nid)
        dst_e = self._node(dst_nid)
        if not 0 <= src_ch < src_e.outputs:
            raise GraphError(f"source {src_e.name} has no output channel {src_ch}")
        if not 0 <= dst_ch < dst_e.inputs:
            raise GraphError(f"sink {dst_e.name} has no input channel {dst_ch}")
        if not feedback and self._would_cycle(src_nid, dst_nid):
            raise CircularConnection(
                f"connecting {src_e.name}->{dst_e.name} would create a cycle; "
                f"use to_feedback for a one-block delayed loop"
            )
        owner = self._owning_graph(dst_nid)
        lst = owner.in_edges[dst_nid][dst_ch]
        if replace:
            lst.clear()
        lst.append(Edge("feedback" if feedback else K_NODE, src_nid, src_ch))
        self._touch()

    def _add_out_edge(self, edge: Edge, out_ch: int, replace: bool):
        if not 0 <= out_ch < self.outputs:
            raise GraphError(f"graph has no output channel {out_ch}")
        lst = self.out_edges[out_ch]
        if replace:
            lst.clear()
        lst.append(edge)
        self._touch()

    def _connect_source(self, source: Source, dst: Handle, *, replace, feedback):
        dst_e = self._node(dst.node_id)
        n_src = len(source.channels)
        if n_src != dst_e.inputs:
            if n_src == 1 and dst_e.inputs > 1:
                chans = source.channels * dst_e.inputs
            else:
                raise GraphError(
                    f"channel count mismatch: source has {n_src}, "
                    f"{dst_e.name} has {dst_e.inputs} inputs"
                )
        else:
            chans = source.channels
        # replace clears each target channel once, then adds
        for dst_ch, (kind, nid, ch) in enumerate(chans):
            if replace:
                self._owning_graph(dst.node_id).in_edges[dst.node_id][dst_ch].clear()
            if kind == K_GRAPH_IN:
                if feedback:
                    raise GraphError("feedback from graph inputs is meaningless")
                owner = self._owning_graph(dst.node_id)
                owner.in_edges[dst.node_id][dst_ch].append(Edge(K_GRAPH_IN, None, ch))
                self._touch()
            else:
                self._add_edge(nid, ch, dst.node_id, dst_ch, replace=False, feedback=feedback)

    def _connect_source_to_out(self, source: Source, sink_channels: List[int], *, replace):
        if len(sink_channels) != len(source.channels):
            raise GraphError(
                f"channel count mismatch: source has {len(source.channels)} "
                f"channels, got {len(sink_channels)} sink channels"
            )
        if replace:
            for oc in set(sink_channels):
                if not 0 <= oc < self.outputs:
                    raise GraphError(f"graph has no output channel {oc}")
                self.out_edges[oc].clear()
        for oc, (kind, nid, ch) in zip(sink_channels, source.channels):
            if kind == K_GRAPH_IN:
                self._add_out_edge(Edge(K_GRAPH_IN, None, ch), oc, replace=False)
            else:
                self._add_out_edge(Edge(K_NODE, nid, ch), oc, replace=False)

    # --------------------------------------------------------- disconnection
    def disconnect_output_from_source(self, src, src_ch: int) -> None:
        """Remove all edges fed by (src, src_ch) (graph_edit.rs:407)."""
        src_nid = src.node_id if isinstance(src, Handle) else int(src)

        def keep(e: Edge) -> bool:
            return not (e.src == src_nid and e.ch == src_ch)

        g = self._owning_graph(src_nid)
        for lists in g.in_edges.values():
            for lst in lists:
                lst[:] = [e for e in lst if keep(e)]
        for lst in g.out_edges:
            lst[:] = [e for e in lst if keep(e)]
        self._touch()

    def disconnect_input_to_sink(self, sink_ch: int, dst) -> None:
        dst_nid = dst.node_id if isinstance(dst, Handle) else int(dst)
        g = self._owning_graph(dst_nid)
        g.in_edges[dst_nid][sink_ch].clear()
        self._touch()

    # ----------------------------------------------------------------- free
    def free_node(self, nid_or_handle) -> None:
        nid = nid_or_handle.node_id if isinstance(nid_or_handle, Handle) else int(nid_or_handle)
        g = self._owning_graph(nid)
        entry = g.nodes[nid]
        if not entry.mortal:
            raise GraphError(f"node {entry.name} is immortal (set_mortality)")
        g._free_node_unchecked(nid)
        g._gc_auto_nodes()
        self._touch()

    def _free_node_unchecked(self, nid: int) -> None:
        self.nodes.pop(nid, None)
        self.in_edges.pop(nid, None)
        for lists in self.in_edges.values():
            for lst in lists:
                lst[:] = [e for e in lst if e.src != nid]
        for lst in self.out_edges:
            lst[:] = [e for e in lst if e.src != nid]
        for key in [k for k, e in self.param_edges.items() if e.src == nid or k[0] == nid]:
            del self.param_edges[key]

    def set_mortality(self, nid_or_handle, mortal: bool) -> None:
        nid = nid_or_handle.node_id if isinstance(nid_or_handle, Handle) else int(nid_or_handle)
        self._node(nid).mortal = bool(mortal)

    def _gc_auto_nodes(self) -> None:
        """Free operator-sugar nodes whose outputs no longer feed anything —
        or whose INPUTS lost their source (freeing a sine must also collect
        its dangling ``(sine * 0.001)`` sugar chain, so a push/free cycle
        returns to the exact prior topology).
        Reference: graph.rs evaluate_if_node_should_be_removed:1098-1161."""
        changed = True
        while changed:
            changed = False
            consumed = set()
            for lists in self.in_edges.values():
                for lst in lists:
                    for e in lst:
                        consumed.add(e.src)
            for lst in self.out_edges:
                for e in lst:
                    consumed.add(e.src)
            for e in self.param_edges.values():
                consumed.add(e.src)
            for nid in list(self.nodes):
                entry = self.nodes[nid]
                if not entry.auto:
                    continue
                dangling = entry.inputs > 0 and any(
                    not lst for lst in self.in_edges.get(nid, [])
                )
                if nid not in consumed or dangling:
                    self._free_node_unchecked(nid)
                    changed = True

    # --------------------------------------------------- operator-sugar nodes
    def _push_constant(self, value: float) -> Source:
        from ..ugens.util import Constant

        h = self.push(Constant(value))
        self._node(h.node_id).auto = True
        return h

    def _push_math_op(self, op: str, lhs: Source, rhs: Source) -> Source:
        from ..ugens.math import MathUGen

        n_l, n_r = len(lhs.channels), len(rhs.channels)
        channels = max(n_l, n_r)
        if n_l not in (1, channels) or n_r not in (1, channels):
            raise GraphError(
                f"operator channel mismatch: {n_l} vs {n_r} channels"
            )
        node = self.push(MathUGen(op, channels))
        self._node(node.node_id).auto = True
        for c in range(channels):
            lk, ln, lc = lhs.channels[c % n_l]
            rk, rn, rc = rhs.channels[c % n_r]
            for (kind, nid, ch), dst_ch in (((lk, ln, lc), c), ((rk, rn, rc), channels + c)):
                if kind == K_GRAPH_IN:
                    self.in_edges[node.node_id][dst_ch].append(Edge(K_GRAPH_IN, None, ch))
                else:
                    self._add_edge(nid, ch, node.node_id, dst_ch, replace=False, feedback=False)
        return node

    # ------------------------------------------------------------- scheduling
    def set(self, node, param, value, t: Time = None) -> None:
        """Direct parameter set (reference GraphEdit::set, graph_edit.rs:149)."""
        h = node if isinstance(node, Handle) else self.handle(int(node))
        p = h.param(param)
        p.set_time(value, t or Time.asap())

    def _queue_event(self, node_id: int, param_idx: int, payload, t: Time,
                     token=None) -> None:
        self._node(node_id)  # raises if freed
        root = self.root()
        if root.freed:
            raise NodeFreed("graph was freed")
        sr = self.sample_rate

        def make() -> ScheduledEvent:
            # time resolves HERE — immediately, or at token activation so
            # every change in a token batch shares the same reference frame
            if t.kind == "asap":
                due = -1  # next block, frame 0
            elif t.kind == "at":
                due = t.seconds.to_samples(sr)
            elif t.kind == "after":
                due = root.clock.frames + t.seconds.to_samples(sr)
            else:
                raise ValueError(t.kind)
            ev = ScheduledEvent(
                due, node_id, param_idx, payload, order=root._event_order
            )
            root._event_order += 1
            return ev

        if token is not None:
            token._hold(root, make)
            return
        with root.event_lock:
            root.event_queue.append(make())

    # ------------------------------------------------------------- inspection
    def all_entries(self) -> Dict[int, NodeEntry]:
        """All nodes including subgraph nodes, flattened."""
        out: Dict[int, NodeEntry] = {}

        def walk(g: Graph):
            for nid, e in g.nodes.items():
                out[nid] = e
                if e.subgraph is not None:
                    walk(e.subgraph)

        walk(self)
        return out

    # ------------------------------------------------------------ cycle check
    def _successors(self, nid: int) -> List[int]:
        g = self._owning_graph(nid)
        succ = []
        for dst, lists in g.in_edges.items():
            for lst in lists:
                for e in lst:
                    if e.kind == K_NODE and e.src == nid:
                        succ.append(dst)
        for (dst, _pidx), e in g.param_edges.items():
            if e.kind == K_NODE and e.src == nid:
                succ.append(dst)
        return succ

    def _would_cycle(self, src_nid: int, dst_nid: int) -> bool:
        """True if a forward path dst -> ... -> src already exists
        (reference has_path DFS, graph.rs:1462-1483)."""
        if src_nid == dst_nid:
            return True
        seen = set()
        stack = [dst_nid]
        while stack:
            n = stack.pop()
            if n == src_nid:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._successors(n))
        return False
