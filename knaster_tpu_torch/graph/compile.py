"""Port of knaster_tpu/graph/compile.py: graph -> a block renderer.

``compile_graph`` resolves the graph's edges (subgraphs inlined), orders the
nodes, plans their execution and builds two renderers over one state dict
``{"nodes", "pe", "fb"}``: ``render(state, events, inputs)`` for blocks
with events and ``render_fast(state, inputs)`` for event-free blocks. Where
the JAX package traces them into XLA programs, the port runs them eagerly.

Superblocks: ``get_super_fn(cg, m)`` is the event-free renderer built at
block m*B (the JAX package's superblock fast program), for graphs that pass
``superblock_eligible``; ``get_super_scan_fn`` covers a run longer than the
graph's cap as a loop of capped superblocks (a Python loop where the JAX
package scans). ``processor.render`` splits a bounce into them as the JAX
package does.

The live path's programs, which a stream warms and a bounce then takes
(``existing_only``): ``get_full_super_fn`` (the eventful renderer at m*B,
event frames relative to the superblock), ``get_full_super_scan_fn`` (a
loop of eventful k-superblocks for capped graphs), ``get_evchunk_fn``
(an eventful block 0, then the event-free (n-1)-superblock, or a loop of
``render_fast`` where the graph takes no superblock of that length), and
the float-event programs ``get_float_fn`` / ``get_float_evchunk_fn``,
whose collapsed chains stay on the chain kernel in blocks whose events
carry no trigger. Each is a closure over renderers built once; "built"
means the same here as "compiled" in the JAX package, so both take the
same partition.

The program and plan caches (the JAX package's, compile.py:1055-1233): a
compile whose structural signature (``_structural_signature``: every
node's config frozen at push time by ``core/signature.py``, the wiring in
canonical positions, the device and the chain-collapse switches) matches
an earlier one takes that compile's renderers, its lazily built programs
(the entry holds the dicts each ``get_*_fn`` fills) and its plan, whose
chains share their lowered chain-kernel programs (``ChainPlan.lowered``),
so ``chain_kernel.lower`` runs once per signature and device. Only the
param layout and ``init_state``'s carry are built anew. A reused renderer
runs the first compile's UGens: what the signature leaves out of a UGen
(``signature_exclude``: param defaults, a bank's voice defaults, a
wavetable, an IR) reaches ``process`` only as state or param data, which
the new compile builds. The processor's warm executes only the programs an
entry has not warmed yet (``cache_entry["warmed"]``). ``clear_program_cache``
empties both caches; a graph holding an unfreezable UGen (signature None)
compiles fresh every time.

The plan (``_plan_batches``) follows the JAX package exactly, so state keys
(``state_key``, ``group_key``, ``chain_key``) name the same nodes in both:

* ``single``: one node's ``process``;
* ``batch``: same-kind nodes at one dataflow depth, as ONE call with a
  leading batch axis (the JAX package's ``vmap``);
* ``chain``: a collapsed run of K isomorphic units (``_find_chains``). On
  the fast and float-event renderers it runs the chain kernel
  (``chain_kernel.run``: one CUDA kernel for the whole stage loop, done
  rows included) when the device is a card; the scan executor (a loop over
  the stages) runs where the JAX package runs it: eventful blocks, f64, a
  unit with no body, except that in a block with triggers only the
  stages they touch leave the kernel.

* Additive connects: summed by the renderer.
* A node with its own event channel (a fused voice bank) gets its events
  under ``event_key`` in eventful blocks, None in the event-free renderers.
* Feedback edges: read previous-block outputs carried in ``state["fb"]``.
* Node state survives recompiles: ``init_state(prev, prev_compiled)``
  re-keys the state by stable node ids (UGenEnum::TakeFromTask parity,
  node.rs:132-150).
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.ugen import AudioCtx, normalize_process_result
from . import chain_kernel
from .graph import Done, Graph, GraphError, NodeEntry
from .handles import K_GRAPH_IN
from .param_engine import ParamLayout, PEngine, _np_dtype, events_from_lists
from .param_engine import init_state as pe_init_state

# chain collapse: a run of at least MIN_CHAIN_STAGES units of at most
# MAX_CHAIN_PERIOD nodes (the JAX package's defaults). Tests switch the pass
# off through the module attribute.
MIN_CHAIN_STAGES = 8
MAX_CHAIN_PERIOD = 16
_CHAIN_COLLAPSE_ON = True


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _tree_stack(trees):
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


@dataclass
class ChainPlan:
    """One collapsed chain: K stages of p nodes each.

    ``in_pattern[j]``   — per input channel of unit node j, a tuple of source
                          descriptors: ``('rel', r, ch)`` with ``-p <= r < p``
                          (r >= 0: node at offset r in the SAME stage; r < 0:
                          node at offset p+r in the PREVIOUS stage) or
                          ``('abs', kind, src_nid, ch)`` (the same external
                          source for every stage).
    ``pe_pattern[j]``    — param-edge descriptors per param index, same forms.
    ``carry_keys``       — sorted ``(prev_offset_j, ch)`` pairs the stage
                          body reads from the previous stage (the carry).
    ``carry_init``       — for stage 0, the external source feeding each
                          carry key: ``(kind, src_nid, ch)``.
    ``lowered``          — the chain kernel's program for this plan by
                          device, built at first use (``chain_kernel.run``);
                          ``seg_lowered`` the same for the runs of stages of
                          a block with triggers (``_chain_stages``). The
                          plan cache shares both dicts among every plan of
                          one signature.
    """

    stages: List[List[int]]
    period: int
    in_pattern: List[Tuple]
    pe_pattern: List[Tuple]
    carry_keys: List[Tuple[int, int]]
    carry_init: Dict[Tuple[int, int], Tuple[str, Optional[int], int]]
    lowered: Any = field(default_factory=dict)
    seg_lowered: Any = field(default_factory=dict)


@dataclass
class CompiledGraph:
    graph: Graph
    ctx: AudioCtx
    device: torch.device
    layout: ParamLayout
    engine: PEngine
    order: List[int]
    entries: Dict[int, NodeEntry]
    resolved_in: Dict[int, List[List[Tuple[str, Optional[int], int]]]]
    resolved_out: List[List[Tuple[str, Optional[int], int]]]
    resolved_param_edges: Dict[Tuple[int, int], Tuple[int, int]]
    fb_sources: List[Tuple[int, int]]
    event_capacity: int
    # host-side free bookkeeping: flattened nid -> chain of enclosing
    # subgraph node ids (innermost first), for Done.FREE_PARENT routing
    enclosing: Dict[int, List[int]]
    render: Any = None  # fn(state, events, inputs) -> (state, out, done)
    render_fast: Any = None  # fn(state, inputs) -> (state, out, done)
    plan: Any = None  # [('single', nid) | ('batch', [nids]) | ('chain', ChainPlan)]
    done_order: Any = None  # node ids in done_vec order (plan order)
    revision: int = -1
    # canonical node labels (position in topo order): state keys use these,
    # as in the JAX package
    canon: Dict[int, int] = field(default_factory=dict)
    # superblocks (superblock_eligible): None until asked; the longest
    # superblock in samples; the event-free renderers built at m * B
    superblock_ok: Optional[bool] = None
    superblock_max: float = math.inf
    super_fns: Dict[Any, Any] = field(default_factory=dict)
    # the live path's programs, built on request (``existing_only`` reads
    # them without building): eventful chunks by length, the float-event
    # programs, the chunk lengths whose whole-chunk full scan was warmed
    evchunk_fns: Dict[int, Any] = field(default_factory=dict)
    float_fns: Dict[Any, Any] = field(default_factory=dict)
    full_scan_warm: set = field(default_factory=set)
    # the block loops of ``render_fast`` and ``render`` (get_scan_fn,
    # get_full_scan_fn), built on request
    scan_fn: Any = None
    full_scan_fn: Any = None
    # the program cache: the structural signature (None = uncacheable),
    # whether this compile took an earlier one's renderers, and the shared
    # entry its lazily built programs register into
    signature: Any = None
    cache_hit: bool = False
    cache_entry: Optional[dict] = None
    # host ms of this compile's plan (found or taken from the plan cache)
    # and of the rest of compile_graph (layout, renderers or the lookup)
    compile_ms: Dict[str, float] = field(default_factory=dict)

    # ----------------------------------------------------- canonical keys
    def state_key(self, nid: int) -> str:
        return str(self.canon[nid])

    def group_key(self, nids: List[int]) -> str:
        return f"b{self.canon[nids[0]]}"

    def fb_key(self, nid: int, ch: int) -> str:
        return f"{self.canon[nid]}:{ch}"

    def chain_key(self, cp: "ChainPlan") -> str:
        return f"c{self.canon[cp.stages[0][0]]}"

    def event_key(self, nid: int) -> str:
        """The key of a node's own events (a voice bank's) in a block's
        event dict."""
        return f"n{self.canon[nid]}"

    def events_from_lists(self, fl, tl, il, nd) -> dict:
        """A block's event dict (numpy): the param engine's float, trigger
        and int events, and under ``event_key`` the events of every node
        with an event channel (``event_capacity > 0``) from ``nd`` {node
        id: [(frame, voice, param, kind, value)]}, empty for a node that
        has none."""
        dtype = _np_dtype(self.ctx.dtype)
        ev = events_from_lists(self.event_capacity, fl, tl, il, dtype=dtype)
        for nid in self.order:
            ugen = self.entries[nid].ugen
            if ugen.event_capacity > 0:
                ev[self.event_key(nid)] = ugen.node_events_from_lists(nd.get(nid, []),
                                                                     dtype=dtype)
        return ev

    # ------------------------------------------------------------------
    def _node_loc(self, nid: int):
        """('single', state_key) | ('batch', group_key, index) |
        ('chain', chain_key, stage_k, offset_j) | None."""
        cache = getattr(self, "_loc_cache", None)
        if cache is None:
            cache = {}
            for kind, item in self.plan:
                if kind == "single":
                    cache[item] = ("single", self.state_key(item))
                elif kind == "batch":
                    gk = self.group_key(item)
                    for i, n in enumerate(item):
                        cache[n] = ("batch", gk, i)
                else:  # chain
                    ck = self.chain_key(item)
                    for k, stage in enumerate(item.stages):
                        for j, n in enumerate(stage):
                            cache[n] = ("chain", ck, k, j)
            self._loc_cache = cache
        return cache.get(nid)

    def _extract_node_state(self, state: dict, nid: int):
        """One node's state out of this compile's (possibly batched or
        chain-stacked) state layout; None if absent."""
        loc = self._node_loc(nid)
        if loc is None:
            return None
        if loc[0] == "single":
            return state["nodes"].get(loc[1])
        stacked = state["nodes"].get(loc[1])
        if stacked is not None and loc[0] == "chain":
            stacked = stacked.get(f"j{loc[3]}")
        if stacked is None:
            return None
        return _tree_map(lambda x: x[loc[2]], stacked)

    def init_state(self, prev: Optional[dict] = None,
                   prev_compiled: Optional["CompiledGraph"] = None) -> dict:
        """Build the state dict, carrying state over from a previous commit
        (TakeFromTask parity: same node id => same state). Batched groups
        and chain offsets store their members' states stacked on a leading
        axis."""
        ctx, device = self.ctx, self.device

        def node_state(nid):
            if prev is not None and prev_compiled is not None:
                old = prev_compiled._extract_node_state(prev, nid)
                if old is not None:
                    return old
            return self.entries[nid].ugen.init(ctx, device)

        nodes = {}
        for kind, item in self.plan:
            if kind == "single":
                nodes[self.state_key(item)] = node_state(item)
            elif kind == "batch":
                nodes[self.group_key(item)] = _tree_stack([node_state(n) for n in item])
            else:  # chain: per unit offset, states stacked over the stage axis
                nodes[self.chain_key(item)] = {
                    f"j{j}": _tree_stack([node_state(s[j]) for s in item.stages])
                    for j in range(item.period)
                }
        pe = pe_init_state(self.layout, dtype=ctx.dtype, device=device)
        if prev is not None and prev_compiled is not None:
            old = prev.get("pe", {})
            old_layout = prev_compiled.layout
            # carry per-slot float/int values across the re-layout with ONE
            # gather+scatter per array
            f_new, f_old, i_new, i_old = [], [], [], []
            for (nid, pidx), (typ, slot) in self.layout.slots.items():
                o = old_layout.slots.get((nid, pidx))
                if o is None or o[0] != typ:
                    continue
                if typ == "float":
                    f_new.append(slot)
                    f_old.append(o[1])
                elif typ == "int":
                    i_new.append(slot)
                    i_old.append(o[1])
            if f_new:
                ni = torch.tensor(f_new, device=device)
                oi = torch.tensor(f_old, device=device)
                for k in ("value", "target", "step", "elapsed", "dur",
                          "smode", "sdur", "srate"):
                    pe[k][ni] = old[k][oi]
            if i_new:
                ni = torch.tensor(i_new, device=device)
                oi = torch.tensor(i_old, device=device)
                pe["int_value"][ni] = old["int_value"][oi]
        fb = {}
        prev_fb = (prev or {}).get("fb", {})
        for (nid, ch) in self.fb_sources:
            key = self.fb_key(nid, ch)
            # carry feedback buffers by *node id* across recompiles (the
            # canonical key can shift when topology changes)
            old_key = (
                prev_compiled.fb_key(nid, ch)
                if prev_compiled is not None and nid in prev_compiled.canon
                else None
            )
            fb[key] = (
                prev_fb[old_key]
                if old_key is not None and old_key in prev_fb
                else torch.zeros((ctx.block_size,), dtype=ctx.dtype, device=device)
            )
        return {"nodes": nodes, "pe": pe, "fb": fb}

    @property
    def has_done_actions(self) -> bool:
        """True if any node reacts to done flags — only then does the host
        need to read them back each block (a device->host sync)."""
        return any(e.done_action != Done.NONE for e in self.entries.values())


def resolve_device(device) -> torch.device:
    """The device a graph renders on: the caller's, the card ("cuda") when
    none is named. Raises when that is a card and there is none: the CPU is
    taken only when the caller says ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card is available: graphs render on the card unless the "
                "caller passes device=\"cpu\"")
        if device.index is None:  # the index the tensors made on it carry
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def compile_graph(
    graph: Graph, event_capacity: int = 64, auto_batch: bool = True,
    device="cuda",
) -> CompiledGraph:
    t0 = time.perf_counter()
    device = resolve_device(device)
    root = graph.root()
    ctx = AudioCtx(root.sample_rate, root.block_size, root.dtype)

    entries_all = root.all_entries()
    # flattened processable nodes (subgraph container nodes are inlined away)
    proc_entries = {nid: e for nid, e in entries_all.items() if e.subgraph is None}

    # ------------------------------------------------------------ resolution
    def resolve_edge(g: Graph, edge, *, as_feedback=False, depth=0):
        """Resolve one Edge into concrete sources: ('node'|'feedback', nid, ch)
        or ('graph_in', None, root input ch)."""
        if depth > 64:
            raise GraphError("subgraph boundary resolution too deep (cycle?)")
        out = []
        fb = as_feedback or edge.kind == "feedback"
        if edge.kind == K_GRAPH_IN:
            if g.parent is None:
                out.append(("graph_in", None, edge.ch))
            else:
                parent = g.parent
                container_nid = g.node_id_in_parent
                for e2 in parent.in_edges[container_nid][edge.ch]:
                    out.extend(resolve_edge(parent, e2, as_feedback=fb, depth=depth + 1))
        else:  # node or feedback
            src_entry = entries_all[edge.src]
            if src_entry.subgraph is not None:
                child = src_entry.subgraph
                for e2 in child.out_edges[edge.ch]:
                    out.extend(resolve_edge(child, e2, as_feedback=fb, depth=depth + 1))
            else:
                out.append(("feedback" if fb else "node", edge.src, edge.ch))
        return out

    def owning(nid: int) -> Graph:
        return root._owning_graph(nid)

    resolved_in: Dict[int, List[List[Tuple[str, Optional[int], int]]]] = {}
    for nid, e in proc_entries.items():
        g = owning(nid)
        per_ch = []
        for ch in range(e.inputs):
            srcs = []
            for edge in g.in_edges[nid][ch]:
                srcs.extend(resolve_edge(g, edge))
            per_ch.append(srcs)
        resolved_in[nid] = per_ch

    resolved_out: List[List[Tuple[str, Optional[int], int]]] = []
    for ch in range(root.outputs):
        srcs = []
        for edge in root.out_edges[ch]:
            srcs.extend(resolve_edge(root, edge))
        resolved_out.append(srcs)

    # audio-rate param edges (resolve subgraph boundary on the source side)
    resolved_param_edges: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def collect_param_edges(g: Graph):
        for (dst_nid, pidx), edge in g.param_edges.items():
            srcs = resolve_edge(g, edge)
            if len(srcs) != 1 or srcs[0][0] != "node":
                raise GraphError(
                    "audio-rate param edges must resolve to exactly one "
                    "same-block node output"
                )
            resolved_param_edges[(dst_nid, pidx)] = (srcs[0][1], srcs[0][2])
        for e in g.nodes.values():
            if e.subgraph is not None:
                collect_param_edges(e.subgraph)

    collect_param_edges(root)

    # ------------------------------------------------------------ topo order
    deps: Dict[int, set] = {nid: set() for nid in proc_entries}
    for nid, per_ch in resolved_in.items():
        for srcs in per_ch:
            for kind, s, _c in srcs:
                if kind == "node":
                    deps[nid].add(s)
    for (dst, _pidx), (src, _ch) in resolved_param_edges.items():
        deps[dst].add(src)

    order: List[int] = []
    temp, perm = set(), set()

    def visit(n):
        if n in perm:
            return
        if n in temp:
            raise GraphError("cycle detected at compile time")
        temp.add(n)
        for d in sorted(deps[n]):
            visit(d)
        temp.discard(n)
        perm.add(n)
        order.append(n)

    for n in sorted(proc_entries):
        visit(n)

    # feedback buffers
    fb_set = set()
    for per_ch in resolved_in.values():
        for srcs in per_ch:
            for kind, s, c in srcs:
                if kind == "feedback":
                    fb_set.add((s, c))
    for srcs in resolved_out:
        for kind, s, c in srcs:
            if kind == "feedback":
                fb_set.add((s, c))
    fb_sources = sorted(fb_set)

    # enclosing subgraph-node chains for FREE_PARENT routing
    enclosing: Dict[int, List[int]] = {}
    for nid in order:
        chain = []
        g = owning(nid)
        while g.parent is not None:
            chain.append(g.node_id_in_parent)
            g = g.parent
        enclosing[nid] = chain

    cg = CompiledGraph(
        graph=root,
        ctx=ctx,
        device=device,
        layout=None,  # assigned after planning (slot order follows the plan)
        engine=None,
        order=order,
        entries=proc_entries,
        resolved_in=resolved_in,
        resolved_out=resolved_out,
        resolved_param_edges=resolved_param_edges,
        fb_sources=fb_sources,
        event_capacity=event_capacity,
        enclosing=enclosing,
        revision=root.revision,
        canon={nid: i for i, nid in enumerate(order)},
    )
    # the plan (chain detection especially) is host Python that grows with
    # the graph; it is a function of the structural signature in canonical
    # position space, so it is cached like the renderers and translated
    # back to node ids
    cg.signature = _structural_signature(cg, auto_batch)
    t_plan = time.perf_counter()
    cached_plan = _plan_cache_get(cg.signature)
    if cached_plan is not None:
        cg.plan = _plan_from_pos(order, cached_plan)
    else:
        cg.plan = (_plan_batches(cg) if auto_batch
                   else [("single", nid) for nid in order])
        _plan_cache_put(cg.signature, _plan_to_pos(cg))
    t_built = time.perf_counter()

    # ------------------------------------------------------------ param slots
    # Slot order follows the PLAN: a batch group's members get CONTIGUOUS
    # slots per parameter, a chain's (offset, param) planes contiguous over
    # the stages, so their engine reads are slices
    layout = ParamLayout()
    for kind, item in cg.plan:
        if kind == "single":
            ugen = proc_entries[item].ugen
            for pidx, spec in enumerate(ugen.params):
                layout.add(item, pidx, spec.ptype,
                           _instance_default(ugen, pidx))
        elif kind == "batch":
            rep = proc_entries[item[0]].ugen
            for pidx, spec in enumerate(rep.params):
                for nid in item:
                    ugen = proc_entries[nid].ugen
                    layout.add(nid, pidx, spec.ptype,
                               _instance_default(ugen, pidx))
        else:  # chain: contiguous slots per (offset, param) over the stages
            for j in range(item.period):
                rep = proc_entries[item.stages[0][j]].ugen
                for pidx, spec in enumerate(rep.params):
                    for stage in item.stages:
                        ugen = proc_entries[stage[j]].ugen
                        layout.add(stage[j], pidx, spec.ptype,
                                   _instance_default(ugen, pidx))
    cg.layout = layout
    cg.engine = PEngine(layout, ctx.block_size, dtype=ctx.dtype)

    # done-flag output order: per plan entry; chains stage-major
    done_order: List[int] = []
    for kind, item in cg.plan:
        if kind == "single":
            done_order.append(item)
        elif kind == "batch":
            done_order.extend(item)
        else:
            for stage in item.stages:
                done_order.extend(stage)
    cg.done_order = done_order

    # ------------------------------------------------- program cache lookup
    # a compile whose canonical shape matches an earlier one takes its
    # renderers and lazily built programs; only the state carry is rebuilt
    hit = _program_cache_get(cg.signature)
    if hit is not None:
        cg.engine = hit["engine"]  # the host int copy the renderers keep
        cg.render = hit["render"]
        cg.render_fast = hit["render_fast"]
        cg.scan_fn = hit.get("scan_fn")
        cg.full_scan_fn = hit.get("full_scan_fn")
        cg.super_fns = hit["super_fns"]
        cg.evchunk_fns = hit["evchunk_fns"]
        cg.float_fns = hit["float_fns"]
        cg.superblock_ok = hit.get("superblock_ok")
        cg.superblock_max = hit.get("superblock_max", math.inf)
        cg.cache_entry = hit
        cg.cache_hit = True
    else:
        cg.render = _build_render(cg)
        render_fast = _build_render(cg, fast=True)
        cg.render_fast = lambda state, graph_inputs: render_fast(state, None, graph_inputs)
        if cg.signature is not None:
            entry = {
                "engine": cg.engine,
                "render": cg.render,
                "render_fast": cg.render_fast,
                # the compile's own dicts: a program built lazily (get_*_fn)
                # is registered in the entry as it is built
                "super_fns": cg.super_fns,
                "evchunk_fns": cg.evchunk_fns,
                "float_fns": cg.float_fns,
                # the warm's keys whose programs have executed once
                # (processor._warm_programs)
                "warmed": set(),
            }
            _program_cache_put(cg.signature, entry)
            cg.cache_entry = entry
    t_end = time.perf_counter()
    cg.compile_ms = {"plan": 1e3 * (t_built - t_plan),
                     "build": 1e3 * ((t_plan - t0) + (t_end - t_built))}
    return cg


# ----------------------------------------------------------- superblocks
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


def superblock_eligible(cg: CompiledGraph) -> bool:
    """True when the graph can render an event-free run of m blocks as one
    block of m*B samples (the JAX package's rule, compile.py:745-804): no
    feedback edges (their one-block delay is a semantic boundary), every
    node block-length invariant or declaring a ``superblock_cap`` of at
    least 2B (set in ``init`` or on the class), and every node's state
    shapes equal at B and 2B (compared on CPU inits).

    ``cg.superblock_max`` becomes the least cap, in samples, so the card
    and the CPU take the JAX bounce's partition: a collapsed chain runs its
    kernel at any superblock length (``kernels/chain_kernel.py`` keeps rows
    that outgrow shared memory in a global workspace)."""
    if cg.superblock_ok is not None:
        return cg.superblock_ok
    B = cg.ctx.block_size
    ctx2 = AudioCtx(cg.ctx.sample_rate, 2 * B, cg.ctx.dtype)
    ok, max_len = not cg.fb_sources, math.inf
    for e in cg.entries.values() if ok else ():
        u = e.ugen
        # a cap known before init that 2B exceeds rules the graph out (the
        # banks' init refuses a block past their cap); else init first: a
        # node may set its cap there
        if u.superblock_cap is not None and u.superblock_cap < 2 * B:
            ok = False
            break
        same = _shapes(u.init(cg.ctx, "cpu")) == _shapes(u.init(ctx2, "cpu"))
        cap = u.superblock_cap
        if not same or (cap is None and not u.block_invariant) or (
                cap is not None and cap < 2 * B):
            ok = False
            break
        if cap is not None:
            max_len = min(max_len, int(cap))
    cg.superblock_ok = ok and max_len >= 2 * B
    cg.superblock_max = max_len if cg.superblock_ok else 0
    if cg.cache_entry is not None:
        cg.cache_entry["superblock_ok"] = cg.superblock_ok
        cg.cache_entry["superblock_max"] = cg.superblock_max
    return cg.superblock_ok


def _super_ok(cg: CompiledGraph, m: int) -> bool:
    """The graph renders m > 1 blocks as one superblock."""
    return m > 1 and _rest_ok(cg, m)


def _rest_ok(cg: CompiledGraph, m: int) -> bool:
    """The graph renders m blocks as one block of m*B (m = 1 included)."""
    return superblock_eligible(cg) and m * cg.ctx.block_size <= cg.superblock_max


def get_super_fn(cg: CompiledGraph, m: int, existing_only: bool = False):
    """The event-free renderer at block m*B: fn(state, inputs [in, m*B]) ->
    (state, out [ch, m*B], done_vec or None), or None when the graph is
    superblock-ineligible or m*B exceeds its cap. Built at first use;
    ``existing_only`` returns it only if it was built before."""
    if not _super_ok(cg, m):
        return None
    fn = cg.super_fns.get(m)
    if fn is None:
        if existing_only:
            return None
        raw = _build_render(cg, fast=True, block_multiple=m)
        fn = cg.super_fns[m] = lambda state, inputs: raw(state, None, inputs)
    return fn


def get_super_scan_fn(cg: CompiledGraph, k: int):
    """The capped loop (the JAX package's scan of k-superblocks,
    ``get_super_scan_fn``): fn(state, inputs [in, n*k*B]) renders the n
    k-superblocks in turn -> (state, out [ch, n*k*B], the OR of their done
    vectors or None). None where ``get_super_fn(cg, k)`` is."""
    one = get_super_fn(cg, k)
    if one is None:
        return None
    kB = k * cg.ctx.block_size

    def loop(state, inputs):
        outs, done = [], None
        for i in range(inputs.shape[-1] // kB):
            state, out, d = one(state, inputs[:, i * kB:(i + 1) * kB])
            outs.append(out)
            if d is not None:
                done = d if done is None else done | d
        return state, torch.cat(outs, dim=1), done

    return loop


def _or_done(a, b):
    """The OR of two done vectors, either of which may be None."""
    if a is None:
        return b
    return a if b is None else a | b


def get_full_super_fn(cg: CompiledGraph, m: int, existing_only: bool = False):
    """The eventful renderer at block m*B: fn(state, events, inputs [in,
    m*B]) -> (state, out [ch, m*B], done_vec or None), or None where
    ``get_super_fn`` is. Event frames are relative to the superblock start,
    node event tensors span it, and the param engine stairs block-rate ramps
    at the native blocks, so that it equals m native blocks of ``render``
    (the JAX package's ``get_full_super_fn``)."""
    if not _super_ok(cg, m):
        return None
    key = ("full", m)
    fn = cg.super_fns.get(key)
    if fn is None and not existing_only:
        fn = cg.super_fns[key] = _build_render(cg, block_multiple=m)
    return fn


def get_full_super_scan_fn(cg: CompiledGraph, k: int, existing_only: bool = False):
    """The eventful k-superblock renderer in a loop (the JAX package's scan
    of it): fn(state, events [one event dict per k-superblock, frames
    relative to its start], inputs [in, n*k*B]) -> (state, out [ch,
    n*k*B], the OR of the done vectors or None), for graphs whose cap is
    below the chunk. None where ``get_super_fn(cg, k)`` is."""
    if not _super_ok(cg, k):
        return None
    key = ("full_scan", k)
    fn = cg.super_fns.get(key)
    if fn is None and not existing_only:
        raw = _build_render(cg, block_multiple=k)
        kB = k * cg.ctx.block_size

        def fn(state, events, inputs):
            outs, done = [], None
            for i, ev in enumerate(events):
                state, out, d = raw(state, ev, inputs[:, i * kB:(i + 1) * kB])
                outs.append(out)
                done = _or_done(done, d)
            return state, torch.cat(outs, dim=1), done

        cg.super_fns[key] = fn
    return fn


def chain_in_plan(cg: CompiledGraph) -> bool:
    return any(kind == "chain" for kind, _ in cg.plan)


def get_float_fn(cg: CompiledGraph, existing_only: bool = False):
    """The float-event renderer fn(state, events, inputs) -> (state, out,
    done_vec): ``render`` with collapsed chains still on the chain kernel,
    exact for blocks whose events carry float and int sets and smoothing but
    no trigger (the kernel reads no trigger plane; the host takes it only
    for such blocks). None when the graph has no collapsed chain or the
    chain kernel is off on its device."""
    if not chain_kernel.enabled(cg.device) or not chain_in_plan(cg):
        return None
    fn = cg.float_fns.get(1)
    if fn is None and not existing_only:
        fn = cg.float_fns[1] = _build_render(cg, float_events=True)
    return fn


def _chunk_fn(first, rest):
    """fn(state, events, in_first [in, B], in_rest [in, (n-1)*B]): block 0
    through ``first``, the rest through ``rest`` -> (state, out [ch, n*B],
    done_vec or None)."""
    def chunk(state, events, in_first, in_rest):
        state, out0, done0 = first(state, events, in_first)
        state, out_rest, done1 = rest(state, None, in_rest)
        return state, torch.cat([out0, out_rest], dim=1), _or_done(done0, done1)

    return chunk


def get_float_evchunk_fn(cg: CompiledGraph, n: int, existing_only: bool = False):
    """``get_evchunk_fn``'s float-event sibling: block 0 through the
    float-event renderer, the rest as one event-free (n-1)-superblock. None
    where ``get_float_fn`` is, or where the graph takes no superblock of
    n-1 blocks."""
    if n < 2 or not chain_kernel.enabled(cg.device) or not chain_in_plan(cg):
        return None
    key = f"ev{n}"
    fn = cg.float_fns.get(key)
    if fn is None and not existing_only and _rest_ok(cg, n - 1):
        fn = cg.float_fns[key] = _chunk_fn(
            _build_render(cg, float_events=True),
            _build_render(cg, fast=True, block_multiple=n - 1))
    return fn


def _partition_exact(cg: CompiledGraph) -> bool:
    """Every node renders any split of a run into blocks bit-identically
    (``UGen.partition_exact``)."""
    return all(e.ugen.partition_exact for e in cg.entries.values())


def get_evchunk_fn(cg: CompiledGraph, n: int, existing_only: bool = False):
    """The eventful chunk with its events in block 0 (an asap control
    batch): fn(state, events, in_first [in, B], in_rest [in, (n-1)*B]) ->
    (state, out [ch, n*B], done_vec or None). Block 0 renders through
    ``render``, the rest as one event-free (n-1)-superblock. Where the graph
    takes none of that length (feedback edges, a cap) the rest renders as
    n-1 blocks of ``render_fast``, as the JAX package's scan does; a capped
    graph of ``partition_exact`` nodes (the fused kernel banks) renders it
    as superblocks of its cap instead, the same samples in a few launches
    where block by block took n-1 (a live chunk's host cost)."""
    if n < 2:
        return None
    fn = cg.evchunk_fns.get(n)
    if fn is None and not existing_only:
        B = cg.ctx.block_size
        if _rest_ok(cg, n - 1):
            rest = _build_render(cg, fast=True, block_multiple=n - 1)
        else:
            m = cg.superblock_max // B if superblock_eligible(cg) else 0
            m = m if m >= 2 and _partition_exact(cg) else 1
            sizes = [m] * ((n - 1) // m) + ([(n - 1) % m] if (n - 1) % m else [])
            parts = {s: get_super_fn(cg, s) if s > 1 else cg.render_fast for s in sizes}

            def rest(state, _events, inputs):
                outs, done, t = [], None, 0
                for s in sizes:
                    state, out, d = parts[s](state, inputs[:, t * B:(t + s) * B])
                    outs.append(out)
                    done = _or_done(done, d)
                    t += s
                return state, torch.cat(outs, dim=1), done
        fn = cg.evchunk_fns[n] = _chunk_fn(cg.render, rest)
    return fn


def get_full_scan_fn(cg: CompiledGraph):
    """``render`` over n blocks in turn (the JAX package's full-program
    scan): fn(state, events [one event dict per block], inputs [in, n*B])
    -> (state, out [ch, n*B], the OR of the done vectors or None)."""
    if cg.full_scan_fn is not None:
        return cg.full_scan_fn
    B = cg.ctx.block_size
    render = cg.render

    def scan(state, events, inputs):
        outs, done = [], None
        for i, ev in enumerate(events):
            state, out, d = render(state, ev, inputs[:, i * B:(i + 1) * B])
            outs.append(out)
            done = _or_done(done, d)
        return state, torch.cat(outs, dim=1), done

    cg.full_scan_fn = scan
    if cg.cache_entry is not None:
        cg.cache_entry["full_scan_fn"] = scan
    return scan


def get_scan_fn(cg: CompiledGraph):
    """``render_fast`` over the n blocks of inputs [in, n*B] in turn (the
    JAX package's fast scan) -> (state, out [ch, n*B], done OR or None)."""
    if cg.scan_fn is not None:
        return cg.scan_fn
    B = cg.ctx.block_size
    render_fast = cg.render_fast

    def scan(state, inputs):
        outs, done = [], None
        for i in range(inputs.shape[-1] // B):
            state, out, d = render_fast(state, inputs[:, i * B:(i + 1) * B])
            outs.append(out)
            done = _or_done(done, d)
        return state, torch.cat(outs, dim=1), done

    cg.scan_fn = scan
    if cg.cache_entry is not None:
        cg.cache_entry["scan_fn"] = scan
    return scan


# -------------------------------------------------------- program cache
_PROGRAM_CACHE: "OrderedDict[Any, dict]" = OrderedDict()
_PROGRAM_CACHE_CAP = 64
_PROGRAM_CACHE_LOCK = threading.Lock()


def _program_cache_get(sig):
    if sig is None:
        return None
    with _PROGRAM_CACHE_LOCK:
        hit = _PROGRAM_CACHE.get(sig)
        if hit is not None:
            _PROGRAM_CACHE.move_to_end(sig)
        return hit


def _program_cache_put(sig, entry):
    with _PROGRAM_CACHE_LOCK:
        _PROGRAM_CACHE[sig] = entry
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.popitem(last=False)


def clear_program_cache() -> None:
    """Empty the program and plan caches: the next compile of any graph
    builds its plan, renderers and lowered chain programs anew."""
    with _PROGRAM_CACHE_LOCK:
        _PROGRAM_CACHE.clear()
        _PLAN_CACHE.clear()


# ---------------------------------------------------------------- plan cache
# cached batching/chain plans keyed by the structural signature, stored in
# CANONICAL (topo-position) space so they replay onto any graph with the
# same structure regardless of node-id numbering (see compile_graph). A
# chain's entry also holds its lowered-program dicts, which every plan
# replayed from it shares.
_PLAN_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_PLAN_CACHE_CAP = 256


def _plan_cache_get(sig):
    if sig is None:
        return None
    with _PROGRAM_CACHE_LOCK:
        hit = _PLAN_CACHE.get(sig)
        if hit is not None:
            _PLAN_CACHE.move_to_end(sig)
        return hit


def _plan_cache_put(sig, plan_pos) -> None:
    if sig is None:
        return
    with _PROGRAM_CACHE_LOCK:
        _PLAN_CACHE[sig] = plan_pos
        while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
            _PLAN_CACHE.popitem(last=False)


def _desc_to_pos(canon, d):
    """('abs', kind, src_nid, ch) -> position form; 'rel' descs unchanged."""
    if d[0] == "abs":
        _a, kind, s, c = d
        return ("abs", kind, None if s is None else canon[s], c)
    return d


def _desc_to_nid(order, d):
    if d[0] == "abs":
        _a, kind, s, c = d
        return ("abs", kind, None if s is None else order[s], c)
    return d


def _chain_to_pos(canon, cp):
    return (
        tuple(tuple(canon[n] for n in st) for st in cp.stages),
        cp.period,
        tuple(tuple(tuple(_desc_to_pos(canon, d) for d in row)
                    for row in rows) for rows in cp.in_pattern),
        tuple(tuple((pi, _desc_to_pos(canon, d)) for pi, d in pes)
              for pes in cp.pe_pattern),
        tuple(tuple(k) for k in cp.carry_keys),
        tuple(sorted(
            (tuple(k), (kind, None if s is None else canon[s], c))
            for k, (kind, s, c) in cp.carry_init.items()
        )),
        (cp.lowered, cp.seg_lowered),  # shared, not copied
    )


def _chain_from_pos(order, t):
    stages_p, period, inp, pep, ckeys, cinit, (lowered, seg_lowered) = t
    return ChainPlan(
        stages=[[order[p] for p in st] for st in stages_p],
        period=period,
        in_pattern=[tuple(tuple(_desc_to_nid(order, d) for d in row)
                          for row in rows) for rows in inp],
        pe_pattern=[tuple((pi, _desc_to_nid(order, d)) for pi, d in pes)
                    for pes in pep],
        carry_keys=[tuple(k) for k in ckeys],
        carry_init={tuple(k): (kind, None if s is None else order[s], c)
                    for k, (kind, s, c) in cinit},
        lowered=lowered,
        seg_lowered=seg_lowered,
    )


def _plan_to_pos(cg):
    canon = cg.canon
    out = []
    for kind, item in cg.plan:
        if kind == "single":
            out.append(("single", canon[item]))
        elif kind == "batch":
            out.append(("batch", tuple(canon[n] for n in item)))
        else:
            out.append(("chain", _chain_to_pos(canon, item)))
    return tuple(out)


def _plan_from_pos(order, plan):
    out = []
    for kind, item in plan:
        if kind == "single":
            out.append(("single", order[item]))
        elif kind == "batch":
            out.append(("batch", [order[p] for p in item]))
        else:
            out.append(("chain", _chain_from_pos(order, item)))
    return out


def _structural_signature(cg: CompiledGraph, auto_batch: bool):
    """Hashable signature of everything that shapes the plan and the
    renderers, with nodes labeled canonically (topo position). None =
    uncacheable (some node's UGen config couldn't be frozen at push time).

    Beside the JAX package's key: the device (a renderer built for one card
    never serves the CPU or another card), the port's chain-collapse
    switches and the chain kernel's mode in place of the Mosaic mode, and
    each node's enclosing subgraphs by canonical label (the chain pass
    keeps units of different subgraphs apart) where the JAX key has a
    bool."""
    canon = cg.canon
    containers: Dict[int, int] = {}

    def src_key(kind, s, c):
        return (kind, -1 if s is None else canon[s], c)

    node_rows = []
    for nid in cg.order:
        e = cg.entries[nid]
        if e.sig is None:
            return None
        node_rows.append(
            (
                e.sig,
                e.done_action.value,
                tuple(containers.setdefault(c, len(containers))
                      for c in cg.enclosing[nid]),
                tuple(
                    tuple(src_key(*s) for s in per) for per in cg.resolved_in[nid]
                ),
            )
        )
    pe_rows = tuple(
        sorted(
            (canon[dst], pidx, canon[src], ch)
            for (dst, pidx), (src, ch) in cg.resolved_param_edges.items()
        )
    )
    out_rows = tuple(
        tuple(src_key(*s) for s in per) for per in cg.resolved_out
    )
    fb_rows = tuple((canon[s], c) for (s, c) in cg.fb_sources)
    return (
        str(cg.device),
        cg.ctx.sample_rate,
        cg.ctx.block_size,
        str(cg.ctx.dtype),
        cg.graph.inputs,
        cg.graph.outputs,
        cg.event_capacity,
        auto_batch,
        (_CHAIN_COLLAPSE_ON, MIN_CHAIN_STAGES, MAX_CHAIN_PERIOD, chain_kernel._MODE),
        tuple(node_rows),
        pe_rows,
        out_rows,
        fb_rows,
    )


def _node_depths(cg: CompiledGraph) -> Dict[int, int]:
    depth: Dict[int, int] = {}
    pe_deps: Dict[int, List[int]] = {}
    for (dst, _p), (src, _ch) in cg.resolved_param_edges.items():
        pe_deps.setdefault(dst, []).append(src)
    for nid in cg.order:
        deps = [
            s
            for per in cg.resolved_in[nid]
            for (k, s, _c) in per
            if k == "node"
        ]
        deps += pe_deps.get(nid, [])
        depth[nid] = 1 + max((depth[d] for d in deps), default=-1)
    return depth


def _find_chains(cg: CompiledGraph, depth: Dict[int, int]) -> List[ChainPlan]:
    """Detect maximal runs of isomorphic units along the topological order
    (the JAX package's pass, unchanged).

    Units are matched by structure: same UGen batch_key, same done action,
    and identical wiring where every source is either intra-unit (offset
    r >= 0), previous-unit (r < 0 — the carry), or the SAME external node /
    graph input / feedback buffer for every unit. A run only collapses when
    its depth grows every unit (a real serial chain; parallel repetition is
    the auto-batch pass's job) and K >= MIN_CHAIN_STAGES."""
    order = cg.order
    n = len(order)
    if not _CHAIN_COLLAPSE_ON or n < MIN_CHAIN_STAGES:
        return []

    labels: List[Any] = []
    for nid in order:
        e = cg.entries[nid]
        u = e.ugen
        bk = None if u.event_capacity > 0 else u.batch_key()
        if bk is None:
            labels.append(None)
        else:
            labels.append(
                (
                    type(u).__qualname__,
                    bk,
                    e.done_action.value,
                    tuple(cg.enclosing[nid]),
                    u.inputs,
                    u.outputs,
                    tuple((nid, pidx) in cg.resolved_param_edges
                          for pidx in range(len(u.params))),
                )
            )

    def classify(pos: int, a: int, k: int, p: int, first: bool = False):
        """Source descriptors of the node at topo position ``pos`` viewed as
        offset node of unit ``k`` in a window starting at ``a`` with period
        ``p``; None when a source points more than one unit back inside the
        window. ``first`` classifies the window's stage 0: anything before
        ``a`` is external."""
        nid = order[pos]
        lo = a if first else a + (k - 1) * p
        rows = []
        for ch_srcs in cg.resolved_in[nid]:
            descs = []
            for (kind, s, c) in ch_srcs:
                if kind == "node":
                    sp = cg.canon[s]
                    if sp >= lo:
                        descs.append(("rel", sp - (a + k * p), c))
                    elif sp < a:
                        descs.append(("abs", "node", s, c))
                    else:
                        return None
                else:
                    descs.append(("abs", kind, s, c))
            rows.append(tuple(descs))
        pes = []
        for pidx in range(len(cg.entries[nid].ugen.params)):
            key = (nid, pidx)
            if key in cg.resolved_param_edges:
                s, c = cg.resolved_param_edges[key]
                sp = cg.canon[s]
                if sp >= lo:
                    pes.append((pidx, ("rel", sp - (a + k * p), c)))
                elif sp < a:
                    pes.append((pidx, ("abs", "node", s, c)))
                else:
                    return None
        return (tuple(rows), tuple(pes))

    def unit_descs(a: int, k: int, p: int):
        descs = []
        for j in range(p):
            d = classify(a + k * p + j, a, k, p)
            if d is None:
                return None
            descs.append(d)
        return descs

    def first_unit_check(a: int, p: int, pattern):
        """Stage 0 may read arbitrary already-computed external sources
        where the pattern has previous-unit (r < 0) refs — those become the
        carry's initial values. Everything else must match the pattern
        exactly. Returns carry_init or None."""
        carry_init: Dict[Tuple[int, int], Tuple] = {}

        def match_desc(pat, act):
            if pat[0] == "rel" and pat[1] < 0:
                if act[0] == "rel":
                    return False  # stage 0 has nothing before it in-window
                key = (p + pat[1], pat[2])
                src = (act[1], act[2], act[3])
                if key in carry_init and carry_init[key] != src:
                    return False
                carry_init[key] = src
                return True
            return pat == act

        for j in range(p):
            act = classify(a + j, a, 0, p, first=True)
            if act is None:
                return None
            pat_rows, pat_pes = pattern[j]
            act_rows, act_pes = act
            if len(pat_rows) != len(act_rows):
                return None
            for pr, ar in zip(pat_rows, act_rows):
                if len(pr) != len(ar):
                    return None
                for pd, ad in zip(pr, ar):
                    if not match_desc(pd, ad):
                        return None
            if len(pat_pes) != len(act_pes):
                return None
            for (ppi, pd), (api, ad) in zip(pat_pes, act_pes):
                if ppi != api or not match_desc(pd, ad):
                    return None
        return carry_init

    chains: List[ChainPlan] = []
    used = set()

    for p in range(1, MAX_CHAIN_PERIOD + 1):
        if n < MIN_CHAIN_STAGES * p:
            continue
        i = 0
        while i + p < n:
            if (
                labels[i] is None
                or i in used
                or labels[i] != labels[i + p]
            ):
                i += 1
                continue
            # maximal label-periodic run starting at i
            e = i
            while (
                e + p < n
                and labels[e] is not None
                and labels[e] == labels[e + p]
                and (e + p) not in used
            ):
                e += 1
            K = (e - i) // p + 1
            a = i
            accepted = None
            flat_depth = False
            while K >= MIN_CHAIN_STAGES:
                # pattern from unit 1; verify units 1..K-1 match it
                pattern = unit_descs(a, 1, p)
                if pattern is None:
                    break
                k = 2
                while k < K:
                    d = unit_descs(a, k, p)
                    if d != pattern:
                        break
                    k += 1
                K = k
                if K < MIN_CHAIN_STAGES:
                    break
                # a real serial chain gets DEEPER every stage; parallel
                # repetition that merely alternates in topo order has flat
                # per-unit depth — leave it to auto-batching
                unit_depth = [
                    max(depth[order[a + k2 * p + j]] for j in range(p))
                    for k2 in range(K)
                ]
                if any(
                    unit_depth[k2 + 1] <= unit_depth[k2]
                    for k2 in range(K - 1)
                ):
                    flat_depth = True
                    break
                carry_init = first_unit_check(a, p, pattern)
                if carry_init is None:
                    # drop the first unit (e.g. a differently-wired chain
                    # head) and retry with the next as stage 0
                    a += p
                    K -= 1
                    continue
                accepted = (a, K, pattern, carry_init)
                break
            if accepted is None:
                # flat depth is alignment-invariant: skip the whole run
                i = e if flat_depth else i + 1
                continue
            a, K, pattern, carry_init = accepted
            stages = [
                [order[a + k * p + j] for j in range(p)] for k in range(K)
            ]
            member_pos = set(range(a, a + K * p))
            # plan-order validation (see _plan_batches): every external
            # node source must sort strictly before the chain entry and
            # every external reader strictly after it
            chain_sort = (depth[order[a]], a)
            ext_srcs = [
                d[2]
                for rows, pes in pattern
                for seq in (list(rows) + [tuple(pd for _i, pd in pes)])
                for d in seq
                if d[0] == "abs" and d[1] == "node"
            ] + [
                s for (kind_i, s, _c) in carry_init.values()
                if kind_i == "node"
            ]
            ok = all(
                (depth[s], cg.canon[s]) < chain_sort for s in ext_srcs
            )
            for pos in range(n):
                if pos in member_pos or not ok:
                    continue
                nid = order[pos]
                reads = [
                    s
                    for per in cg.resolved_in[nid]
                    for (kk, s, _c) in per
                    if kk == "node" and cg.canon[s] in member_pos
                ]
                reads += [
                    src
                    for (dst, _pi), (src, _ch) in
                    cg.resolved_param_edges.items()
                    if dst == nid and cg.canon[src] in member_pos
                ]
                if reads and (depth[nid], cg.canon[nid]) <= chain_sort:
                    ok = False
            if not ok:
                i += 1
                continue
            chains.append(
                ChainPlan(
                    stages=stages,
                    period=p,
                    in_pattern=[rows for rows, _pes in pattern],
                    pe_pattern=[pes for _rows, pes in pattern],
                    carry_keys=sorted(carry_init),
                    carry_init=carry_init,
                )
            )
            used |= member_pos
            i = a + K * p
    return chains


def _plan_batches(cg: CompiledGraph):
    """The auto-batching + chain-collapse pass (the JAX package's, unchanged).

    Auto-batching groups same-kind nodes at equal dataflow depth into one
    call — 256 parallel SinWt nodes become a single [256]-wide call. Chain
    collapse (see _find_chains) turns K-deep runs of isomorphic units into
    one stage loop. Depth-layered execution is a valid topological order
    because same-block dependencies always have strictly smaller depth;
    chains are ordered by their first member."""
    depth = _node_depths(cg)
    chains = _find_chains(cg, depth)
    in_chain = {
        nid for cp in chains for stage in cp.stages for nid in stage
    }

    # order members and groups by (depth, canonical position)
    groups: Dict[Any, List[int]] = {}
    for nid in sorted(cg.order, key=lambda n: (depth[n], cg.canon[n])):
        if nid in in_chain:
            continue
        ugen = cg.entries[nid].ugen
        key = None if ugen.event_capacity > 0 else ugen.batch_key()
        gk = (depth[nid], key) if key is not None else ("single", nid)
        groups.setdefault(gk, []).append(nid)

    entries: List[Tuple[Tuple[int, int], Tuple[str, Any]]] = []
    for gk, nids in groups.items():
        sort_key = (depth[nids[0]], cg.canon[nids[0]])
        if len(nids) == 1:
            entries.append((sort_key, ("single", nids[0])))
        else:
            entries.append((sort_key, ("batch", nids)))
    for cp in chains:
        first = cp.stages[0][0]
        entries.append(((depth[first], cg.canon[first]), ("chain", cp)))
    return [e for _k, e in sorted(entries, key=lambda x: x[0])]


def _instance_default(ugen, pidx: int):
    spec = ugen.params[pidx]
    inst = getattr(ugen, "pdefaults", None)
    if inst and spec.name in inst:
        v = inst[spec.name]
        if hasattr(v, "value"):
            v = v.value
        return v
    return spec.default_value()


def _build_render(cg: CompiledGraph, fast: bool = False, block_multiple: int = 1,
                  float_events: bool = False):
    """The block renderer ``render(state, events, graph_inputs) -> (state,
    out [outputs, B], done_vec)``. ``fast=True`` is the event-free variant:
    params come straight from the ramp state and triggers are all false.
    ``float_events=True`` is the eventful renderer whose collapsed chains
    stay on the chain kernel, on the materialized per-sample param planes:
    exact for events without triggers, the only blocks the host gives it.
    Collapsed chains take the chain kernel where it is on (a card) in those
    two; in the eventful renderer they take the scan executor, as in the
    JAX package, but for a block with triggers (or retriggering int sets):
    then only the stages those touch run on the scan executor, the runs of
    stages between them (the whole chain where they touch none) on the
    kernel (``_chain_stages``), bit-equal to the scan executor over the
    whole chain. The port's eager scan executor costs ~45 launches a stage
    (``tools/time_live_chunks.py``), too many for a live trigger in a long
    chain. ``done_vec`` is None unless the graph has done actions or a node
    that frees the top-level graph.

    ``block_multiple`` m > 1 builds the superblock renderer: the whole
    graph over one block of m*B samples, the param engine stairing
    block-rate ramps at the native blocks, so that it equals m native
    blocks wherever the nodes are block-length invariant (every phase, scan
    and closed form is length-parametric; float sums may reassociate).
    Without ``fast`` it is the eventful superblock: event frames are
    relative to its start.

    Everything that depends only on the graph (slot index tensors on the
    device, source lists) is worked out here, once; each call does the
    per-block tensor work."""
    m = int(block_multiple)
    B = cg.ctx.block_size * m
    ctx = (AudioCtx(cg.ctx.sample_rate, B, cg.ctx.dtype, no_events=fast)
           if fast or m > 1 else cg.ctx)
    engine = (PEngine(cg.layout, B, dtype=ctx.dtype, native_block=cg.ctx.block_size)
              if m > 1 else cg.engine)
    dtype = ctx.dtype
    device = cg.device

    # nodes whose done frees the TOP-LEVEL graph: the reference zeroes the
    # graph output from the done frame within the same block
    # (graph_gen.rs:227-238 remove_graph)
    top_free_parent = {
        nid
        for nid in cg.order
        if cg.entries[nid].done_action == Done.FREE_PARENT
        and not cg.enclosing[nid]
    }
    track_done = cg.has_done_actions or bool(top_free_parent)

    def _idx(slots):
        """A slice when the slot list is contiguous, an index tensor otherwise."""
        s0 = slots[0] if slots else 0
        if list(slots) == list(range(s0, s0 + len(slots))):
            return slice(s0, s0 + len(slots))
        return torch.tensor(slots, dtype=torch.long, device=device)

    zeros_row = torch.zeros((B,), dtype=dtype, device=device)
    no_inputs = torch.zeros((0, B), dtype=dtype, device=device)
    false_row = torch.zeros((B,), dtype=torch.bool, device=device)

    def param_rows(pe, pf, pt, pi, pset, typ, idx, n):
        """[n, B] rows of one param type for the slots ``idx``."""
        if typ == "float":
            return pf[idx]
        if typ == "trigger":
            return false_row.expand(n, B) if fast else pt[idx]
        if typ == "int":
            return pe["int_value"][idx][:, None].expand(n, B) if fast else pi[idx]
        return false_row.expand(n, B) if fast else pset[idx]  # "set" masks

    def host_slots(rep, spec, typ, slots):
        """The slots of an int param whose UGen reads its values on the host
        (``UGen.host_int_params``), else None."""
        if typ == "int" and spec.name in getattr(rep, "host_int_params", ()):
            return slots
        return None

    def param_specs(nids, rep):
        """Per param of ``rep``: (name, type, slot idx, retrigger, host
        slots) when every member reads the engine, or (name, None, [member
        sources], False, None) when some member's param is driven by an
        audio-rate edge."""
        specs = []
        for pidx, spec in enumerate(rep.params):
            edges = [cg.resolved_param_edges.get((n, pidx)) for n in nids]
            if any(e is not None for e in edges):
                srcs = []
                for n, e in zip(nids, edges):
                    typ, slot = cg.layout.lookup(n, pidx)
                    srcs.append(("edge", e) if e is not None else (typ, slot))
                specs.append((spec.name, None, srcs, False, None))
                continue
            typ = cg.layout.lookup(nids[0], pidx)[0]
            slots = [cg.layout.lookup(n, pidx)[1] for n in nids]
            specs.append((spec.name, typ, _idx(slots),
                          typ == "int" and getattr(spec, "retrigger", False),
                          host_slots(rep, spec, typ, slots)))
        return specs

    # ----------------------------------------------- per plan entry, once
    steps = []
    for kind, item in cg.plan:
        if kind == "single":
            steps.append(("single", item, cg.entries[item].ugen,
                          param_specs([item], cg.entries[item].ugen)))
        elif kind == "batch":
            rep = cg.entries[item[0]].ugen
            steps.append(("batch", item, rep, param_specs(item, rep)))
        else:
            cp = item
            K, p = len(cp.stages), cp.period
            reps = [cg.entries[cp.stages[0][j]].ugen for j in range(p)]
            # float planes of every (offset, param) without an edge, in one
            # read: the layout gives a chain contiguous float slots. The
            # kernel also reads integer params, as planes after the float
            # ones (whole numbers in f32: kernels/chain_kernel.py)
            float_slots, plane_index, others, int_idx = [], {}, [], []
            for j, rep in enumerate(reps):
                pe_pat = dict(cp.pe_pattern[j])
                for pidx, spec in enumerate(rep.params):
                    if pidx in pe_pat:
                        continue  # audio-rate edge, resolved per stage
                    typ = cg.layout.lookup(cp.stages[0][j], pidx)[0]
                    slots = [cg.layout.lookup(stage[j], pidx)[1] for stage in cp.stages]
                    if typ == "float":
                        plane_index[(j, spec.name)] = len(float_slots) // K
                        float_slots += slots
                    else:
                        others.append((j, spec.name, typ, _idx(slots),
                                       getattr(spec, "retrigger", False),
                                       host_slots(rep, spec, typ, slots)))
                        if typ == "int":
                            int_idx.append(((j, spec.name), _idx(slots)))
            kernel_index = dict(plane_index)
            for i, (key, _idx_) in enumerate(int_idx):
                kernel_index[key] = len(plane_index) + i
            # the stage each trigger slot (and retriggering int slot) drives:
            # an eventful block runs the stages they touch on the scan
            # executor; runs of stages between them launch the kernel on a
            # plan (``seg``) whose outputs include the carry
            touch = {}
            for j, rep in enumerate(reps):
                for pidx, spec in enumerate(rep.params):
                    for k, stage in enumerate(cp.stages):
                        typ, slot = cg.layout.lookup(stage[j], pidx)
                        if typ == "trigger":
                            touch[("t", slot)] = k
                        elif typ == "int" and getattr(spec, "retrigger", False):
                            touch[("i", slot)] = k
            needed = chain_kernel.needed_outputs(cg, cp)
            seg = (replace(cp, lowered=cp.seg_lowered), needed | set(cp.carry_keys))
            steps.append(("chain", cp, reps,
                          (_idx(float_slots) if float_slots else None,
                           plane_index, others, needed,
                           chain_kernel.ext_descs(cp),
                           [idx for _key, idx in int_idx], kernel_index, touch, seg)))

    # a UGen that branches on an int param per block (PolyBlep's waveform)
    # reads its values from the engine's host copy: no block waits on a
    # device read
    host_specs = [spec[4] for step in steps if step[0] != "chain" for spec in step[3]]
    host_specs += [o[5] for step in steps if step[0] == "chain" for o in step[3][2]]
    wants_host = any(h is not None for h in host_specs)

    def render(state, events, graph_inputs):
        pe = state["pe"]
        pf = pt = pi = pset = None
        # a block with triggers: each chain's stages its triggers leave
        # alone take the kernel (``_chain_stages``)
        trigger_block = not (fast or float_events) and bool((events["t_slot"] >= 0).any())
        # the compile's own engine keeps the host copy for every renderer
        ints_host = cg.engine.ints_at_block_start(pe, events) if wants_host else None
        if fast:
            # every float param of the graph in one read of the ramp state:
            # on the eager device path a few wide ops beat many narrow ones
            pf = engine.materialize_rows_fast(pe, slice(None))
            pe_state = engine.advance_fast(pe)
        else:
            pf, pt, pi, pset, pe_state = engine.materialize(pe, events)

        def rows_of(typ, idx, n):
            return param_rows(pe, pf, pt, pi, pset, typ, idx, n)

        outs: Dict[int, torch.Tensor] = {}
        # batched groups: nid -> (group_key, index); group outputs [N, ch, B]
        node_loc: Dict[int, Tuple[str, int]] = {}
        group_out: Dict[str, torch.Tensor] = {}
        # chain members: nid -> (chain_key, stage_k, offset_j); chain
        # outputs [chain_key][offset_j] = [K, ch, B]
        chain_loc: Dict[int, Tuple[str, int, int]] = {}
        chain_out: Dict[str, Dict[int, torch.Tensor]] = {}
        new_nodes: Dict[str, Any] = {}

        def read_source(kind, s, c):
            if kind == "node":
                if s in node_loc:
                    gk, k = node_loc[s]
                    return group_out[gk][k, c]
                if s in chain_loc:
                    ck, k, j = chain_loc[s]
                    return chain_out[ck][j][k, c]
                return outs[s][c]
            if kind == "feedback":
                return state["fb"][cg.fb_key(s, c)]
            if kind == "graph_in":
                return graph_inputs[c]
            raise AssertionError(kind)

        def sum_sources(srcs):
            if not srcs:
                return zeros_row
            if len(srcs) <= 2:
                acc = read_source(*srcs[0])
                for sp in srcs[1:]:
                    acc = acc + read_source(*sp)
                return acc
            # many additive sources (mix busses): one stacked reduction
            return torch.sum(gather_rows(srcs), dim=0)

        def gather_rows(srcs):
            """[len(srcs), B] rows; a slice when every source is one output
            channel of consecutive members of one batched group."""
            if all(k == "node" and s in node_loc for (k, s, _c) in srcs):
                gks = {node_loc[s][0] for (_k, s, _c) in srcs}
                cs = {c for (_k, _s, c) in srcs}
                if len(gks) == 1 and len(cs) == 1:
                    gk = gks.pop()
                    ks = [node_loc[s][1] for (_k, s, _c) in srcs]
                    if ks == list(range(ks[0], ks[0] + len(ks))):
                        return group_out[gk][ks[0]:ks[0] + len(ks), cs.pop()]
            return torch.stack([read_source(*sp) for sp in srcs])

        def node_inputs(nid):
            per = cg.resolved_in[nid]
            if not per:
                return no_inputs
            return torch.stack([sum_sources(srcs) for srcs in per])

        def params_of(specs, nids):
            """{name: [B] or [N, B]} for one node or a batch."""
            out = {}
            for name, typ, idx, retrig, host in specs:
                if typ is None:  # some member's param follows an edge
                    rows = []
                    for src in idx:
                        if src[0] == "edge":
                            rows.append(read_source("node", *src[1]))
                        else:
                            s = src[1]
                            rows.append(rows_of(src[0], slice(s, s + 1), 1)[0])
                    out[name] = torch.stack(rows)
                else:
                    out[name] = rows_of(typ, idx, len(nids))
                    if retrig:
                        out[name + "_set"] = rows_of("set", idx, len(nids))
                    if host is not None:
                        out[name + "_host"] = ints_host[host]
            if len(nids) == 1:
                out = {k: v[0] for k, v in out.items()}
            return out

        done_parts: List[torch.Tensor] = []
        free_frames: List[torch.Tensor] = []  # graph-freeing done frames

        def first_done_frame(done_row):
            return torch.where(done_row.any(), done_row.to(torch.int8).argmax(),
                               torch.tensor(B, device=done_row.device))

        for step in steps:
            kind = step[0]
            if kind == "single":
                _, nid, ugen, specs = step
                args = (ctx, state["nodes"][cg.state_key(nid)], node_inputs(nid),
                        params_of(specs, [nid]))
                if ugen.event_capacity > 0:
                    # a node with its own event channel (a voice bank): none
                    # in the event-free renderers, so it skips its scatters
                    result = ugen.process(
                        *args, events=None if fast else events[cg.event_key(nid)])
                else:
                    result = ugen.process(*args)
                st, out, done = normalize_process_result(result, ctx)
                outs[nid] = out
                new_nodes[cg.state_key(nid)] = st
                if track_done:
                    done_parts.append(done.any()[None])
                    if nid in top_free_parent:
                        free_frames.append(first_done_frame(done))
            elif kind == "batch":
                _, nids, rep, specs = step
                gkey = cg.group_key(nids)
                if rep.inputs == 0:
                    inp = no_inputs.expand(len(nids), 0, B)
                else:
                    inp = torch.stack([
                        gather_rows([srcs[0] for srcs in per])
                        if all(len(srcs) == 1 for srcs in per)
                        else torch.stack([sum_sources(srcs) for srcs in per])
                        for per in ([cg.resolved_in[n][ch] for n in nids]
                                    for ch in range(rep.inputs))], dim=1)
                st, out, done = normalize_process_result(
                    rep.process(ctx, state["nodes"][gkey], inp,
                                params_of(specs, nids)), ctx)
                new_nodes[gkey] = st
                group_out[gkey] = out
                for k, n in enumerate(nids):
                    node_loc[n] = (gkey, k)
                    if n in top_free_parent:
                        free_frames.append(first_done_frame(done[k]))
                if track_done:
                    done_parts.append(done.any(dim=1))
            else:
                (_, cp, reps, (fidx, plane_index, others, needed, exts, int_idx,
                               kernel_index, touch, seg)) = step
                K, p = len(cp.stages), cp.period
                ckey = cg.chain_key(cp)
                n_planes = len(plane_index)
                planes = (rows_of("float", fidx, K * n_planes).reshape(n_planes, K, B)
                          if n_planes else None)
                carry0 = {
                    f"{dj}_{c}": read_source(*cp.carry_init[(dj, c)])
                    for (dj, c) in cp.carry_keys
                }

                def scan_params(planes=planes, plane_index=plane_index, others=others,
                                p=p, K=K):
                    """The scan executor's params: per offset {name: [K, B]}."""
                    par = [dict() for _ in range(p)]
                    for (j, name), pi_ in plane_index.items():
                        par[j][name] = planes[pi_]
                    for (j, name, typ, idx, retrig, host) in others:
                        par[j][name] = rows_of(typ, idx, K)
                        if typ == "int" and retrig:
                            par[j][name + "_set"] = rows_of("set", idx, K)
                        if host is not None:
                            par[j][name + "_host"] = ints_host[host]
                    return par

                res = None
                touched = () if fast or float_events else _touched_stages(touch, events)
                if (fast or float_events or trigger_block or touched) and \
                        chain_kernel.enabled(device):
                    ext = {d: read_source(d[1], d[2], d[3]) for d in exts}
                    kplanes = planes
                    if int_idx:
                        ints = torch.stack([rows_of("int", idx, K) for idx in int_idx])
                        ints = ints.to(dtype)
                        kplanes = ints if planes is None else torch.cat([planes, ints])
                    if kplanes is not None:
                        kplanes = kplanes.contiguous()  # a view of the materialized rows
                    if touched:
                        res = _chain_stages(cp, seg, reps, ctx, state["nodes"][ckey],
                                            kplanes, kernel_index, carry0, ext, touched,
                                            scan_params, read_source, track_done, device)
                    else:
                        res = chain_kernel.run(
                            cp, reps, ctx, state["nodes"][ckey], kplanes, kernel_index,
                            carry0, ext, needed=needed)
                        if res is not None:
                            res = res[:2] + (_done_stack(res[2], K, p, B, device)
                                             if track_done else None,)
                if res is None:
                    res = _scan_chain(cp, reps, ctx, state["nodes"][ckey], scan_params(),
                                      carry0, read_source, track_done, device)
                st_stack, outs_stack, chain_dones = res
                new_nodes[ckey] = st_stack
                chain_out[ckey] = outs_stack
                for k, stage in enumerate(cp.stages):
                    for j, n in enumerate(stage):
                        chain_loc[n] = (ckey, k, j)
                        if n in top_free_parent:
                            free_frames.append(
                                first_done_frame(chain_dones[k, j])
                                if chain_dones is not None
                                else torch.tensor(B, device=device))
                if track_done:
                    done_parts.append(
                        chain_dones.any(dim=2).reshape(-1) if chain_dones is not None
                        else torch.zeros((K * p,), dtype=torch.bool, device=device))

        new_fb = {
            cg.fb_key(s, c): read_source("node", s, c) for (s, c) in cg.fb_sources
        }
        out_rows = [sum_sources(cg.resolved_out[ch]) for ch in range(cg.graph.outputs)]
        out_block = (torch.stack(out_rows) if out_rows
                     else torch.zeros((0, B), dtype=dtype, device=device))
        if free_frames:
            # zero the graph output from the earliest graph-freeing done
            # frame (graph_gen.rs:227-238); frame == B when nothing flagged
            fmin = torch.stack(free_frames).min()
            keep = torch.arange(B, device=device)[None, :] < fmin
            out_block = torch.where(keep, out_block, torch.zeros((), dtype=dtype,
                                                                  device=device))
        done_vec = None
        if track_done:
            done_vec = (torch.cat(done_parts) if done_parts
                        else torch.zeros((0,), dtype=torch.bool, device=device))
        new_state = {"nodes": new_nodes, "pe": pe_state, "fb": new_fb}
        return new_state, out_block, done_vec

    return render


def _touched_stages(touch, events):
    """The chain stages a block's trigger and int-set events drive."""
    out = {touch.get(("t", int(s))) for s in events["t_slot"] if s >= 0}
    out |= {touch.get(("i", int(s))) for s in events["i_slot"] if s >= 0}
    out.discard(None)
    return out


def _done_stack(dones, n, p, B, device):
    """The kernel's per-offset done rows ({j: [n, B] or None}) in the scan
    executor's [n, p, B] layout."""
    no = torch.zeros((n, B), dtype=torch.bool, device=device)
    return torch.stack([no if dones[j] is None else dones[j] for j in range(p)], dim=1)


def _chain_stages(cp, seg, reps, ctx, st_stack, kplanes, kernel_index, carry0, ext,
                  touched, scan_params, read_source, track_done, device):
    """A chain's block as runs of stages: each run of untouched stages one
    chain-kernel launch, each run of ``touched`` ones the scan executor, the
    carry of one run's last stage into the next. Returns what
    ``_scan_chain`` returns, or None where the kernel takes no part of the
    plan (the caller runs the scan executor)."""
    K, p, B = len(cp.stages), cp.period, ctx.block_size
    seg_cp, seg_needed = seg
    runs = []
    for k in range(K):
        on_kernel = k not in touched
        if runs and runs[-1][2] == on_kernel:
            runs[-1][1] = k + 1
        else:
            runs.append([k, k + 1, on_kernel])
    par = scan_params()
    carry, states, outs, dones = carry0, [], [], []
    for a, b, on_kernel in runs:
        sub = replace(seg_cp, stages=cp.stages[a:b])  # shares the lowered cache
        sub_st = {key: _tree_map(lambda x: x[a:b], v) for key, v in st_stack.items()}
        if on_kernel:
            r = chain_kernel.run(sub, reps, ctx, sub_st,
                                 None if kplanes is None else kplanes[:, a:b].contiguous(),
                                 kernel_index, carry, ext, needed=seg_needed)
            if r is None:
                return None
            r = r[:2] + (_done_stack(r[2], b - a, p, B, device) if track_done else None,)
        else:
            sub_par = [{name: rows[a:b] for name, rows in pj.items()} for pj in par]
            r = _scan_chain(sub, reps, ctx, sub_st, sub_par, carry, read_source,
                            track_done, device)
        states.append(r[0])
        outs.append(r[1])
        dones.append(r[2])
        carry = {f"{dj}_{c}": r[1][dj][-1, c] for (dj, c) in cp.carry_keys}
    new_states = {key: _tree_map(lambda *xs: torch.cat(xs), *(s[key] for s in states))
                  for key in st_stack}
    outs_stack = {j: None if any(o[j] is None for o in outs) else torch.cat([o[j] for o in outs])
                  for j in range(p)}
    return new_states, outs_stack, (torch.cat(dones) if track_done else None)


def _scan_chain(cp, reps, ctx, st_stack, par, carry0, read_source, track_done,
                device):
    """The scan executor: the chain's stages in order, each unit node's
    ``process`` on its stage's params and state rows. Returns (new stacked
    state, {j: [K, out_ch, B]}, done [K, p, B] or None)."""
    K, p, B = len(cp.stages), cp.period, ctx.block_size
    dtype = ctx.dtype
    carry = carry0
    states = [[] for _ in range(p)]
    outs = [[] for _ in range(p)]
    dones = []
    for k in range(K):
        outs_local: Dict[int, torch.Tensor] = {}

        def resolve(d):
            if d[0] == "rel":
                _t, r, c = d
                if r >= 0:
                    return outs_local[r][c]
                return carry[f"{p + r}_{c}"]
            _t, kind2, s, c = d
            return read_source(kind2, s, c)

        stage_dones = []
        for j, rep in enumerate(reps):
            rows = []
            for ch_descs in cp.in_pattern[j]:
                if not ch_descs:
                    rows.append(torch.zeros((B,), dtype=dtype, device=device))
                    continue
                acc = resolve(ch_descs[0])
                for d in ch_descs[1:]:
                    acc = acc + resolve(d)
                rows.append(acc)
            inp = (torch.stack(rows) if rows
                   else torch.zeros((0, B), dtype=dtype, device=device))
            pr = {name: plane[k] for name, plane in par[j].items()}
            for pidx, d in cp.pe_pattern[j]:
                pr[rep.params[pidx].name] = resolve(d)
            st_j = _tree_map(lambda x: x[k], st_stack[f"j{j}"])
            st_j, out, done = normalize_process_result(
                rep.process(ctx, st_j, inp, pr), ctx)
            outs_local[j] = out
            states[j].append(st_j)
            outs[j].append(out)
            stage_dones.append(done)
        if track_done:
            dones.append(torch.stack(stage_dones))
        carry = {f"{dj}_{c}": outs_local[dj][c] for (dj, c) in cp.carry_keys}
    new_states = {f"j{j}": _tree_stack(states[j]) for j in range(p)}
    outs_stack = {j: torch.stack(outs[j]) for j in range(p)}
    return new_states, outs_stack, (torch.stack(dones) if track_done else None)
