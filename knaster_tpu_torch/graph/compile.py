"""Port of knaster_tpu/graph/compile.py: graph -> a block renderer.

``compile_graph`` resolves the graph's edges (subgraphs inlined), orders the
nodes, plans their execution and builds two renderers over one state dict
``{"nodes", "pe", "fb"}``: ``render(state, events, inputs)`` for blocks
with events and ``render_fast(state, inputs)`` for event-free blocks. Where
the JAX package traces them into XLA programs, the port runs them eagerly
block by block; the programs' caches, superblocks, the eventful-chunk and
float-event programs are not ported.

The plan (``_plan_batches``) follows the JAX package exactly, so state keys
(``state_key``, ``group_key``, ``chain_key``) name the same nodes in both:

* ``single``: one node's ``process``;
* ``batch``: same-kind nodes at one dataflow depth, as ONE call with a
  leading batch axis (the JAX package's ``vmap``);
* ``chain``: a collapsed run of K isomorphic units (``_find_chains``). On
  the fast renderer it runs the chain kernel (``chain_kernel.run``: one
  CUDA kernel for the whole stage loop) when the device is a card, and
  falls back to the scan executor (a loop over the stages) where the
  kernel does not apply; the eventful renderer always takes the scan.

* Additive connects: summed by the renderer.
* Feedback edges: read previous-block outputs carried in ``state["fb"]``.
* Node state survives recompiles: ``init_state(prev, prev_compiled)``
  re-keys the state by stable node ids (UGenEnum::TakeFromTask parity,
  node.rs:132-150).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.ugen import AudioCtx, normalize_process_result
from . import chain_kernel
from .graph import Done, Graph, GraphError, NodeEntry
from .handles import K_GRAPH_IN
from .param_engine import ParamLayout, PEngine
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
    ``lowered``          — the chain kernel's program for this plan, built
                          at first use (``chain_kernel.run``).
    """

    stages: List[List[int]]
    period: int
    in_pattern: List[Tuple]
    pe_pattern: List[Tuple]
    carry_keys: List[Tuple[int, int]]
    carry_init: Dict[Tuple[int, int], Tuple[str, Optional[int], int]]
    lowered: Any = None


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

    # ----------------------------------------------------- canonical keys
    def state_key(self, nid: int) -> str:
        return str(self.canon[nid])

    def group_key(self, nids: List[int]) -> str:
        return f"b{self.canon[nids[0]]}"

    def fb_key(self, nid: int, ch: int) -> str:
        return f"{self.canon[nid]}:{ch}"

    def chain_key(self, cp: "ChainPlan") -> str:
        return f"c{self.canon[cp.stages[0][0]]}"

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


def compile_graph(
    graph: Graph, event_capacity: int = 64, auto_batch: bool = True,
    device="cpu",
) -> CompiledGraph:
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
        device=torch.device(device),
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
    cg.plan = (_plan_batches(cg) if auto_batch
               else [("single", nid) for nid in order])

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

    cg.render = _build_render(cg)
    render_fast = _build_render(cg, fast=True)
    cg.render_fast = lambda state, graph_inputs: render_fast(state, None, graph_inputs)
    return cg


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


def _build_render(cg: CompiledGraph, fast: bool = False):
    """The block renderer ``render(state, events, graph_inputs) -> (state,
    out [outputs, B], done_vec)``. ``fast=True`` is the event-free variant:
    params come straight from the ramp state, triggers are all false, and
    collapsed chains try the chain kernel. ``done_vec`` is None unless the
    graph has done actions or a node that frees the top-level graph.

    Everything that depends only on the graph (slot index tensors on the
    device, source lists) is worked out here, once; each call does the
    per-block tensor work."""
    ctx = (AudioCtx(cg.ctx.sample_rate, cg.ctx.block_size, cg.ctx.dtype,
                    no_events=True) if fast else cg.ctx)
    engine = cg.engine
    B = ctx.block_size
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

    def param_specs(nids, rep):
        """Per param of ``rep``: (name, type, slot idx, retrigger) when every
        member reads the engine, or (name, None, [member sources]) when some
        member's param is driven by an audio-rate edge."""
        specs = []
        for pidx, spec in enumerate(rep.params):
            edges = [cg.resolved_param_edges.get((n, pidx)) for n in nids]
            if any(e is not None for e in edges):
                srcs = []
                for n, e in zip(nids, edges):
                    typ, slot = cg.layout.lookup(n, pidx)
                    srcs.append(("edge", e) if e is not None else (typ, slot))
                specs.append((spec.name, None, srcs, False))
                continue
            typ = cg.layout.lookup(nids[0], pidx)[0]
            slots = [cg.layout.lookup(n, pidx)[1] for n in nids]
            specs.append((spec.name, typ, _idx(slots),
                          typ == "int" and getattr(spec, "retrigger", False)))
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
            # read: the layout gives a chain contiguous float slots
            float_slots, plane_index, others = [], {}, []
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
                                       getattr(spec, "retrigger", False)))
            steps.append(("chain", cp, reps,
                          (_idx(float_slots) if float_slots else None,
                           plane_index, others,
                           chain_kernel.needed_outputs(cg, cp),
                           chain_kernel.ext_descs(cp))))

    def render(state, events, graph_inputs):
        pe = state["pe"]
        pf = pt = pi = pset = None
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
            for name, typ, idx, retrig in specs:
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
                st, out, done = normalize_process_result(
                    ugen.process(ctx, state["nodes"][cg.state_key(nid)],
                                 node_inputs(nid), params_of(specs, [nid])), ctx)
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
                _, cp, reps, (fidx, plane_index, others, needed, exts) = step
                K, p = len(cp.stages), cp.period
                ckey = cg.chain_key(cp)
                n_planes = len(plane_index)
                planes = (rows_of("float", fidx, K * n_planes).reshape(n_planes, K, B)
                          if n_planes else None)
                carry0 = {
                    f"{dj}_{c}": read_source(*cp.carry_init[(dj, c)])
                    for (dj, c) in cp.carry_keys
                }
                res = None
                if fast and chain_kernel.enabled(device):
                    ext = {d: read_source(d[1], d[2], d[3]) for d in exts}
                    res = chain_kernel.run(
                        cp, reps, ctx, state["nodes"][ckey], planes, plane_index,
                        carry0, ext, needed=needed)
                if res is None:
                    par = [dict() for _ in range(p)]
                    for (j, name), pi_ in plane_index.items():
                        par[j][name] = planes[pi_]
                    for (j, name, typ, idx, retrig) in others:
                        par[j][name] = rows_of(typ, idx, K)
                        if typ == "int" and retrig:
                            par[j][name + "_set"] = rows_of("set", idx, K)
                    res = _scan_chain(cp, reps, ctx, state["nodes"][ckey], par,
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
