"""Port of knaster_tpu/graph/inspection.py: graph inspection and Graphviz export.

Parity with knaster_graph/src/inspection.rs (GraphInspection:18, dot
exporter:70-218): snapshot the graph structure for debugging and UIs, and
export Graphviz dot. Host only. ``show_dot_svg`` renders through the
``dot`` binary and raises by name where there is none.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .graph import Graph


def _resolved_hint(p, sample_rate: int):
    import dataclasses

    from ..primitives.params import FloatHint, Nyquist

    h = p.hint
    if isinstance(h, FloatHint) and isinstance(h.maximum, Nyquist):
        h = dataclasses.replace(h, maximum=h.resolve_max(sample_rate))
    return h


@dataclass
class NodeInspection:
    nid: int
    name: str
    type_name: str
    inputs: int
    outputs: int
    params: List[Tuple[str, str, object]]  # (name, type, hint-or-None)
    done_action: str
    mortal: bool
    auto: bool
    subgraph: Optional["GraphInspection"] = None


@dataclass
class EdgeInspection:
    kind: str  # 'node' | 'feedback' | 'graph_in' | 'graph_out' | 'param'
    src: Optional[int]
    src_ch: int
    dst: Optional[int]  # None = graph output
    dst_ch: int


@dataclass
class GraphInspection:
    name: str
    inputs: int
    outputs: int
    sample_rate: int
    block_size: int
    frame_clock: int
    nodes: List[NodeInspection] = field(default_factory=list)
    edges: List[EdgeInspection] = field(default_factory=list)


def inspect(graph: Graph) -> GraphInspection:
    """Snapshot the graph (GraphInspection parity)."""
    gi = GraphInspection(
        name=graph.name,
        inputs=graph.inputs,
        outputs=graph.outputs,
        sample_rate=graph.sample_rate,
        block_size=graph.block_size,
        frame_clock=graph.root().clock.frames,
    )
    for nid, e in graph.nodes.items():
        params = []
        if e.ugen is not None:
            # hints ride along with Nyquist maxima resolved at the graph's
            # sample rate (parameters.rs:109-230 GUI hint surface)
            params = [
                (p.name, p.ptype, _resolved_hint(p, graph.sample_rate))
                for p in e.ugen.params
            ]
        gi.nodes.append(
            NodeInspection(
                nid=nid,
                name=e.name,
                type_name=e.ugen.name() if e.ugen else "Graph",
                inputs=e.inputs,
                outputs=e.outputs,
                params=params,
                done_action=e.done_action.name,
                mortal=e.mortal,
                auto=e.auto,
                subgraph=inspect(e.subgraph) if e.subgraph else None,
            )
        )
    for dst, lists in graph.in_edges.items():
        for dst_ch, lst in enumerate(lists):
            for edge in lst:
                gi.edges.append(
                    EdgeInspection(edge.kind, edge.src, edge.ch, dst, dst_ch)
                )
    for out_ch, lst in enumerate(graph.out_edges):
        for edge in lst:
            gi.edges.append(
                EdgeInspection(
                    "graph_out" if edge.kind == "node" else edge.kind,
                    edge.src, edge.ch, None, out_ch,
                )
            )
    for (dst, pidx), edge in graph.param_edges.items():
        gi.edges.append(EdgeInspection("param", edge.src, edge.ch, dst, pidx))
    return gi


def node_handles(graph: Graph, inspection: Optional[GraphInspection] = None):
    """Rebuild live Handles from an inspection snapshot — parity with the
    reference's ``GraphInspection::node_handles`` (inspection.rs:49), which
    lets UIs that only hold an inspection re-acquire control of the graph.
    Returns ``{node_id: Handle}`` for every user node (auto-inserted
    math/feedback sugar nodes excluded)."""
    gi = inspection if inspection is not None else inspect(graph)
    return {n.nid: graph.handle(n.nid) for n in gi.nodes if not n.auto}


def to_dot(graph: Graph) -> str:
    """Graphviz dot source for the graph (inspection.rs dot exporter)."""
    gi = inspect(graph)
    lines = ["digraph knaster {", "  rankdir=LR;", "  node [shape=record];"]

    def emit(gi: GraphInspection, prefix: str, indent: str):
        lines.append(f'{indent}label="{gi.name}";')
        if gi.inputs:
            lines.append(
                f'{indent}{prefix}gin [shape=cds,label="in x{gi.inputs}"];'
            )
        if gi.outputs:
            lines.append(
                f'{indent}{prefix}gout [shape=cds,label="out x{gi.outputs}"];'
            )
        for n in gi.nodes:
            if n.subgraph is not None:
                lines.append(f"{indent}subgraph cluster_{n.nid} {{")
                emit(n.subgraph, f"{prefix}s{n.nid}_", indent + "  ")
                lines.append(f"{indent}}}")
            else:
                plist = ", ".join(name for name, _, _ in n.params[:6])
                style = ',style=dashed' if n.auto else ""
                # param hints as a hover tooltip (range/log/kind surface)
                hints = "; ".join(
                    f"{name}: {hint}" for name, _, hint in n.params
                    if hint is not None
                )
                tip = f',tooltip="{hints}"' if hints else ""
                lines.append(
                    f'{indent}{prefix}n{n.nid} [label="{{{n.name}|{n.inputs}in '
                    f'{n.outputs}out|{plist}}}"{style}{tip}];'
                )
        for e in gi.edges:
            src = f"{prefix}gin" if e.kind == "graph_in" else f"{prefix}n{e.src}"
            dst = f"{prefix}gout" if e.dst is None else f"{prefix}n{e.dst}"
            attrs = []
            if e.kind == "feedback":
                attrs.append("color=red,label=fb")
            if e.kind == "param":
                attrs.append("style=dotted,label=ar-param")
            a = f" [{','.join(attrs)}]" if attrs else ""
            lines.append(f"{indent}{src} -> {dst}{a};")

    emit(gi, "", "  ")
    lines.append("}")
    return "\n".join(lines)


def show_dot_svg(graph: Graph, path: str = "graph.svg") -> Optional[str]:
    """Render the dot graph to an SVG file if Graphviz is installed
    (inspection.rs show_dot_svg). Returns the path, or None without dot."""
    dot = to_dot(graph)
    exe = shutil.which("dot")
    if exe is None:
        return None
    svg = subprocess.run(
        [exe, "-Tsvg"], input=dot.encode(), capture_output=True, check=True
    ).stdout
    with open(path, "wb") as f:
        f.write(svg)
    return path
