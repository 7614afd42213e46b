"""Port of knaster_tpu/graph/handles.py: the connection and parameter API.

Plain Python, as in the JAX package; the analog of
knaster_graph/src/graph_edit.rs (SH/DH handles) and handle.rs. A handle is a
lightweight view of one or more output channels of nodes in a Graph;
connection sugar:

* ``a.to(b)``            — connect (additive; reference graph_edit.rs:295)
* ``a >> b``             — same as ``to``
* ``a | b``              — stack channels (reference ``stack``/``|``)
* ``a.to_feedback(b)``   — connect through a one-block feedback delay
* ``a.to_replace(b)``    — replace existing input edges
* ``a.to_graph_out()``   — connect to the graph outputs
* ``a * 2.0``, ``a + b`` … — desugar into Constant/Math nodes exactly like the
  reference's operator overloads (graph_edit.rs:1040-1207)
* ``a.param("freq")``    — a :class:`Parameter` for scheduling changes

Since Python has no borrow checker, handles stay valid across edits; using a
handle whose node was freed raises ``GraphError`` (parity with the reference's
abandoned-channel detection, handle.rs:56-60).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

from ..primitives.params import Smoothing
from .scheduling import Time

# channel ref kinds
K_NODE = "node"
K_GRAPH_IN = "graph_in"


class Source:
    """An ordered list of output channels: the common base of all handles."""

    def __init__(self, graph, channels: Sequence[Tuple[str, Optional[int], int]]):
        self.graph = graph
        self.channels: List[Tuple[str, Optional[int], int]] = list(channels)

    # --- connection sugar --------------------------------------------------
    def to(self, other: "Handle") -> "Handle":
        self.graph._connect_source(self, other, replace=False, feedback=False)
        return other

    def to_feedback(self, other: "Handle") -> "Handle":
        self.graph._connect_source(self, other, replace=False, feedback=True)
        return other

    def to_replace(self, other: "Handle") -> "Handle":
        self.graph._connect_source(self, other, replace=True, feedback=False)
        return other

    def to_feedback_replace(self, other: "Handle") -> "Handle":
        self.graph._connect_source(self, other, replace=True, feedback=True)
        return other

    def to_graph_out(self) -> None:
        self.graph._connect_source_to_out(
            self, list(range(len(self.channels))), replace=False
        )

    def to_graph_out_replace(self) -> None:
        self.graph._connect_source_to_out(
            self, list(range(len(self.channels))), replace=True
        )

    def to_graph_out_channels(self, sink_channels) -> None:
        chs = _as_channel_list(sink_channels)
        self.graph._connect_source_to_out(self, chs, replace=False)

    def to_graph_out_channels_replace(self, sink_channels) -> None:
        chs = _as_channel_list(sink_channels)
        self.graph._connect_source_to_out(self, chs, replace=True)

    def __rshift__(self, other):
        if isinstance(other, Source):
            return self.to(other)
        return NotImplemented

    def __or__(self, other):
        if isinstance(other, Source):
            return Source(self.graph, self.channels + other.channels)
        return NotImplemented

    stack = __or__

    def out(self, chs) -> "Source":
        """Select/duplicate channels, e.g. ``sig.out([0, 0])`` for mono→stereo."""
        chs = _as_channel_list(chs)
        return Source(self.graph, [self.channels[c] for c in chs])

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    # --- operator desugaring into Math/Constant nodes ----------------------
    def _binary(self, other, op: str, swapped: bool = False):
        g = self.graph
        if isinstance(other, Source):
            rhs = other
        elif isinstance(other, (int, float)):
            rhs = g._push_constant(float(other))
        else:
            return NotImplemented
        lhs = self
        if swapped:
            lhs, rhs = rhs, lhs
        return g._push_math_op(op, lhs, rhs)

    def __mul__(self, other):
        return self._binary(other, "mul")

    __rmul__ = __mul__

    def __add__(self, other):
        return self._binary(other, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "sub")

    def __rsub__(self, other):
        return self._binary(other, "sub", swapped=True)

    def __truediv__(self, other):
        return self._binary(other, "div")

    def __rtruediv__(self, other):
        return self._binary(other, "div", swapped=True)

    def pow(self, other):
        return self._binary(other, "pow")

    __pow__ = pow


class Handle(Source):
    """Handle to a single node (reference SH/DH, graph_edit.rs:266,273)."""

    def __init__(self, graph, node_id: int):
        entry = graph._node(node_id)
        super().__init__(
            graph, [(K_NODE, node_id, c) for c in range(entry.outputs)]
        )
        self.node_id = node_id

    def id(self) -> int:
        return self.node_id

    def name(self, n: str) -> "Handle":
        self.graph._node(self.node_id).name = n
        return self

    def param(self, p: Union[str, int]) -> "Parameter":
        entry = self.graph._node(self.node_id)
        idx = entry.ugen.param_index(p)
        return Parameter(self.graph, self.node_id, idx)

    def try_param(self, p) -> Optional["Parameter"]:
        try:
            return self.param(p)
        except KeyError:
            return None

    def param_hints(self, resolve: bool = True) -> dict:
        """{name: hint} for every parameter of this node — the GUI-facing
        hint surface (parameters.rs:109-230 param_hints()). With ``resolve``
        (default), Nyquist maxima are resolved to the graph's sample rate;
        params without a declared hint map to None."""
        import dataclasses

        from ..primitives.params import FloatHint, Nyquist

        entry = self.graph._node(self.node_id)
        out = {}
        for p in entry.ugen.params:
            h = p.hint
            if (resolve and isinstance(h, FloatHint)
                    and isinstance(h.maximum, Nyquist)):
                h = dataclasses.replace(
                    h, maximum=h.resolve_max(self.graph.sample_rate)
                )
            out[p.name] = h
        return out

    def disconnect_output(self, source_channel: int = 0) -> None:
        self.graph.disconnect_output_from_source(self.node_id, source_channel)

    def disconnect_input(self, sink_channel: int = 0) -> None:
        self.graph.disconnect_input_to_sink(sink_channel, self.node_id)

    def free(self) -> None:
        self.graph.free_node(self.node_id)

    def dynamic(self) -> "Handle":
        return self  # all handles are runtime-checked in Python


class Parameter:
    """Schedule changes of one node parameter.

    Parity with graph_edit.rs:1700-1870 (Parameter): set / set_at / set_after
    / smooth / trig, each queueing a scheduling event the processor consumes.
    """

    def __init__(self, graph, node_id: int, param_idx: int):
        self.graph = graph
        self.node_id = node_id
        self.param_idx = param_idx
        spec = graph._node(node_id).ugen.params[param_idx]
        self.ptype = spec.ptype
        self.name = spec.name

    @property
    def hint(self):
        """The parameter's declared hint (FloatHint/IntegerHint or None),
        Nyquist maxima resolved at the graph sample rate."""
        return Handle(self.graph, self.node_id).param_hints()[self.name]

    # -- float / int / bool set ------------------------------------------
    # every scheduler takes ``token=`` (a SchedulingToken) to group changes
    # into one atomic same-block batch (scheduling.rs:146-188)
    def set(self, value, token=None) -> None:
        self.set_time(value, Time.asap(), token=token)

    def set_at(self, value, t, token=None) -> None:
        self.set_time(value, Time.at(t), token=token)

    def set_after(self, value, t, token=None) -> None:
        self.set_time(value, Time.after(t), token=token)

    def set_time(self, value, t: Time, token=None) -> None:
        if self.ptype == "float":
            payload = ("set_float", float(value))
        elif self.ptype in ("integer", "bool"):
            if hasattr(value, "value"):  # enum member
                value = value.value
            payload = ("set_int", int(value))
        elif self.ptype == "trigger":
            payload = ("trig",)
        else:
            raise TypeError(self.ptype)
        self.graph._queue_event(self.node_id, self.param_idx, payload, t,
                                token=token)

    # -- smoothing config ---------------------------------------------------
    def smooth(self, s, rate: str = "audio", token=None) -> None:
        self.smooth_time(s, Time.asap(), rate=rate, token=token)

    def smooth_at(self, s, t, rate: str = "audio", token=None) -> None:
        self.smooth_time(s, Time.at(t), rate=rate, token=token)

    def smooth_after(self, s, t, rate: str = "audio", token=None) -> None:
        self.smooth_time(s, Time.after(t), rate=rate, token=token)

    def smooth_time(self, s, t: Time, rate: str = "audio", token=None) -> None:
        if self.ptype != "float":
            raise TypeError("smoothing only applies to float parameters")
        if isinstance(s, Smoothing):
            sm = s
        elif isinstance(s, (int, float)):
            sm = Smoothing.linear(float(s), rate)
        elif s in (None, "none"):
            sm = Smoothing.none()
        else:
            raise TypeError(f"cannot interpret {s!r} as Smoothing")
        mode = 1 if sm.mode == "linear" else 0
        srate = 1 if sm.rate == "block" else 0
        dur_frames = int(round(sm.time * self.graph.sample_rate))
        payload = ("smooth_cfg", mode, dur_frames, srate)
        self.graph._queue_event(self.node_id, self.param_idx, payload, t,
                                token=token)

    # -- triggers -------------------------------------------------------------
    def trig(self, token=None) -> None:
        self.trig_time(Time.asap(), token=token)

    def trig_at(self, t, token=None) -> None:
        self.trig_time(Time.at(t), token=token)

    def trig_after(self, t, token=None) -> None:
        self.trig_time(Time.after(t), token=token)

    def trig_time(self, t: Time, token=None) -> None:
        if self.ptype != "trigger":
            raise TypeError(f"parameter {self.name!r} is not a trigger")
        self.graph._queue_event(self.node_id, self.param_idx, ("trig",), t,
                                token=token)


def _as_channel_list(chs) -> List[int]:
    if isinstance(chs, int):
        return [chs]
    return list(chs)
