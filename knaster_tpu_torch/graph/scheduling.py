"""Port of knaster_tpu/graph/scheduling.py: when a parameter change takes effect.

Plain Python, as in the JAX package; the analog of
knaster_graph/src/scheduling.rs. The reference streams
``SchedulingEvent``s over a lock-free ring to the audio thread, which
converts ``Time`` to a sample delay against the shared frame clock
(scheduling.rs:95-121). Here the host converts queued events to
frame-stamped slots in the per-block event lists the parameter engine
materializes (see param_engine.py); the frame clock is plain integer
bookkeeping on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from ..primitives.time import Seconds


@dataclass(frozen=True)
class Time:
    """When an event should be applied (scheduling.rs:73-139).

    kind 'asap'  — start of the next processed block.
    kind 'at'    — absolute time from stream start.
    kind 'after' — relative to the frame clock when the event is *queued*
                   (resolved to absolute at queue time by the processor).
    """

    kind: str = "asap"
    seconds: Optional[Seconds] = None

    @staticmethod
    def asap() -> "Time":
        return Time("asap", None)

    @staticmethod
    def at(t) -> "Time":
        return Time("at", _secs(t))

    @staticmethod
    def after(t) -> "Time":
        return Time("after", _secs(t))


def _secs(t) -> Seconds:
    if isinstance(t, Seconds):
        return t
    return Seconds.from_secs_f64(float(t))


@dataclass
class ScheduledEvent:
    """One queued parameter event, host side.

    ``due_frame`` is the absolute frame index at which it applies (resolved
    from Time by the processor when queued); payload is a tuple tagged with
    the operation ('set_float', v) | ('smooth_cfg', smode, dur_frames, srate)
    | ('trig',) | ('set_int', v).
    """

    due_frame: int
    node_id: int
    param_idx: int
    payload: Tuple[Any, ...]
    order: int = 0  # stable tie-break: send order


class SchedulingToken:
    """Group parameter changes and apply them ATOMICALLY in one block.

    Parity with knaster_graph/src/scheduling.rs:146-188 (the reference
    declares the same contract but leaves ``activate`` as ``todo!()``; we
    implement the documented semantics). Attach the token to any number of
    ``Parameter.set/trig/smooth`` calls via ``token=``; none of the changes
    is queued until :meth:`activate`, which releases them in one atomic
    batch — asap changes land at the same block start, timed changes keep
    their own frames but become visible to the engine together. ::

        tok = SchedulingToken()
        freq.set(880.0, token=tok)
        amp.set(0.5, token=tok)
        tok.activate()       # both take effect in the same block
    """

    def __init__(self):
        self._held = []  # (root_graph, queue_fn) pairs
        self._activated = False

    def is_activated(self) -> bool:
        return self._activated

    def _hold(self, root, queue_fn) -> None:
        if self._activated:
            raise RuntimeError("SchedulingToken was already activated")
        self._held.append((root, queue_fn))

    def activate(self) -> None:
        """Release every attached change in one atomic batch per graph.

        Event times resolve NOW (so every 'after'/'asap' in the batch shares
        the same reference frame) and the whole batch is appended to each
        graph's queue in one list.extend — the processor's atomic drain sees
        either none or all of it."""
        if self._activated:
            raise RuntimeError("SchedulingToken was already activated")
        self._activated = True
        by_root = {}
        for root, queue_fn in self._held:
            by_root.setdefault(id(root), (root, []))[1].append(queue_fn)
        for root, fns in by_root.values():
            with root.event_lock:  # atomic vs the processor's drain swap
                root.event_queue.extend([fn() for fn in fns])
        self._held.clear()
