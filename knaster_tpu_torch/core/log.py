"""Port of knaster_tpu/core/log.py: log rings and probes for UGens.

The reference streams allocation-free log chains from the audio thread over
bounded SPSC rings (knaster_core/src/log.rs ArLogSender/Receiver + rt_log!).
The same surface and semantics here:

* :class:`ArLogReceiver` / :class:`ArLogSender` — bounded per-channel rings
  with the reference's capacity contract: a chain that does not fit is
  DROPPED (rtrb's failed push), never blocking the render;
  ``receiver.recv(handler)`` drains complete chains (those ended by the END
  sentinel) and leaves a partial chain for the next drain.
* :func:`rt_log` — log from inside a UGen's ``process``.
  ``rt_log(logger, "peak ", x)`` pushes a chain into the logger's ring; a
  tensor part is kept as a detached copy on its device and read on the
  host only when the receiver drains it, so the render never waits on a
  device-to-host copy (where the JAX package's ``jax.debug.callback``
  delivers it at run time). ``rt_log("fmt {x}", x=...)`` prints at once, as
  ``jax.debug.print`` does.
* :class:`ProbeCapture` / :func:`collect_probes` — the host's drain of the
  ``LogProbe`` UGens in a graph's state (``AudioProcessor.probe_log``).
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch

END = "\x00END"  # chain terminator sentinel (ArLogMessage::End)


def _host(part):
    """A logged part as the handler sees it: a tensor as a Python number
    (0-d) or a numpy array, anything else as it is."""
    if isinstance(part, torch.Tensor):
        a = part.cpu().numpy()
        return a.item() if a.ndim == 0 else a
    return part


class ArLogSender:
    """Sender half of one bounded log channel (log.rs:243-271 ArLogSender).

    ``send`` pushes one message, ``log(*parts)`` a full chain (the
    ``rt_log!`` macro: the parts, then End). A chain that does not fit the
    ring is dropped and ``dropped`` counts it: logging never blocks or
    grows the ring. A sender from :meth:`non_rt` forwards to Python's
    ``logging`` instead (log.rs non_rt)."""

    def __init__(self, ring: deque, capacity: int, lock: threading.Lock):
        self._ring = ring
        self._capacity = int(capacity)
        self._lock = lock
        self._non_rt = False
        self.dropped = 0

    @staticmethod
    def non_rt() -> "ArLogSender":
        s = ArLogSender(deque(), 0, threading.Lock())
        s._non_rt = True
        return s

    def send(self, message) -> None:
        """Push a single message (prefer :meth:`log` / :func:`rt_log`)."""
        self._push_chain((message,), terminate=False)

    def log(self, *parts) -> None:
        """Push one full chain; tensor parts are read when drained."""
        self._push_chain(tuple(p.detach().clone() if isinstance(p, torch.Tensor) else p
                               for p in parts))

    def _push_chain(self, parts: Tuple, terminate: bool = True) -> None:
        if self._non_rt:
            logging.getLogger("knaster_tpu_torch").warning(
                " ".join(str(_host(p)) for p in parts))
            return
        n = len(parts) + (1 if terminate else 0)
        with self._lock:
            if len(self._ring) + n > self._capacity:
                self.dropped += 1  # rtrb push failure: drop, never block
                return
            self._ring.extend(parts)
            if terminate:
                self._ring.append(END)


def _is_end(m) -> bool:
    return isinstance(m, str) and m == END


class ArLogReceiver:
    """Receiver for any number of bounded log channels (log.rs:118-240).

    ``sender(capacity)`` adds a channel and returns its sender;
    ``recv(handler)`` drains every channel, calling ``handler(chain)`` once
    per COMPLETE chain (a tuple, tensor parts read to the host) and leaving
    an incomplete tail in the ring."""

    def __init__(self):
        self._channels: List[Tuple[deque, threading.Lock]] = []

    def sender(self, capacity: int = 1024) -> ArLogSender:
        ring: deque = deque()
        lock = threading.Lock()
        self._channels.append((ring, lock))
        return ArLogSender(ring, capacity, lock)

    def channels(self) -> int:
        return len(self._channels)

    def recv(self, handler: Callable[[Sequence], None]) -> int:
        """Drain complete chains; returns the number delivered."""
        delivered = 0
        for ring, lock in self._channels:
            with lock:
                items = list(ring)
                last_end = max((i for i, m in enumerate(items) if _is_end(m)), default=-1)
                for _ in range(last_end + 1):
                    ring.popleft()
            chain: List = []
            for m in items[:last_end + 1]:
                if _is_end(m):
                    handler(tuple(chain))
                    delivered += 1
                    chain = []
                else:
                    chain.append(_host(m))
        return delivered


def rt_log(*args, **kwargs) -> None:
    """Log from inside a UGen's process (reference rt_log!, log.rs:271).

    Two forms::

        rt_log(logger, "peak ", peak_val)              # a chain into a ring
        rt_log("peak {p}", p=x.abs().max())            # printed at once
    """
    if args and isinstance(args[0], ArLogSender):
        logger, *parts = args
        logger.log(*parts)
        return
    fmt, *rest = args
    print(fmt.format(*(_host(a) for a in rest),
                     **{k: _host(v) for k, v in kwargs.items()}))


@dataclass
class ProbeCapture:
    name: str
    value: float
    fired: bool


def collect_probes(compiled, state) -> List[ProbeCapture]:
    """The latest ``LogProbe`` captures in a graph's state, every probe's
    value and flag stacked into one tensor and copied to the host once."""
    from ..ugens.util import LogProbe

    names, rows = [], []
    for nid in compiled.order:
        entry = compiled.entries[nid]
        if isinstance(entry.ugen, LogProbe):
            st = state["nodes"][compiled.state_key(nid)]
            names.append(entry.ugen.probe_name)
            rows.append(torch.stack([st["last_value"].to(torch.float64),
                                     st["fired"].to(torch.float64)]))
    if not rows:
        return []
    host = torch.stack(rows).cpu().numpy()  # one device-to-host copy
    return [ProbeCapture(name=n, value=float(v), fired=bool(f))
            for n, (v, f) in zip(names, host)]
