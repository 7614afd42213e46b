"""Port of knaster_tpu/parallel/pool.py: ``VoicePool``, a voice allocator over a bank node.

The reference's polyphony idiom is "push a voice node per note, free it
when its envelope reports done" (knaster/examples/many_sines.rs +
knaster_graph/src/wrappers_graph/done.rs WrDone). At bank scale that
becomes: take a free voice index, send its note-on events, and give the
index back when the voice's envelope finishes, with no graph recompile.

The release rides the bank's per-voice idle latch: a bool per voice on the
device that the bank sets when the voice's body reports idle (its
``idle_of``) and that a note-on clears (event kind 5). The pool reads the
latch only when its host-side free list runs dry: one device-to-host copy
per ``refresh``, through the bank's ``idle_vector``. Over a
``MeshVoiceBank`` each shard keeps the latch of its own voices on its
device: its ``idle_vector`` copies each shard's latch to the host and joins
them in shard order, which is voice order.

The JAX package's banks compute the latch only once a pool turns
``track_idle`` on, and the pool then re-freezes the bank node's structural
signature, so that the program cache does not serve the latch-free
program, and recompiles. The port has no such switch: its banks, the vmap
``VoiceBank`` and the fused ones alike, always compute the latch, so a pool
changes nothing in the graph, neither its renderers nor the signature
frozen at push time, and re-freezes nothing.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..graph.scheduling import Time


class VoicePool:
    """Allocate and auto-release voices of a voice bank pushed into a graph.

    processor:       the AudioProcessor running the graph.
    bank_handle:     the Handle returned by pushing the bank.
    note_on_trigger: the trigger param :meth:`note_on` fires (None: none).
    steal:           when the pool is exhausted, ``None`` (note_on returns
                     None) or ``"oldest"`` (reuse the longest-held voice).
    """

    def __init__(self, processor, bank_handle, note_on_trigger="t_restart",
                 steal: Optional[str] = None):
        if steal not in (None, "oldest"):
            raise ValueError("steal must be None or 'oldest'")
        self.processor = processor
        self.graph = bank_handle.graph
        self.node_id = bank_handle.node_id
        self.bank = self.graph._node(self.node_id).ugen
        self.handle = bank_handle
        self.steal = steal
        self.note_on_trigger = note_on_trigger
        self._trig_idx = (self.bank.trig_index(note_on_trigger)
                          if note_on_trigger is not None else None)
        self._free = list(range(self.bank.n_voices))
        self._held: "OrderedDict[int, int]" = OrderedDict()  # voice -> due frame

    # ------------------------------------------------------------ queries
    @property
    def n_voices(self) -> int:
        return self.bank.n_voices

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def held_count(self) -> int:
        return len(self._held)

    # ------------------------------------------------------------ control
    def note_on(self, params: Optional[Dict[str, float]] = None, at=None,
                token=None) -> Optional[int]:
        """Take a voice and start a note: clear its idle latch, set the
        given per-voice float params and fire the note-on trigger, all at the
        same (sample-accurate) time ``at`` (Seconds; None: the next block).
        Returns the voice, or None when the pool is exhausted and stealing is
        off."""
        t = Time.at(at) if at is not None else Time.asap()
        if not self._free:
            self.refresh()
        if self._free:
            voice = self._free.pop(0)
        elif self.steal == "oldest":
            voice, _ = self._held.popitem(last=False)
        else:
            return None
        # a voice can be released only once the block holding its note-on
        # has rendered: before that the latch shows the voice's old state
        if t.kind == "at" and t.seconds is not None:
            due = t.seconds.to_samples(self.graph.sample_rate)
        else:
            due = self.graph.clock.frames
        self._held[voice] = due
        q = self.graph._queue_event
        q(self.node_id, 0, ("voice_idle_clear", voice), t, token=token)
        for name, value in (params or {}).items():
            i = self.bank.float_index(name)
            q(self.node_id, i, ("voice_float", voice, i, float(value)), t, token=token)
        if self._trig_idx is not None:
            q(self.node_id, self._trig_idx, ("voice_trig", voice, self._trig_idx), t,
              token=token)
        return voice

    def note_off(self, voice: int, trigger: str = "t_release", at=None,
                 token=None) -> None:
        """Fire a release trigger on a held voice. The voice stays held
        until its body reports idle (the latch) or :meth:`release` is
        called. A voice stopped by an Envelope's ``t_stop`` holds its frozen
        value and never reports idle: release it by hand."""
        t = Time.at(at) if at is not None else Time.asap()
        idx = self.bank.trig_index(trigger)
        self.graph._queue_event(self.node_id, idx, ("voice_trig", voice, idx), t,
                                token=token)

    def release(self, voice: int) -> None:
        """Return a voice to the free list now (host side only)."""
        if self._held.pop(voice, None) is not None:
            self._free.append(voice)

    # ------------------------------------------------------------ refresh
    def _idle_vector(self) -> np.ndarray:
        proc = self.processor
        proc._ensure_compiled()
        loc = proc.compiled._node_loc(self.node_id)
        if loc is None or loc[0] != "single":
            raise RuntimeError("the voice bank node is not in the compiled plan")
        return self.bank.idle_vector(proc.state["nodes"][loc[1]])

    def refresh(self) -> int:
        """Read the bank's idle latch (one device-to-host copy) and release
        the held voices that went idle after their note-on's block. Returns
        the number released. ``note_on`` calls it when the free list is
        empty."""
        idle = self._idle_vector()
        clock = self.graph.clock.frames
        B = self.graph.block_size
        released = 0
        for voice in [v for v, due in self._held.items() if idle[v] and clock >= due + B]:
            self.release(voice)
            released += 1
        return released
