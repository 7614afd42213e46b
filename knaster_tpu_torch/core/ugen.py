"""Port of knaster_tpu/core/ugen.py: ``AudioCtx`` and the UGen declaration protocol.

A UGen instance holds only static configuration (Python numbers, enums,
declared ``params``); runtime state lives in the dict its ``init`` returns.
Only the declaration side is ported so far: the fused sine bank reads a
voice's ``params`` and ``pdefaults`` and renders the voice in its kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..primitives.params import Param


@dataclass(frozen=True)
class AudioCtx:
    """Static per-graph context (reference: knaster_core/src/ugen.rs:8 AudioCtx)."""

    sample_rate: int = 48000
    block_size: int = 64
    dtype: torch.dtype = torch.float32

    @property
    def nyquist(self) -> float:
        return self.sample_rate / 2.0


class UGen:
    """Base class for unit generators: channel counts and parameter table."""

    inputs: int = 0
    outputs: int = 1
    params: Tuple[Param, ...] = ()
    # Nodes with a private event channel (VoiceBank's per-voice events) set
    # this > 0 and build events with empty_node_events / node_events_from_lists.
    event_capacity: int = 0

    def name(self) -> str:
        return type(self).__name__

    def empty_node_events(self, dtype=None):
        raise NotImplementedError

    def node_events_from_lists(self, events, dtype=None):
        raise NotImplementedError
