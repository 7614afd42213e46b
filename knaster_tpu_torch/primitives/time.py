"""Port of knaster_tpu/primitives/time.py: lossless musical and wall-clock time.

Plain Python, copied so that the port imports no JAX. A re-design of
knaster's fixed-point time types
(reference: knaster_primitives/src/time.rs:11-504).

``Seconds`` stores time as ``seconds + subsecond_tesimals`` where one second
contains 282_240_000 "tesimals" — a number divisible by every common audio
sample rate (44.1k/48k/88.2k/96k/176.4k/192k...), so samples <-> seconds
conversion is exact at any of them.  ``Beats`` uses 1_476_034_560 tesimals
per beat (divisible by 3, 5, 7, 11, 13 subdivisions...).

These types live on the host (graph-building / scheduling side); on-device
time is plain integer frame counts.  Python's unbounded ints make the
arithmetic overflow-free; we keep the reference's semantics (non-negative
time, saturating/checked subtraction).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import total_ordering

SUBSECOND_TESIMALS_PER_SECOND: int = 282_240_000
SUBBEAT_TESIMALS_PER_BEAT: int = 1_476_034_560


@total_ordering
@dataclass(frozen=True)
class Seconds:
    """Exact wall-clock time: ``seconds`` + ``subsecond_tesimals``.

    Mirrors knaster_primitives/src/time.rs:25 (``Seconds``).
    """

    seconds: int = 0
    subsecond_tesimals: int = 0

    ZERO: "Seconds" = None  # set after class definition
    MAX: "Seconds" = None

    def __post_init__(self):
        if self.seconds < 0 or self.subsecond_tesimals < 0:
            raise ValueError("Seconds cannot be negative")
        # normalize tesimal overflow into seconds
        if self.subsecond_tesimals >= SUBSECOND_TESIMALS_PER_SECOND:
            extra, rem = divmod(self.subsecond_tesimals, SUBSECOND_TESIMALS_PER_SECOND)
            object.__setattr__(self, "seconds", self.seconds + extra)
            object.__setattr__(self, "subsecond_tesimals", rem)

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_tesimals(tesimals: int) -> "Seconds":
        s, rem = divmod(int(tesimals), SUBSECOND_TESIMALS_PER_SECOND)
        return Seconds(s, rem)

    @staticmethod
    def from_secs_f64(seconds_f64: float) -> "Seconds":
        if seconds_f64 < 0:
            raise ValueError("Seconds cannot be negative")
        whole = math.floor(seconds_f64)
        frac = seconds_f64 - whole
        return Seconds(int(whole), int(frac * SUBSECOND_TESIMALS_PER_SECOND))

    @staticmethod
    def from_samples(samples: int, sample_rate: int) -> "Seconds":
        samples = int(samples)
        sr = int(sample_rate)
        seconds = samples // sr
        tesimals = (samples % sr) * SUBSECOND_TESIMALS_PER_SECOND // sr
        return Seconds(seconds, tesimals)

    @staticmethod
    def from_ms(ms: float) -> "Seconds":
        return Seconds.from_secs_f64(ms / 1000.0)

    # --- conversions ------------------------------------------------------
    def to_tesimals(self) -> int:
        return self.seconds * SUBSECOND_TESIMALS_PER_SECOND + self.subsecond_tesimals

    def to_secs_f64(self) -> float:
        return self.seconds + self.subsecond_tesimals / SUBSECOND_TESIMALS_PER_SECOND

    def to_samples(self, sample_rate: int) -> int:
        """Exact number of whole samples at `sample_rate` (floor)."""
        sr = int(sample_rate)
        return self.seconds * sr + (self.subsecond_tesimals * sr) // SUBSECOND_TESIMALS_PER_SECOND

    def to_samples_f64(self, sample_rate: float) -> float:
        return self.seconds * sample_rate + (
            self.subsecond_tesimals * sample_rate / SUBSECOND_TESIMALS_PER_SECOND
        )

    # --- arithmetic ---------------------------------------------------------
    def __add__(self, other: "Seconds") -> "Seconds":
        other = _coerce_seconds(other)
        return Seconds.from_tesimals(self.to_tesimals() + other.to_tesimals())

    def __sub__(self, other: "Seconds") -> "Seconds":
        other = _coerce_seconds(other)
        out = self.checked_sub(other)
        if out is None:
            raise ValueError("Seconds subtraction went negative")
        return out

    def checked_sub(self, other: "Seconds") -> "Seconds | None":
        d = self.to_tesimals() - _coerce_seconds(other).to_tesimals()
        return None if d < 0 else Seconds.from_tesimals(d)

    def saturating_sub(self, other: "Seconds") -> "Seconds":
        d = self.to_tesimals() - _coerce_seconds(other).to_tesimals()
        return Seconds.ZERO if d <= 0 else Seconds.from_tesimals(d)

    def __mul__(self, k: int) -> "Seconds":
        return Seconds.from_tesimals(self.to_tesimals() * int(k))

    __rmul__ = __mul__

    def __lt__(self, other) -> bool:
        return self.to_tesimals() < _coerce_seconds(other).to_tesimals()

    def __eq__(self, other) -> bool:
        try:
            return self.to_tesimals() == _coerce_seconds(other).to_tesimals()
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.to_tesimals())

    def __repr__(self):
        return f"Seconds({self.seconds}, {self.subsecond_tesimals})"


Seconds.ZERO = Seconds(0, 0)
Seconds.MAX = Seconds(2**32 - 1, SUBSECOND_TESIMALS_PER_SECOND - 1)


def _coerce_seconds(x) -> Seconds:
    if isinstance(x, Seconds):
        return x
    if isinstance(x, (int, float)):
        return Seconds.from_secs_f64(float(x))
    raise TypeError(f"cannot interpret {x!r} as Seconds")


@total_ordering
@dataclass(frozen=True)
class Beats:
    """Exact musical time (reference: knaster_primitives/src/time.rs:245)."""

    beats: int = 0
    subbeat_tesimals: int = 0

    ZERO: "Beats" = None

    def __post_init__(self):
        if self.beats < 0 or self.subbeat_tesimals < 0:
            raise ValueError("Beats cannot be negative")
        if self.subbeat_tesimals >= SUBBEAT_TESIMALS_PER_BEAT:
            extra, rem = divmod(self.subbeat_tesimals, SUBBEAT_TESIMALS_PER_BEAT)
            object.__setattr__(self, "beats", self.beats + extra)
            object.__setattr__(self, "subbeat_tesimals", rem)

    @staticmethod
    def from_tesimals(t: int) -> "Beats":
        b, rem = divmod(int(t), SUBBEAT_TESIMALS_PER_BEAT)
        return Beats(b, rem)

    @staticmethod
    def from_beats_f64(beats: float) -> "Beats":
        whole = math.floor(beats)
        return Beats(int(whole), int((beats - whole) * SUBBEAT_TESIMALS_PER_BEAT))

    @staticmethod
    def from_fractional_beats(num: int, den: int) -> "Beats":
        """Exact n/d of a beat (e.g. 1/3 triplet)."""
        return Beats.from_tesimals(num * SUBBEAT_TESIMALS_PER_BEAT // den)

    def to_tesimals(self) -> int:
        return self.beats * SUBBEAT_TESIMALS_PER_BEAT + self.subbeat_tesimals

    def to_beats_f64(self) -> float:
        return self.beats + self.subbeat_tesimals / SUBBEAT_TESIMALS_PER_BEAT

    def to_seconds(self, bpm: float) -> Seconds:
        return Seconds.from_secs_f64(self.to_beats_f64() * 60.0 / bpm)

    def __add__(self, other: "Beats") -> "Beats":
        return Beats.from_tesimals(self.to_tesimals() + other.to_tesimals())

    def __sub__(self, other: "Beats") -> "Beats":
        d = self.to_tesimals() - other.to_tesimals()
        if d < 0:
            raise ValueError("Beats subtraction went negative")
        return Beats.from_tesimals(d)

    def __lt__(self, other) -> bool:
        return self.to_tesimals() < other.to_tesimals()

    def __eq__(self, other) -> bool:
        if not isinstance(other, Beats):
            return NotImplemented
        return self.to_tesimals() == other.to_tesimals()

    def __hash__(self):
        return hash(("beats", self.to_tesimals()))


Beats.ZERO = Beats(0, 0)
