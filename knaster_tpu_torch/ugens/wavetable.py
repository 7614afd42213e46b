"""Port of knaster_tpu/ugens/wavetable.py: phase constants, the wavetables and table decomposition.

The oscillators carry a u32 phase of ``TABLE_SIZE * FRACTIONAL_PART`` units
per cycle (osc.rs semantics); the table is read at the index in the phase's
top bits. ``NonAaWavetable`` builds one table cycle on the host (float64,
as the reference does); an anti-aliased ``Wavetable`` keeps 17 partial
tables spaced x1.5 in max playback frequency (wavetable.rs:327
TABLE_AA_SPACING), and the playback frequency selects the table per sample
(``OscWt``: a searchsorted over ``AA_FREQ_THRESHOLDS``).
``harmonics_from_table`` decomposes a cycle into the partials the additive
wavetable bank re-synthesizes. All of it is numpy on the host, copied so
that the port needs no JAX: the tables equal the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

TABLE_POWER = 14
TABLE_SIZE = 1 << TABLE_POWER  # 16384
TABLE_HIGH_MASK = TABLE_SIZE - 1
FRACTIONAL_PART = 65536
TABLE_AA_SPACING = 1.5
NUM_AA_TABLES = 17

# Max playback frequency per AA table (freq_to_table_index ladder,
# wavetable.rs:333-379): index = number of thresholds below freq.
AA_FREQ_THRESHOLDS = np.array(
    [32.0 * TABLE_AA_SPACING**i for i in range(NUM_AA_TABLES - 1)], dtype=np.float32
)


def freq_to_table_index(freq: float) -> int:
    return int(np.searchsorted(AA_FREQ_THRESHOLDS, freq, side="left"))


def table_index_to_max_freq_produced(index: int) -> float:
    return 32.0 * TABLE_AA_SPACING**index


def table_index_to_max_harmonic(index: int) -> int:
    return int(20000.0 / table_index_to_max_freq_produced(index))


class NonAaWavetable:
    """Single-band wavetable (wavetable.rs:77 NonAaWavetable): one cycle of
    ``TABLE_SIZE`` float64 samples, and its diff buffer for one-multiply
    interpolation."""

    def __init__(self, buffer: Optional[np.ndarray] = None):
        self.buffer = (
            np.zeros(TABLE_SIZE, dtype=np.float64)
            if buffer is None
            else np.asarray(buffer, dtype=np.float64).copy()
        )
        if self.buffer.shape != (TABLE_SIZE,):
            raise ValueError(f"wavetable buffers must have {TABLE_SIZE} samples")

    # diff_buffer[i] = buffer[(i+1) % N] - buffer[i]
    def diff_buffer(self) -> np.ndarray:
        return np.roll(self.buffer, -1) - self.buffer

    # ---- builders (wavetable.rs:130-311) ---------------------------------
    @staticmethod
    def sine() -> "NonAaWavetable":
        i = np.arange(TABLE_SIZE, dtype=np.float64)
        return NonAaWavetable(np.sin(i / TABLE_SIZE * 2.0 * np.pi))

    @staticmethod
    def cosine() -> "NonAaWavetable":
        i = np.arange(TABLE_SIZE, dtype=np.float64)
        return NonAaWavetable(np.cos(i / TABLE_SIZE * 2.0 * np.pi))

    @staticmethod
    def aliasing_saw() -> "NonAaWavetable":
        i = np.arange(TABLE_SIZE, dtype=np.float64)
        return NonAaWavetable(-1.0 + (2.0 / TABLE_SIZE) * i)

    @staticmethod
    def hann_window() -> "NonAaWavetable":
        wt = NonAaWavetable()
        wt.fill(0.5)
        wt.add_sine(1.0, 0.5, -0.5 * np.pi)
        return wt

    @staticmethod
    def hamming_window() -> "NonAaWavetable":
        wt = NonAaWavetable()
        wt.fill(0.53836)
        wt.add_sine(1.0, 0.46164, -0.5 * np.pi)
        return wt

    @staticmethod
    def sine_window() -> "NonAaWavetable":
        wt = NonAaWavetable()
        wt.add_sine(0.5, 1.0, 0.0)
        return wt

    def fill(self, value: float) -> None:
        self.buffer[:] = value

    def add_sine(self, freq: float, amplitude: float, phase: float) -> None:
        step = freq * 2.0 * np.pi / TABLE_SIZE
        phases = phase + step * np.arange(TABLE_SIZE, dtype=np.float64)
        self.buffer += np.sin(phases) * amplitude

    def fill_sine(self, num_harmonics: int, freq: float) -> None:
        for n in range(num_harmonics):
            amp = 1.0 if n == 0 else (num_harmonics - n) / num_harmonics * 0.5
            self.add_sine(freq * (n + 1), amp, 0.0)

    def add_saw(self, start_harmonic: int, end_harmonic: int, amp: float) -> None:
        i = np.arange(TABLE_SIZE, dtype=np.float64)
        for h in range(start_harmonic, end_harmonic + 1):
            harmonic_amp = 1.0 / ((h + 1) * np.pi)
            self.buffer += np.sin(i / TABLE_SIZE * 2.0 * np.pi * (h + 1)) * harmonic_amp * amp

    def add_odd_harmonics(self, num_harmonics: int, amp_falloff: float) -> None:
        i = np.arange(TABLE_SIZE, dtype=np.float64)
        for n in range(num_harmonics):
            start_phase = 0.0 if n == 0 else (-1.0) ** (n + 2)
            harmonic_amp = 1.0 / float(n * 2 + 1) ** amp_falloff
            self.buffer += (
                np.sin(i / TABLE_SIZE * 2.0 * np.pi * (n * 2 + 1) + start_phase)
                * harmonic_amp
            )

    def add_noise(self, probability: float, seed: int) -> None:
        from ..utils.xorrng import XOrShift32Rng

        rng = XOrShift32Rng(seed)
        for k in range(TABLE_SIZE):
            if rng.gen_f64() > probability:
                self.buffer[k] += rng.gen_f32() - 0.5
                if self.buffer[k] > 1.0:
                    self.buffer[k] -= 1.0
                if self.buffer[k] < -1.0:
                    self.buffer[k] += 1.0

    def multiply(self, mult: float) -> None:
        self.buffer *= mult


class Wavetable:
    """Anti-aliased wavetable: a mip chain of band-limited partial tables
    (wavetable.rs:390 Wavetable)."""

    def __init__(self):
        self.partial_tables = [NonAaWavetable() for _ in range(NUM_AA_TABLES)]

    # ---- builders ---------------------------------------------------------
    @staticmethod
    def _all(builder: Callable[[], NonAaWavetable]) -> "Wavetable":
        wt = Wavetable()
        wt.partial_tables = [builder() for _ in range(NUM_AA_TABLES)]
        return wt

    @staticmethod
    def sine() -> "Wavetable":
        return Wavetable._all(NonAaWavetable.sine)

    @staticmethod
    def cosine() -> "Wavetable":
        return Wavetable._all(NonAaWavetable.cosine)

    @staticmethod
    def aliasing_saw() -> "Wavetable":
        return Wavetable._all(NonAaWavetable.aliasing_saw)

    @staticmethod
    def hann_window() -> "Wavetable":
        return Wavetable._all(NonAaWavetable.hann_window)

    @staticmethod
    def hamming_window() -> "Wavetable":
        return Wavetable._all(NonAaWavetable.hamming_window)

    @staticmethod
    def sine_window() -> "Wavetable":
        return Wavetable._all(NonAaWavetable.sine_window)

    @staticmethod
    def from_buffer(buffer: np.ndarray) -> "Wavetable":
        wt = Wavetable()
        wt.partial_tables = [NonAaWavetable(buffer) for _ in range(NUM_AA_TABLES)]
        return wt

    @staticmethod
    def from_closure(fn: Callable[[np.ndarray], None]) -> "Wavetable":
        buf = np.zeros(TABLE_SIZE, dtype=np.float64)
        fn(buf)
        return Wavetable.from_buffer(buf)

    @staticmethod
    def saw() -> "Wavetable":
        """Band-limited sawtooth (the idiomatic AA saw: per-table harmonic cap)."""
        wt = Wavetable()
        wt.add_saw(0, 20000 // 32, 1.0)
        wt.normalize()
        return wt

    def fill(self, value: float) -> None:
        for t in self.partial_tables:
            t.fill(value)

    def add_sine(self, freq: float, amplitude: float, phase: float) -> None:
        for i, t in enumerate(self.partial_tables):
            if int(np.ceil(freq)) <= table_index_to_max_harmonic(i):
                t.add_sine(freq, amplitude, phase)

    def fill_sine(self, num_harmonics: int, freq: float) -> None:
        for i, t in enumerate(self.partial_tables):
            t.fill_sine(
                min(num_harmonics, int(table_index_to_max_harmonic(i) * freq)), freq
            )

    def add_aliasing_saw(self, num_harmonics: int, amp: float) -> None:
        for i, t in enumerate(self.partial_tables):
            t.add_saw(0, min(num_harmonics, table_index_to_max_harmonic(i)), amp)

    def add_saw(self, start_harmonic: int, end_harmonic: int, amp: float) -> None:
        for i, t in enumerate(self.partial_tables):
            end = min(end_harmonic, table_index_to_max_harmonic(i))
            if end > start_harmonic:
                t.add_saw(start_harmonic, end, amp)

    def add_odd_harmonics(self, num_harmonics: int, amp_falloff: float) -> None:
        for i, t in enumerate(self.partial_tables):
            t.add_odd_harmonics(
                min(num_harmonics, table_index_to_max_harmonic(i)), amp_falloff
            )

    def multiply(self, mult: float) -> None:
        for t in self.partial_tables:
            t.multiply(mult)

    def normalize(self) -> None:
        loudest = np.abs(self.partial_tables[0].buffer).max()
        if loudest > 0:
            self.multiply(1.0 / loudest)

    # ---- device export -----------------------------------------------------
    def stacked(self, dtype=np.float32):
        """(tables [17, N], diffs [17, N]) as numpy in the sample dtype."""
        tables = np.stack([t.buffer for t in self.partial_tables]).astype(dtype)
        diffs = np.stack(
            [np.roll(t.buffer, -1) - t.buffer for t in self.partial_tables]
        ).astype(dtype)
        return tables, diffs


def harmonics_from_table(table: np.ndarray, n_harmonics: int):
    """Decompose one wavetable cycle into ``n_harmonics`` partials.

    Returns ``(mags f32 [H], offsets u32 [H])`` such that the band-limited
    reconstruction of the table at normalized phase p in [0, 1) is
    ``sum_h mags[h] * sin(2*pi*((h+1)*p + offsets[h]/2**32))``; harmonics
    past the table's Nyquist are zero-padded."""
    table = np.asarray(table, np.float64)
    n = len(table)
    h_max = min(int(n_harmonics), n // 2 - 1)
    spec = np.fft.rfft(table)
    # a*cos(x) + b*sin(x) = m*sin(x + phi), m = hypot(a, b), phi = atan2(a, b)
    a = 2.0 * spec.real[1 : h_max + 1] / n
    b = -2.0 * spec.imag[1 : h_max + 1] / n
    mags = np.hypot(a, b)
    phi = np.arctan2(a, b) / (2.0 * np.pi)  # cycles
    offsets = (np.round(phi * 2.0**32).astype(np.int64) % (1 << 32)).astype(
        np.uint32
    )
    mags = mags.astype(np.float32)
    if h_max < n_harmonics:
        pad = n_harmonics - h_max
        mags = np.concatenate([mags, np.zeros(pad, np.float32)])
        offsets = np.concatenate([offsets, np.zeros(pad, np.uint32)])
    return mags, offsets
