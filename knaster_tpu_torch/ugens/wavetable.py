"""Port of knaster_tpu/ugens/wavetable.py: phase constants and table decomposition.

The oscillators carry a u32 phase of ``TABLE_SIZE * FRACTIONAL_PART`` units
per cycle (osc.rs semantics); the sine is read at the table index in the
phase's top bits. ``NonAaWavetable`` builds one table cycle on the host
(float64, as the reference does) and ``harmonics_from_table`` decomposes it
into the partials the additive wavetable bank re-synthesizes. Both are numpy
only, copied so that the port needs no JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

TABLE_POWER = 14
TABLE_SIZE = 1 << TABLE_POWER  # 16384
TABLE_HIGH_MASK = TABLE_SIZE - 1
FRACTIONAL_PART = 65536


class NonAaWavetable:
    """Single-band wavetable (wavetable.rs:77 NonAaWavetable): one cycle of
    ``TABLE_SIZE`` float64 samples."""

    def __init__(self, buffer: Optional[np.ndarray] = None):
        self.buffer = (
            np.zeros(TABLE_SIZE, dtype=np.float64)
            if buffer is None
            else np.asarray(buffer, dtype=np.float64).copy()
        )
        if self.buffer.shape != (TABLE_SIZE,):
            raise ValueError(f"wavetable buffers must have {TABLE_SIZE} samples")

    @staticmethod
    def sine() -> "NonAaWavetable":
        i = np.arange(TABLE_SIZE, dtype=np.float64)
        return NonAaWavetable(np.sin(i / TABLE_SIZE * 2.0 * np.pi))

    def add_sine(self, freq: float, amplitude: float, phase: float) -> None:
        step = freq * 2.0 * np.pi / TABLE_SIZE
        phases = phase + step * np.arange(TABLE_SIZE, dtype=np.float64)
        self.buffer += np.sin(phases) * amplitude

    def add_saw(self, start_harmonic: int, end_harmonic: int, amp: float) -> None:
        i = np.arange(TABLE_SIZE, dtype=np.float64)
        for h in range(start_harmonic, end_harmonic + 1):
            harmonic_amp = 1.0 / ((h + 1) * np.pi)
            self.buffer += np.sin(i / TABLE_SIZE * 2.0 * np.pi * (h + 1)) * harmonic_amp * amp


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
