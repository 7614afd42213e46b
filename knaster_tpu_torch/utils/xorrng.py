"""Port of knaster_tpu/utils/xorrng.py: XOrShift32, a tiny repeatable PRNG for host-side table building.

A copy of the JAX package's module (itself an exact port of
knaster_core_dsp/src/dsp/xorrng.rs, a public-domain algorithm), kept here so
that the port imports nothing of the JAX package. It runs on the host only:
``NonAaWavetable.add_noise`` draws from it. Device-side noise uses the
counter-based generator of ``ugens/noise.py``.
"""

from __future__ import annotations

import numpy as np


class XOrShift32Rng:
    def __init__(self, seed: int = 17):
        seed = int(seed) & 0xFFFFFFFF
        self.fpd = seed if seed != 0 else 17

    def gen_u32(self) -> int:
        x = self.fpd
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        self.fpd = x & 0xFFFFFFFF
        return self.fpd

    def gen_f32(self) -> float:
        return float(np.float32(self.gen_u32()) / np.float32(0xFFFFFFFF))

    def gen_f64(self) -> float:
        return self.gen_u32() / 0xFFFFFFFF
