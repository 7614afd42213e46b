"""Port of knaster_tpu/ugens/wavetable.py: the fixed-point phase constants.

The oscillators carry a u32 phase of ``TABLE_SIZE * FRACTIONAL_PART`` units
per cycle (osc.rs semantics); the sine is read at the table index in the
phase's top bits.
"""

TABLE_POWER = 14
TABLE_SIZE = 1 << TABLE_POWER  # 16384
TABLE_HIGH_MASK = TABLE_SIZE - 1
FRACTIONAL_PART = 65536
