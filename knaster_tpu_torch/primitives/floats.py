"""Port of knaster_tpu/primitives/floats.py: the f32/f64 sample-type policy.

The reference is generic over ``F: Float`` (knaster_primitives/src/float.rs:11).
Here that genericity is a torch dtype carried by ``AudioCtx``. f32 is the
default; ``enable_f64()`` switches the default to f64. The fused sine bank
takes f32 only for now.
"""

from __future__ import annotations

import torch

_DEFAULT_DTYPE = torch.float32


def default_dtype() -> torch.dtype:
    """The engine-wide sample dtype (float32 unless ``enable_f64()``)."""
    return _DEFAULT_DTYPE


def set_default_dtype(dtype: torch.dtype) -> None:
    global _DEFAULT_DTYPE
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("knaster_tpu_torch supports float32 and float64 sample types")
    _DEFAULT_DTYPE = dtype


def enable_f64() -> None:
    """Switch the default sample dtype to float64."""
    set_default_dtype(torch.float64)
