"""Port of knaster_tpu/ugens: the unit generators of the ported slices.

The names below resolve at first access: the kernel
modules import ``ugens.wavetable``, and the UGens import the kernel
modules, so this package imports none of its modules up front.
"""

import importlib

_EXPORTS = {
    "WhiteNoise": "noise", "PinkNoise": "noise", "BrownNoise": "noise",
    "RandomLin": "noise", "next_randomness_seed": "noise",
    "reset_randomness_seeds": "noise", "SampleDelay": "delay", "AllpassDelay": "delay",
    "AllpassFeedbackDelay": "delay", "StaticSampleDelay": "delay",
    "Buffer": "buffer", "BufferReader": "buffer", "GrainPlayer": "granular",
    "Convolver": "convolver",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
