"""knaster_tpu_torch — the PyTorch / CUDA port of knaster_tpu.

The JAX package ``knaster_tpu`` is the reference; this package reproduces it
slice by slice on PyTorch, with every Pallas TPU kernel rewritten by hand for
NVIDIA Hopper. It imports no JAX. The slice ported so far is the headline
sine voice bank (``bench.py``'s workload)::

    import torch
    from knaster_tpu_torch import AudioCtx, FusedSineVoiceBank

    ctx = AudioCtx(sample_rate=48000, block_size=64, dtype=torch.float32)
    bank = FusedSineVoiceBank(131072)
    state = bank.init(ctx, device="cuda")
    ev = bank.node_events_from_lists([(0, v, bank.trig_index("t_restart"), 1, 0.0)
                                      for v in range(256)])
    state, out = bank.process(ctx, state, events=ev)    # eventful block
    state, out = bank.process(ctx, state)               # event-free block

Kernels run on CUDA tensors (built with nvcc at first use); CPU tensors take
each kernel's plain torch version.
"""

from .core.ugen import AudioCtx, UGen
from .models.voices import SineVoice
from .parallel.fused_bank import FusedSineVoiceBank
from .parallel.voicebank import VoiceBank
from .primitives import (
    NYQUIST,
    FloatHint,
    IntegerHint,
    Nyquist,
    Param,
    ParameterKind,
    default_dtype,
    enable_f64,
    pbool,
    pfloat,
    pinteger,
    ptrigger,
    set_default_dtype,
)

__all__ = [
    "AudioCtx",
    "UGen",
    "SineVoice",
    "FusedSineVoiceBank",
    "VoiceBank",
    "NYQUIST",
    "FloatHint",
    "IntegerHint",
    "Nyquist",
    "Param",
    "ParameterKind",
    "default_dtype",
    "enable_f64",
    "pbool",
    "pfloat",
    "pinteger",
    "ptrigger",
    "set_default_dtype",
]
