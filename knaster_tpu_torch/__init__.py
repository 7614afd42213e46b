"""knaster_tpu_torch — the PyTorch / CUDA port of knaster_tpu.

The JAX package ``knaster_tpu`` is the reference; this package reproduces it
slice by slice on PyTorch, with every Pallas TPU kernel rewritten by hand for
NVIDIA Hopper. It imports no JAX. The slices ported so far are the fused
voice banks: the headline sine bank (``bench.py``'s workload), the FM,
subtractive and wavetable banks, and the generic ``FusedVoiceBank`` for
any voice with a kernel body::

    import torch
    from knaster_tpu_torch import AudioCtx, FusedSineVoiceBank

    ctx = AudioCtx(sample_rate=48000, block_size=64, dtype=torch.float32)
    bank = FusedSineVoiceBank(131072)
    state = bank.init(ctx, device="cuda")
    ev = bank.node_events_from_lists([(0, v, bank.trig_index("t_restart"), 1, 0.0)
                                      for v in range(256)])
    state, out = bank.process(ctx, state, events=ev)    # eventful block
    state, out = bank.process(ctx, state)               # event-free block

The other banks are used alike (``FusedFMVoiceBank``,
``FusedSubtractiveVoiceBank``, ``FusedWavetableVoiceBank(V, table=...)``,
``FusedVoiceBank(FMVoice(), V)``). Kernels run on CUDA tensors (built with
nvcc at first use); CPU tensors take each kernel's plain torch version.
"""

from .core.ugen import AudioCtx, UGen
from .models.voices import AdditiveVoice, FMVoice, SineVoice, SubtractiveVoice
from .parallel.fused_bank import (
    FusedBank,
    FusedFMVoiceBank,
    FusedSineVoiceBank,
    FusedSubtractiveVoiceBank,
    FusedWavetableVoiceBank,
)
from .parallel.generic_bank import FusedVoiceBank, KernelVoiceSpec
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
from .ugens.wavetable import NonAaWavetable, harmonics_from_table

__all__ = [
    "AudioCtx",
    "UGen",
    "SineVoice",
    "FMVoice",
    "SubtractiveVoice",
    "AdditiveVoice",
    "FusedBank",
    "FusedSineVoiceBank",
    "FusedFMVoiceBank",
    "FusedSubtractiveVoiceBank",
    "FusedWavetableVoiceBank",
    "FusedVoiceBank",
    "KernelVoiceSpec",
    "NonAaWavetable",
    "harmonics_from_table",
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
