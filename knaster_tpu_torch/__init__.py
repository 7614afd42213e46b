"""knaster_tpu_torch — the PyTorch / CUDA port of knaster_tpu.

The JAX package ``knaster_tpu`` is the reference; this package reproduces it
slice by slice on PyTorch, with every Pallas TPU kernel rewritten by hand for
NVIDIA Hopper. It imports no JAX. Ported so far: the graph (edit, compile,
render) with the UGens of the README example and the FM cascade, and the
fused voice banks. The README example::

    import knaster_tpu_torch as kt

    graph, proc = kt.knaster(outputs=2, device="cuda")   # default "cpu"
    def build(g):
        sine = g.push(kt.SinWt(440.0))
        amp = g.push(kt.Constant(0.2))
        (sine * amp).out([0, 0]).to_graph_out()
        return sine.param("freq"), amp.param("value")
    freq, amp = graph.edit(build)
    amp.smooth(kt.Smoothing.linear(0.1))
    freq.set_at(880.0, kt.Seconds.from_secs_f64(1.0))
    audio = proc.render(seconds=2.0)                      # numpy [2, 96000]

The banks run through their own API::

    ctx = kt.AudioCtx(sample_rate=48000, block_size=64, dtype=torch.float32)
    bank = kt.FusedSineVoiceBank(131072)
    state = bank.init(ctx, device="cuda")
    state, out = bank.process(ctx, state)               # event-free block

(also ``FusedFMVoiceBank``, ``FusedSubtractiveVoiceBank``,
``FusedWavetableVoiceBank(V, table=...)``, ``FusedVoiceBank(FMVoice(), V)``).
Kernels run on CUDA tensors (built with nvcc at first use); CPU tensors take
each kernel's plain torch version. The device is always the caller's:
nothing picks one.
"""

from .core.ugen import AudioCtx, UGen
from .graph.graph import CircularConnection, Done, Graph, GraphError, NodeFreed
from .graph.handles import Handle, Parameter, Source
from .graph.processor import AudioProcessor, AudioProcessorOptions
from .graph.scheduling import SchedulingToken, Time
from .models.voices import (AdditiveVoice, FMCascade, FMVoice, SineVoice,
                            SubtractiveVoice)
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
    Beats,
    FloatHint,
    IntegerHint,
    Nyquist,
    Param,
    ParameterKind,
    Seconds,
    Smoothing,
    default_dtype,
    enable_f64,
    pbool,
    pfloat,
    pinteger,
    ptrigger,
    set_default_dtype,
)
from .ugens.math import Math1UGen, MathUGen
from .ugens.osc import SinWt
from .ugens.util import Constant
from .ugens.wavetable import NonAaWavetable, harmonics_from_table

__all__ = [
    "knaster",
    "AudioCtx",
    "UGen",
    "AudioProcessor",
    "AudioProcessorOptions",
    "Graph",
    "GraphError",
    "CircularConnection",
    "NodeFreed",
    "Done",
    "Handle",
    "Parameter",
    "Source",
    "SchedulingToken",
    "Time",
    "SinWt",
    "Constant",
    "MathUGen",
    "Math1UGen",
    "FMCascade",
    "Beats",
    "Seconds",
    "Smoothing",
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


def knaster(outputs: int = 2, sample_rate: int = 48000, block_size: int = 64,
            device="cpu", dtype=None):
    """One-liner entry point (reference knaster/src/lib.rs:79 ``knaster()``):
    a ``(graph, processor)`` pair ready for offline rendering on ``device``
    ("cpu" unless the caller names another)."""
    opts = AudioProcessorOptions(block_size=block_size, sample_rate=sample_rate)
    return AudioProcessor.new(inputs=0, outputs=outputs, options=opts, dtype=dtype,
                              device=device)
