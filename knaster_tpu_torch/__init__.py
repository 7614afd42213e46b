"""knaster_tpu_torch — the PyTorch / CUDA port of knaster_tpu.

The JAX package ``knaster_tpu`` is the reference; this package reproduces it
slice by slice on PyTorch, with every Pallas TPU kernel rewritten by hand for
NVIDIA Hopper. It imports no JAX. Ported so far: the graph (edit, compile,
render, event-free runs as superblocks) with the UGens of the README
example and of the param sweep (``SinNumeric``, ``Phasor``), the
subtractive voice's (``PolyBlep``, ``SvfFilter``, the one-poles,
``EnvAsr``/``EnvAr``, ``Pan2``), the FDN reverb's (the noises, the delays,
``Galactic``) and the FM cascade, the multi-segment ``Envelope``,
``ModalResonator`` and the Karplus-Strong ``PluckedString``, the voice
models, the composable ``VoiceBank`` (any voice, run once over the voice
axis) and the fused voice banks; every bank is a graph node (per-voice
control through ``Handle.voice_param``, allocation through ``VoicePool``),
and ``MeshVoiceBank`` and ``ShardedVoiceBank`` shard any bank over a list
of devices (``make_mesh``) in one process.
Recorded audio: ``Buffer`` (``Buffer.from_sound_file``: wav, ogg, flac,
mp3 through ``utils/codec.py``), ``BufferReader``, ``SamplerVoice``,
``GrainPlayer`` and ``Convolver``. The live path: ``StreamBackend`` (a
graph edited while it plays, over the native ring of
``backends/native.py``, with async recompile), ``OfflineBackend``,
``LogProbe`` and ``rt_log`` (``core/log.py``), ``inspect``/``to_dot`` and
``AudioProcessor.save_state``/``load_state``. The user's side: the
``@ugen`` decorator (``ugen``, ``ugen.sample``, ``TRIG``), ``ClosureUGen``
and ``ugen_from_sample_fn``, ``sample_scan``, the wrappers
(``knaster_tpu_torch.wrappers``: ``WrMul`` ... ``WrClosure``,
``WrArParamToInput``; ``UGen.wr_mul`` ... ``UGen.wr``), ``OscWt`` over the
anti-aliased ``Wavetable``, ``SafetyLimiter``, ``DoneOnTrig``, user voices
whose ``KernelVoiceSpec`` carries CUDA source for ``FusedVoiceBank``, and
``knaster_tpu_torch.prelude`` (``from knaster_tpu_torch.prelude import *``).
The README example::

    import knaster_tpu_torch as kt

    graph, proc = kt.knaster(outputs=2)       # on the card; device="cpu" for the CPU
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
``FusedWavetableVoiceBank(V, table=...)``, ``FusedVoiceBank(FMVoice(), V)``,
``FusedVoiceBank(EnvelopeVoice(), V)``, ``FusedVoiceBank(ModalVoice(), V)``).
Kernels run on CUDA tensors (built with nvcc at first use); CPU tensors take
each kernel's plain torch version. Graphs render on the card unless the
caller passes ``device="cpu"``, and raise where there is no card; a bank's
state lies on the device its ``init`` is given.
"""

from .airwindows.galactic import Galactic
from .backends import AudioBackend, OfflineBackend, StreamBackend
from .core.decorator import TRIG, ugen
from .core.log import ArLogReceiver, ArLogSender, rt_log
from .core.ugen import AudioCtx, UGen, sample_scan
from .graph.graph import CircularConnection, Done, Graph, GraphError, NodeFreed
from .graph.handles import Handle, Parameter, Source, VoiceParameter
from .graph.inspection import inspect, node_handles, to_dot
from .graph.processor import AudioProcessor, AudioProcessorOptions
from .graph.scheduling import SchedulingToken, Time
from .models.voices import (AdditiveVoice, EnvelopeVoice, FMCascade, FMVoice,
                            ModalVoice, PluckedVoice, SamplerVoice, SineVoice,
                            SubtractiveVoice)
from .parallel.fused_bank import (
    FusedBank,
    FusedFMVoiceBank,
    FusedSineVoiceBank,
    FusedSubtractiveVoiceBank,
    FusedWavetableVoiceBank,
)
from .parallel.generic_bank import FusedVoiceBank, KernelVoiceSpec
from .parallel.mesh import MeshVoiceBank, ShardedVoiceBank, make_mesh
from .parallel.pool import VoicePool
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
from .ugens.buffer import Buffer, BufferReader
from .ugens.closure import ClosureUGen, ugen_from_sample_fn
from .ugens.convolver import Convolver
from .ugens.delay import AllpassDelay, AllpassFeedbackDelay, SampleDelay, StaticSampleDelay
from .ugens.dynamics import SafetyLimiter
from .ugens.envelopes import EnvAr, EnvAsr, Envelope, EnvelopeSegment, EnvelopeShape
from .ugens.filters import OnePoleHpf, OnePoleLpf, SvfFilter, SvfFilterType
from .ugens.math import Math1UGen, MathUGen
from .ugens.granular import GrainPlayer
from .ugens.modal import ModalResonator
from .ugens.noise import (BrownNoise, PinkNoise, RandomLin, WhiteNoise,
                          next_randomness_seed, reset_randomness_seeds)
from .ugens.osc import OscWt, Phasor, SinNumeric, SinWt
from .ugens.pan import Pan2
from .ugens.physical import PluckedString
from .ugens.polyblep import PolyBlep, Waveform
from .ugens.util import Constant, DoneOnTrig, LogProbe
from .ugens.wavetable import NonAaWavetable, Wavetable, harmonics_from_table
from .utils.codec import read_sound_file, write_flac, write_mp3, write_ogg

__all__ = [
    "knaster",
    "AudioCtx",
    "UGen",
    "sample_scan",
    "ugen",
    "TRIG",
    "ClosureUGen",
    "ugen_from_sample_fn",
    "AudioProcessor",
    "AudioProcessorOptions",
    "Graph",
    "GraphError",
    "CircularConnection",
    "NodeFreed",
    "Done",
    "Handle",
    "Parameter",
    "VoiceParameter",
    "Source",
    "SchedulingToken",
    "Time",
    "SinWt",
    "OscWt",
    "SinNumeric",
    "Phasor",
    "Constant",
    "DoneOnTrig",
    "SafetyLimiter",
    "LogProbe",
    "rt_log",
    "ArLogReceiver",
    "ArLogSender",
    "AudioBackend",
    "OfflineBackend",
    "StreamBackend",
    "inspect",
    "node_handles",
    "to_dot",
    "MathUGen",
    "Math1UGen",
    "PolyBlep",
    "Waveform",
    "SvfFilter",
    "SvfFilterType",
    "OnePoleLpf",
    "OnePoleHpf",
    "EnvAsr",
    "EnvAr",
    "Envelope",
    "EnvelopeSegment",
    "EnvelopeShape",
    "ModalResonator",
    "Pan2",
    "WhiteNoise",
    "PinkNoise",
    "BrownNoise",
    "RandomLin",
    "next_randomness_seed",
    "reset_randomness_seeds",
    "SampleDelay",
    "AllpassDelay",
    "AllpassFeedbackDelay",
    "StaticSampleDelay",
    "Galactic",
    "Buffer",
    "BufferReader",
    "SamplerVoice",
    "GrainPlayer",
    "Convolver",
    "read_sound_file",
    "write_flac",
    "write_mp3",
    "write_ogg",
    "FMCascade",
    "Beats",
    "Seconds",
    "Smoothing",
    "SineVoice",
    "FMVoice",
    "SubtractiveVoice",
    "AdditiveVoice",
    "EnvelopeVoice",
    "ModalVoice",
    "PluckedVoice",
    "PluckedString",
    "VoicePool",
    "FusedBank",
    "FusedSineVoiceBank",
    "FusedFMVoiceBank",
    "FusedSubtractiveVoiceBank",
    "FusedWavetableVoiceBank",
    "FusedVoiceBank",
    "KernelVoiceSpec",
    "MeshVoiceBank",
    "ShardedVoiceBank",
    "make_mesh",
    "NonAaWavetable",
    "Wavetable",
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
            device="cuda", dtype=None):
    """One-liner entry point (reference knaster/src/lib.rs:79 ``knaster()``):
    a ``(graph, processor)`` pair ready for offline rendering on ``device``:
    the card unless the caller passes ``device="cpu"``; raises where there
    is no card."""
    opts = AudioProcessorOptions(block_size=block_size, sample_rate=sample_rate)
    return AudioProcessor.new(inputs=0, outputs=outputs, options=opts, dtype=dtype,
                              device=device)
