"""Port of knaster_tpu/prelude.py: one import for everything you need to make sound.

Parity with the reference facade's ``knaster::prelude`` / ``preludef32``
(knaster/src/prelude.rs). dtype genericity is a runtime config here
(``enable_f64()``) rather than a type parameter, so one prelude suffices.

    from knaster_tpu_torch.prelude import *

It gives the port's counterpart of every name in the JAX package's prelude,
except that the fused kernel banks take the Pallas banks' place
(``FusedVoiceBank`` and ``KernelVoiceSpec`` for ``PallasVoiceBank`` and
``MosaicVoiceSpec``, ``Fused{Sine,FM,Subtractive,Wavetable}VoiceBank`` for
``Pallas{...}VoiceBank``), and that ``MeshVoiceBank`` and
``ShardedVoiceBank`` wait for the port's multi-device slice. It imports no
JAX.
"""

from . import knaster  # noqa: F401
from .airwindows import Galactic  # noqa: F401
from .backends import AudioBackend, OfflineBackend, StreamBackend  # noqa: F401
from .core.decorator import TRIG, ugen  # noqa: F401
from .core.log import ArLogReceiver, ArLogSender, rt_log  # noqa: F401
from .core.ugen import AudioCtx, UGen, sample_scan  # noqa: F401
from .graph.graph import CircularConnection, Done, Graph, GraphError, NodeFreed  # noqa: F401
from .graph.handles import Handle, Parameter, Source, VoiceParameter  # noqa: F401
from .graph.inspection import (inspect, node_handles,  # noqa: F401
                               show_dot_svg, to_dot)
from .graph.processor import AudioProcessor, AudioProcessorOptions  # noqa: F401
from .graph.scheduling import SchedulingToken, Time  # noqa: F401
from .models.voices import (  # noqa: F401
    AdditiveVoice,
    FMVoice,
    ModalVoice,
    PluckedVoice,
    SamplerVoice,
    SineVoice,
    SubtractiveVoice,
)
from .parallel.fused_bank import (  # noqa: F401
    FusedFMVoiceBank,
    FusedSineVoiceBank,
    FusedSubtractiveVoiceBank,
    FusedWavetableVoiceBank,
)
from .parallel.generic_bank import FusedVoiceBank, KernelVoiceSpec  # noqa: F401
from .parallel.pool import VoicePool  # noqa: F401
from .parallel.voicebank import VoiceBank  # noqa: F401
from .primitives import (  # noqa: F401
    NYQUIST,
    Beats,
    FloatHint,
    IntegerHint,
    Param,
    ParameterKind,
    Seconds,
    Smoothing,
    enable_f64,
    pbool,
    pfloat,
    pinteger,
    ptrigger,
)
from .ugens.buffer import Buffer, BufferReader  # noqa: F401
from .ugens.closure import ClosureUGen, ugen_from_sample_fn  # noqa: F401
from .ugens.convolver import Convolver  # noqa: F401
from .ugens.delay import (  # noqa: F401
    AllpassDelay,
    AllpassFeedbackDelay,
    SampleDelay,
    StaticSampleDelay,
)
from .ugens.dynamics import SafetyLimiter  # noqa: F401
from .ugens.envelopes import EnvAr, EnvAsr, Envelope, EnvelopeSegment, EnvelopeShape  # noqa: F401
from .ugens.filters import OnePoleHpf, OnePoleLpf, SvfFilter, SvfFilterType  # noqa: F401
from .ugens.granular import GrainPlayer  # noqa: F401
from .ugens.math import Math1UGen, MathUGen, add, div, mul, sub  # noqa: F401
from .ugens.modal import ModalResonator  # noqa: F401
from .ugens.noise import BrownNoise, PinkNoise, RandomLin, WhiteNoise  # noqa: F401
from .ugens.osc import OscWt, Phasor, SinNumeric, SinWt  # noqa: F401
from .ugens.pan import Pan2  # noqa: F401
from .ugens.physical import PluckedString  # noqa: F401
from .ugens.polyblep import PolyBlep, Waveform  # noqa: F401
from .ugens.util import Constant, DoneOnTrig, LogProbe  # noqa: F401
from .ugens.wavetable import NonAaWavetable, Wavetable  # noqa: F401
from .utils.codec import read_sound_file, write_flac, write_mp3, write_ogg  # noqa: F401
from .utils.wav import read_wav, write_wav  # noqa: F401
