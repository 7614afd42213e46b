"""User voices for the port's generic ``FusedVoiceBank``: torch bodies, and hand-written CUDA bodies beside two of them.

A voice that is not in the library reaches the fused kernel path by
returning a ``KernelVoiceSpec`` from ``kernel_voice(ctx)`` with a torch body
over ``[V]`` tensors (what the bank runs on CPU tensors). On the card that
body is lowered to CUDA at the bank's first launch
(``knaster_tpu_torch/kernels/lower.py``), as ``PallasVoiceBank`` traces a
``mosaic_voice`` body; or the voice brings the same math written by hand
as ``cuda_source``, CUDA C++ that defines ``struct VoiceBody`` in the
harness's body contract (``knaster_tpu_torch/csrc/generic_harness.cuh``).
Either is compiled into a library of its own, and keeps the torch body's
association op for op, so that it (built with --fmad=false) carries its
state bit-equal to the torch body.

* ``DetunedVoice`` — two detuned table-quantized sines and an AR envelope,
  mono (the user voice of tests/test_generic_bank.py:128-200).
* ``OrganVoice`` — three drawbar harmonics, an AR envelope and an exact
  equal-power pan, stereo (examples/custom_voice_bank.py:29-122).

Each brings its hand source (``DETUNED_SOURCE``, ``ORGAN_SOURCE``, the
yardstick beside the lowered bodies). ``torch_only(voice)`` drops a voice's
CUDA body, hand source or library body alike: then the card runs its
lowered torch body, as the JAX example's organ reaches the TPU from its
Python body alone (``torch_only(ModalVoice(...))`` lowers the Modal body at
any mode count, the yardstick against the library ``modal<M>`` bodies).

``chip_smoke.py`` and the CPU tests both import this module, so the bodies
they hold against each other cannot drift apart. Each class's params and
defaults are those of the JAX package's voice of the same name.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from knaster_tpu_torch.core.ugen import UGen
from knaster_tpu_torch.kernels.bank_common import (_HALF_PI, _env_ar, _sin_quant,
                                                   _to_inc, u32_add)
from knaster_tpu_torch.parallel.generic_bank import KernelVoiceSpec
from knaster_tpu_torch.primitives.params import pfloat, ptrigger
from knaster_tpu_torch.primitives.time import Seconds
from knaster_tpu_torch.ugens.wavetable import FRACTIONAL_PART, TABLE_SIZE


def _f2pi(sample_rate):
    """u32 phase units per Hz."""
    return np.float32(TABLE_SIZE * FRACTIONAL_PART / sample_rate)


def _rate(seconds, sample_rate):
    """Per-sample envelope increment, rounded as the JAX voices round it."""
    return np.float32(1.0 / max(seconds * sample_rate, 1.0))


# params freq, detune, amp; t_restart; carry p1, p2, stage, t
DETUNED_SOURCE = r"""
struct VoiceBody : NoTable, NoHoist, FourCtas {
  static constexpr int NF = 3, NT = 1, NC = 4, C = 1, kPan = -1;
  struct Consts {
    float f2pi, atk, rel;
  };
  __device__ VoiceBody(const Consts&, const float4*, const float*) {}
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = __uint_as_float(c[2]), t = __uint_as_float(c[3]);
    const float env = env_ar(stage, t, trig[0], k.atk, k.rel);
    const float freq = p(0);
    const float s1 = sin_quant(c[0]);
    const float s2 = sin_quant(c[1]);
    c[0] += to_inc(freq * k.f2pi);
    c[1] += to_inc(freq * p(1) * k.f2pi);
    out[0] = (s1 + s2) * env * p(2);
    c[2] = __float_as_uint(stage);
    c[3] = __float_as_uint(t);
  }
};
"""

# params freq, amp, bar2, bar3, pan; t_restart; carry p1, p2, p3, stage, t;
# the harness applies the exact pan gains (ExactPan) of param 4
ORGAN_SOURCE = r"""
struct VoiceBody : ExactPan, NoTable, NoHoist, FourCtas {
  static constexpr int NF = 5, NT = 1, NC = 5, C = 2, kPan = 4;
  struct Consts {
    float f2pi, atk, rel;
  };
  __device__ VoiceBody(const Consts&, const float4*, const float*) {}
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = __uint_as_float(c[3]), t = __uint_as_float(c[4]);
    const float env = env_ar(stage, t, trig[0], k.atk, k.rel);
    const float freq = p(0);
    out[0] = (sin_quant(c[0]) + p(2) * sin_quant(c[1]) + p(3) * sin_quant(c[2])) *
             (env * p(1));
    c[0] += to_inc(freq * k.f2pi);
    c[1] += to_inc(freq * 2.0f * k.f2pi);
    c[2] += to_inc(freq * 3.0f * k.f2pi);
    c[3] = __float_as_uint(stage);
    c[4] = __float_as_uint(t);
  }
};
"""


def _stage_idle(carry):
    return carry["stage"] == 0.0


class DetunedVoice(UGen):
    """Two detuned sines and an AR envelope (tests/test_generic_bank.py's
    user voice), with ``DETUNED_SOURCE`` as its CUDA body."""

    inputs = 0
    outputs = 1
    params = (
        pfloat("freq", 330.0),
        pfloat("detune", 1.003),
        pfloat("amp", 0.02),
        ptrigger("t_restart"),
    )

    def __init__(self, attack=0.004, release=0.2):
        self.pdefaults = {"freq": 330.0, "detune": 1.003, "amp": 0.02}
        self.attack, self.release = float(attack), float(release)

    def kernel_voice(self, ctx):
        f2pi = _f2pi(ctx.sample_rate)
        atk, rel = _rate(self.attack, ctx.sample_rate), _rate(self.release, ctx.sample_rate)

        def body(i_f, c, P, T):
            env, stage, t = _env_ar(c["stage"], c["t"], T["t_restart"], atk, rel)
            freq = P["freq"]
            s1, s2 = _sin_quant(c["p1"]), _sin_quant(c["p2"])
            p1 = u32_add(c["p1"], _to_inc(freq * f2pi))
            p2 = u32_add(c["p2"], _to_inc(freq * P["detune"] * f2pi))
            new = {"p1": p1, "p2": p2, "stage": stage, "t": t}
            return new, ((s1 + s2) * env * P["amp"],)

        return KernelVoiceSpec(
            carry={"p1": ("u32", 0), "p2": ("u32", 0), "stage": ("f32", 0.0),
                   "t": ("f32", 0.0)},
            body=body, idle_of=_stage_idle, cuda_source=DETUNED_SOURCE,
            consts=np.array([f2pi, atk, rel], np.float32), voice_name=self.name())


class OrganVoice(UGen):
    """Three-drawbar organ voice: fundamental, 2nd and 3rd harmonic, AR
    envelope, equal-power pan (examples/custom_voice_bank.py), with
    ``ORGAN_SOURCE`` as its CUDA body."""

    inputs = 0
    outputs = 2
    params = (
        pfloat("freq", 220.0),
        pfloat("amp", 0.02),
        pfloat("bar2", 0.5),   # 2nd-harmonic drawbar
        pfloat("bar3", 0.25),  # 3rd-harmonic drawbar
        pfloat("pan", 0.0),
        ptrigger("t_restart"),
    )

    def __init__(self, attack: float = 0.02, release: float = 1.2):
        self.pdefaults = {"freq": 220.0, "amp": 0.02, "bar2": 0.5,
                          "bar3": 0.25, "pan": 0.0}
        self.attack, self.release = float(attack), float(release)

    def kernel_voice(self, ctx):
        f2pi = _f2pi(ctx.sample_rate)
        atk, rel = _rate(self.attack, ctx.sample_rate), _rate(self.release, ctx.sample_rate)
        half, two, three = np.float32(0.5), np.float32(2.0), np.float32(3.0)

        def body(i_f, c, P, T):
            env, stage, t = _env_ar(c["stage"], c["t"], T["t_restart"], atk, rel)
            freq = P["freq"]
            sig = (_sin_quant(c["p1"])
                   + P["bar2"] * _sin_quant(c["p2"])
                   + P["bar3"] * _sin_quant(c["p3"])) * (env * P["amp"])
            new = {
                "p1": u32_add(c["p1"], _to_inc(freq * f2pi)),
                "p2": u32_add(c["p2"], _to_inc(freq * two * f2pi)),
                "p3": u32_add(c["p3"], _to_inc(freq * three * f2pi)),
                "stage": stage, "t": t,
            }
            angle = (P["pan"] * half + half) * _HALF_PI
            return new, (sig * torch.cos(angle), sig * torch.sin(angle))

        return KernelVoiceSpec(
            carry={"p1": ("u32", 0), "p2": ("u32", 0), "p3": ("u32", 0),
                   "stage": ("f32", 0.0), "t": ("f32", 0.0)},
            body=body, idle_of=_stage_idle, cuda_source=ORGAN_SOURCE,
            consts=np.array([f2pi, atk, rel], np.float32), voice_name=self.name())


def torch_only(voice):
    """``voice`` (the same object) with no CUDA body of its own: its spec
    names no library body and brings no source, so on the card its torch
    body is lowered (knaster_tpu_torch/kernels/lower.py)."""
    voice.kernel_voice = functools.partial(_torch_only_spec, type(voice).kernel_voice, voice)
    return voice


def _torch_only_spec(kernel_voice, voice, ctx):
    return dataclasses.replace(kernel_voice(voice, ctx), cuda_body=None, cuda_source=None)


# examples/custom_voice_bank.py's bank and score
ORGAN_VOICES = 512
ORGAN_CHORDS = ([0, 4, 7, 11], [0, 3, 7, 10], [0, 5, 7, 10], [0, 4, 9, 14])


def organ_defaults(n=ORGAN_VOICES, seed=7):
    """The example's per-voice defaults (``default_rng(7)``)."""
    rng = np.random.default_rng(seed)
    return {
        "freq": rng.uniform(110, 880, n).astype(np.float32),
        "amp": np.full(n, 0.003, np.float32),
        "bar2": rng.uniform(0.2, 0.8, n).astype(np.float32),
        "bar3": rng.uniform(0.0, 0.5, n).astype(np.float32),
        "pan": rng.uniform(-0.9, 0.9, n).astype(np.float32),
    }


def organ_score(bank, seconds, seconds_per_chord, n=ORGAN_VOICES):
    """The example's evolving chord wash on a bank handle: at each chord
    change every voice is retuned to a chord tone and restarted. The
    example spaces its four chords over its 10 s; ``seconds_per_chord``
    sets their spacing (chords past ``seconds`` are dropped)."""
    restart = bank.voice_param("t_restart")
    freq = bank.voice_param("freq")
    for ci, chord in enumerate(ORGAN_CHORDS):
        at = ci * seconds_per_chord
        if at >= seconds:
            break
        t = Seconds.from_secs_f64(at)
        for v in range(n):
            semitone = chord[v % len(chord)] + 12 * ((v // len(chord)) % 3)
            freq.set_at(v, 110.0 * 2.0 ** (semitone / 12.0), t)
            restart.trig_at(v, t)
