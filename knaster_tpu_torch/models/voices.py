"""Port of knaster_tpu/models/voices.py: the library's voice models.

* ``SineVoice`` — the reference's ``many_sines`` voice
  (knaster/examples/many_sines.rs: EnvAr * (SinWt.wr_mul(amp)) >> Pan2).
* ``FMVoice`` — 2-operator FM with an AR envelope (the fm_bench family).
* ``SubtractiveVoice`` — polyBLEP saw -> SVF lowpass -> ASR envelope.
* ``AdditiveVoice`` — a wavetable cycle re-synthesized from its harmonics.
* ``EnvelopeVoice`` — a sine gated by a multi-segment ``Envelope``.
* ``ModalVoice`` — a struck ``ModalResonator`` (EnvAr mallet, Pan2).
* ``PluckedVoice`` — a Karplus-Strong string with a built-in noise burst.
* ``SamplerVoice`` — sample playback from a shared buffer (gather read).
* ``FMCascade`` — an N-stage FM cascade as one graph node, with its own
  kernel (``kernels/fm_cascade.py``).

Each voice has two faces, as in the JAX package. ``init``/``process`` is
the voice composed from the library's UGens, the path ``VoiceBank`` runs
(over leading ``[V]`` axes: the port's UGens take batch axes, so the bank
calls it once for all voices). ``kernel_voice(ctx)`` is the per-sample body
the generic ``FusedVoiceBank`` runs, in torch over ``[V]`` tensors (the
plain version) and by name as a CUDA body; each body is the math of its
``mosaic_voice`` in the JAX package, op for op. The voices' parameter
tables, defaults and envelope times are what the fused banks read.
``PluckedVoice`` and ``SamplerVoice`` have no kernel body.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dsp import cumsum_base16
from ..core.ugen import AudioCtx, UGen, normalize_process_result
from ..kernels.bank_common import (
    _HALF_PI, ENV_SEG_FINISHED, _blep, _env_ar, _env_asr, _exp_poly,
    _make_env_multiseg, _sin_poly, _sin_quant, _sincos_halfturn,
    _svf_low_coeffs, _theta_full, _to_inc, env_present_shapes, i32_of, u32_add,
    u32_of,
)
from ..primitives.params import ParameterKind, pfloat, pinteger, ptrigger
from ..ugens.buffer import Buffer
from ..ugens.envelopes import STOPPED, EnvAr, EnvAsr, Envelope
from ..ugens.filters import SvfFilter, SvfFilterType
from ..ugens.modal import _LN10_M3, ModalResonator
from ..ugens.osc import SinWt, scalar_of
from ..ugens.pan import Pan2
from ..ugens.polyblep import PolyBlep, Waveform
from ..ugens.wavetable import FRACTIONAL_PART, TABLE_SIZE, harmonics_from_table


def _rate(seconds, sample_rate):
    """Per-sample envelope increment, as the JAX package rounds it."""
    return np.float32(1.0 / max(seconds * sample_rate, 1.0))


def _f2pi(ctx: AudioCtx):
    """u32 phase units per Hz at the context's sample rate."""
    return np.float32(TABLE_SIZE * FRACTIONAL_PART / ctx.sample_rate)


def _stage_idle(carry):
    return carry["stage"] == 0.0


def _run(ugen, ctx: AudioCtx, state, inputs, params):
    """One UGen's block inside a voice: (state, out, done)."""
    return normalize_process_result(ugen.process(ctx, state, inputs, params), ctx)


def _no_input(ctx: AudioCtx, like):
    """A generator's empty ``[..., 0, B]`` input, shaped like the params."""
    return like.new_zeros(like.shape[:-1] + (0, ctx.block_size))


def _osc_params(freq):
    """A SinWt's params inside a voice: ``freq``, no offset, no resets."""
    return {"freq": freq, "phase_offset": torch.zeros_like(freq),
            "reset_phase": torch.zeros(freq.shape, dtype=torch.bool, device=freq.device)}


def _times(like, attack, release):
    """An envelope's constant attack and release rows."""
    return (torch.full(like.shape, attack, dtype=like.dtype, device=like.device),
            torch.full(like.shape, release, dtype=like.dtype, device=like.device))


class SineVoice(UGen):
    """Enveloped, panned sine voice (many_sines.rs parity)."""

    inputs = 0
    outputs = 2
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("amp", 0.0125),
        pfloat("pan", 0.0),
        ptrigger("t_restart"),
        ptrigger("t_release"),
    )

    def __init__(self, freq: float = 440.0, amp: float = 0.0125, pan: float = 0.0,
                 attack: float = 0.01, release: float = 0.1):
        self.pdefaults = {"freq": float(freq), "amp": float(amp), "pan": float(pan)}
        self.attack = float(attack)
        self.release = float(release)
        self.osc = SinWt(freq)
        self.env = EnvAsr(attack, release, scan=cumsum_base16)
        self.panner = Pan2(pan)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"osc": self.osc.init(ctx, device), "env": self.env.init(ctx, device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        """SinWt * EnvAsr * amp, then Pan2 (voices.py:54-85)."""
        freq = params["freq"]
        no_in = _no_input(ctx, freq)
        osc_state, osc_out, _ = _run(self.osc, ctx, state["osc"], no_in, _osc_params(freq))
        atk, rel = _times(freq, self.attack, self.release)
        env_state, env_out, done = _run(
            self.env, ctx, state["env"], no_in,
            {"attack_time": atk, "release_time": rel,
             "t_restart": params["t_restart"], "t_release": params["t_release"]})
        sig = osc_out * env_out * params["amp"].unsqueeze(-2)
        _, out = self.panner.process(ctx, {}, sig, {"pan": params["pan"]})
        return {"osc": osc_state, "env": env_state}, out, done

    def kernel_voice(self, ctx: AudioCtx):
        """SinWt's u32 phase and table-quantized sine, EnvAsr, and exact
        equal-power pan (cos/sin of the materialized pan every sample)."""
        from ..parallel.generic_bank import KernelVoiceSpec

        f2pi = _f2pi(ctx)
        atk, rel = _rate(self.attack, ctx.sample_rate), _rate(self.release, ctx.sample_rate)
        half = np.float32(0.5)

        def body(i_f, c, P, T):
            env, stage, t, rscale = _env_asr(c["stage"], c["t"], c["rscale"],
                                             T["t_restart"], T["t_release"],
                                             atk, rel)
            sig = _sin_quant(c["phase"]) * (env * P["amp"])
            phase = u32_add(c["phase"], _to_inc(P["freq"] * f2pi))
            angle = (P["pan"] * half + half) * _HALF_PI
            new = {"phase": phase, "stage": stage, "t": t, "rscale": rscale}
            return new, (sig * torch.cos(angle), sig * torch.sin(angle))

        return KernelVoiceSpec(
            carry={"phase": ("u32", 0), "stage": ("f32", 0.0),
                   "t": ("f32", 0.0), "rscale": ("f32", 1.0)},
            body=body, idle_of=_stage_idle, cuda_body="sine",
            consts=np.array([f2pi, atk, rel], np.float32),
            voice_name=self.name())


class FMVoice(UGen):
    """2-operator FM voice: a modulator sine FMs a carrier sine, AR envelope.

    freq is the carrier frequency, ratio the modulator's (mod freq =
    freq*ratio), index the modulation depth in units of the carrier
    frequency. The envelope has no sustain: a voice falls silent
    ``release`` seconds after its attack ends."""

    inputs = 0
    outputs = 1
    params = (
        pfloat("freq", 220.0, kind=ParameterKind.FREQUENCY),
        pfloat("ratio", 2.0),
        pfloat("index", 1.5),
        pfloat("amp", 0.1),
        ptrigger("t_restart"),
    )

    def __init__(self, freq: float = 220.0, ratio: float = 2.0, index: float = 1.5,
                 amp: float = 0.1, attack: float = 0.005, release: float = 0.3):
        self.pdefaults = {"freq": float(freq), "ratio": float(ratio),
                          "index": float(index), "amp": float(amp)}
        self.attack = float(attack)
        self.release = float(release)
        self.mod = SinWt(freq * ratio)
        self.car = SinWt(freq)
        self.env = EnvAr(attack, release, scan=cumsum_base16)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"mod": self.mod.init(ctx, device), "car": self.car.init(ctx, device),
                "env": self.env.init(ctx, device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        """Audio-rate FM of two SinWts, EnvAr, amp (voices.py:317-351). The
        carrier's frequency ``freq * (1 + index * mod)`` is rounded op by op,
        as the JAX package writes it: one ulp there can move the carrier's
        u32 increment."""
        freq = params["freq"]
        no_in = _no_input(ctx, freq)
        mod_state, mod_out, _ = _run(self.mod, ctx, state["mod"], no_in,
                                     _osc_params(freq * params["ratio"]))
        car_freq = freq * (1.0 + params["index"] * mod_out[..., 0, :])
        car_state, car_out, _ = _run(self.car, ctx, state["car"], no_in,
                                     _osc_params(car_freq))
        atk, rel = _times(freq, self.attack, self.release)
        env_state, env_out, done = _run(
            self.env, ctx, state["env"], no_in,
            {"attack_time": atk, "release_time": rel, "t_restart": params["t_restart"]})
        out = car_out * env_out * params["amp"].unsqueeze(-2)
        return {"mod": mod_state, "car": car_state, "env": env_state}, out, done

    def kernel_voice(self, ctx: AudioCtx):
        """The hand FM kernel's math (``kernels/fm_bank.py``)."""
        from ..parallel.generic_bank import KernelVoiceSpec

        f2pi = _f2pi(ctx)
        atk, rel = _rate(self.attack, ctx.sample_rate), _rate(self.release, ctx.sample_rate)
        one = np.float32(1.0)

        def body(i_f, c, P, T):
            env, stage, t = _env_ar(c["stage"], c["t"], T["t_restart"], atk, rel)
            gain = env * P["amp"]
            freq = P["freq"]
            mod = _sin_quant(c["phm"])
            phm = u32_add(c["phm"], _to_inc(freq * P["ratio"] * f2pi))
            car_freq = freq * (one + P["index"] * mod)
            car = _sin_quant(c["phc"])
            phc = u32_add(c["phc"], _to_inc(car_freq * f2pi))
            new = {"phm": phm, "phc": phc, "stage": stage, "t": t}
            return new, (car * gain,)

        return KernelVoiceSpec(
            carry={"phm": ("u32", 0), "phc": ("u32", 0), "stage": ("f32", 0.0),
                   "t": ("f32", 0.0)},
            body=body, idle_of=_stage_idle, cuda_body="fm",
            consts=np.array([f2pi, atk, rel], np.float32),
            voice_name=self.name())


class SubtractiveVoice(UGen):
    """PolyBLEP saw -> SVF lowpass -> ASR envelope (BASELINE config #2).

    The saw is the plain polyBLEP without the > sr/4 sine fallback, as in
    the JAX package's kernels: keep fundamentals below sr/4."""

    inputs = 0
    outputs = 1
    params = (
        pfloat("freq", 110.0, kind=ParameterKind.FREQUENCY),
        pfloat("cutoff", 2000.0, kind=ParameterKind.FREQUENCY),
        pfloat("q", 1.0),
        pfloat("amp", 0.2),
        ptrigger("t_restart"),
        ptrigger("t_release"),
    )

    def __init__(self, freq: float = 110.0, cutoff: float = 2000.0, q: float = 1.0,
                 amp: float = 0.2, attack: float = 0.01, release: float = 0.2):
        self.pdefaults = {"freq": float(freq), "cutoff": float(cutoff),
                          "q": float(q), "amp": float(amp)}
        self.attack = float(attack)
        self.release = float(release)
        self.osc = PolyBlep(Waveform.Sawtooth, freq)
        self.filt = SvfFilter(SvfFilterType.Low, cutoff, q, 0.0)
        self.env = EnvAsr(attack, release, scan=cumsum_base16)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"osc": self.osc.init(ctx, device), "filt": self.filt.init(ctx, device),
                "env": self.env.init(ctx, device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        """PolyBlep saw -> SvfFilter lowpass -> * EnvAsr * amp
        (voices.py:435-475). Unlike the kernel bodies, the PolyBlep keeps
        its sine above sr/4, as in the JAX package's vmap path."""
        freq = params["freq"]
        dev = freq.device
        no_in = _no_input(ctx, freq)
        lead = freq.shape[:-1]
        zero_int = torch.zeros(freq.shape, dtype=torch.int32, device=dev)
        osc_state, osc_out, _ = _run(
            self.osc, ctx, state["osc"], no_in,
            {"waveform": zero_int, "freq": freq,
             "pulse_width": torch.full_like(freq, 0.5),
             # the waveform on the host: the saw, for every voice
             "waveform_host": np.zeros(lead, np.int64)})
        filt_state, filt_out, _ = _run(
            self.filt, ctx, state["filt"], osc_out,
            {"filter": zero_int, "cutoff_freq": params["cutoff"], "q": params["q"],
             "gain": torch.zeros_like(freq),
             "t_calculate_coefficients": torch.zeros(freq.shape, dtype=torch.bool,
                                                     device=dev)})
        atk, rel = _times(freq, self.attack, self.release)
        env_state, env_out, done = _run(
            self.env, ctx, state["env"], no_in,
            {"attack_time": atk, "release_time": rel,
             "t_restart": params["t_restart"], "t_release": params["t_release"]})
        out = filt_out * env_out * params["amp"].unsqueeze(-2)
        return {"osc": osc_state, "filt": filt_state, "env": env_state}, out, done

    def kernel_voice(self, ctx: AudioCtx):
        """The hand subtractive kernel's math (``kernels/sub_bank.py``)."""
        from ..parallel.generic_bank import KernelVoiceSpec

        inv_sr = np.float32(1.0 / ctx.sample_rate)
        pi_inv_sr = np.float32(np.pi) * inv_sr
        atk, rel = _rate(self.attack, ctx.sample_rate), _rate(self.release, ctx.sample_rate)
        one, two, half = np.float32(1.0), np.float32(2.0), np.float32(0.5)

        def body(i_f, c, P, T):
            env, stage, et, rscale = _env_asr(c["stage"], c["et"], c["rscale"],
                                              T["t_restart"], T["t_release"],
                                              atk, rel)
            dt = torch.clamp(P["freq"] * inv_sr, 0.0, 0.5)
            tt = c["t"] + half
            tt = tt - torch.floor(tt)
            saw = two * tt - one - _blep(tt, dt)
            t = c["t"] + dt
            t = t - torch.floor(t)
            a1, a2, a3 = _svf_low_coeffs(pi_inv_sr * P["cutoff"], P["q"])
            ic1, ic2 = c["ic1"], c["ic2"]
            v3 = saw - ic2
            v1 = a1 * ic1 + a2 * v3
            v2 = ic2 + a2 * ic1 + a3 * v3
            new = {"t": t, "ic1": two * v1 - ic1, "ic2": two * v2 - ic2,
                   "stage": stage, "et": et, "rscale": rscale}
            return new, (v2 * (env * P["amp"]),)

        return KernelVoiceSpec(
            carry={"t": ("f32", 0.0), "ic1": ("f32", 0.0), "ic2": ("f32", 0.0),
                   "stage": ("f32", 0.0), "et": ("f32", 0.0),
                   "rscale": ("f32", 1.0)},
            body=body, idle_of=_stage_idle, cuda_body="subtractive",
            consts=np.array([inv_sr, pi_inv_sr, atk, rel], np.float32),
            voice_name=self.name())


class AdditiveVoice(UGen):
    """Band-limited arbitrary-wavetable voice: enveloped, panned additive
    synthesis from a table's harmonic decomposition (OscWt's role at bank
    scale). Harmonic h's phasor comes from the fundamental's by complex
    multiply, and partials above Nyquist are masked per sample.

    Pass ``table`` (one cycle, or a ``NonAaWavetable``) or ``harmonics``
    (mags [H], or (mags, offsets_u32) for non-sine-phase partials)."""

    inputs = 0
    outputs = 2
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("amp", 0.0125),
        pfloat("pan", 0.0),
        ptrigger("t_restart"),
        ptrigger("t_release"),
    )

    def __init__(self, table=None, harmonics=None, n_harmonics: int = 16,
                 freq: float = 440.0, amp: float = 0.0125, pan: float = 0.0,
                 attack: float = 0.01, release: float = 0.1):
        if (table is None) == (harmonics is None):
            raise ValueError("pass exactly one of table= or harmonics=")
        if table is not None:
            if hasattr(table, "buffer"):  # NonAaWavetable
                table = table.buffer
            mags, offs = harmonics_from_table(table, n_harmonics)
        elif isinstance(harmonics, tuple):
            mags = np.asarray(harmonics[0], np.float32)
            offs = np.asarray(harmonics[1], np.uint32)
        else:
            mags = np.asarray(harmonics, np.float32)
            offs = np.zeros(len(mags), np.uint32)
        self.mags = mags
        self.offsets = offs
        self.n_harmonics = len(mags)
        self.pdefaults = {"freq": float(freq), "amp": float(amp), "pan": float(pan)}
        self.attack = float(attack)
        self.release = float(release)
        self.env = EnvAsr(attack, release, scan=cumsum_base16)
        self.panner = Pan2(pan)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"phase": torch.zeros((), dtype=torch.int32, device=device),
                "env": self.env.init(ctx, device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        """The partials by phasor recurrence, EnvAsr, amp, Pan2
        (voices.py:777-831): the u32 phase's exclusive cumsum, sin/cos of
        the full fundamental angle once, harmonic h's phasor by complex
        multiply, each partial masked above its Nyquist threshold (divided
        in f64 and rounded to f32, as the kernels' are)."""
        B = ctx.block_size
        dtype = ctx.dtype
        freq = params["freq"]
        dev = freq.device
        f2pi = float(_f2pi(ctx))
        inc = torch.clamp(freq * f2pi, 0.0, 2.0**31 - 1).to(torch.int64)
        csum = torch.cumsum(inc, dim=-1)  # exact: B increments below 2^31
        ecs = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
        phase0 = u32_of(state["phase"]).unsqueeze(-1)
        phase_t = (phase0 + ecs[..., :B]) & 0xFFFFFFFF
        cycle = TABLE_SIZE * FRACTIONAL_PART  # one cycle: 2^30 phase units
        theta = (phase_t & (cycle - 1)).to(dtype) * float(np.float32(2.0 * np.pi / cycle))
        s1, c1 = torch.sin(theta), torch.cos(theta)
        phi = self.offsets.astype(np.float64) * (2.0 * np.pi / 2.0**32)
        A = (self.mags * np.cos(phi)).astype(np.float32)
        Bc = (self.mags * np.sin(phi)).astype(np.float32)
        hvec = np.arange(1, self.n_harmonics + 1, dtype=np.float64)
        thr = (np.float64(ctx.sample_rate / 2.0) / hvec).astype(np.float32)
        thr_t = torch.from_numpy(thr).to(device=dev, dtype=dtype)
        s, c = s1, c1
        osc = (float(A[0]) * s + float(Bc[0]) * c) * (freq <= thr_t[0]).to(dtype)
        for h in range(1, self.n_harmonics):
            s, c = s * c1 + c * s1, c * c1 - s * s1
            osc = osc + (float(A[h]) * s + float(Bc[h]) * c) * (freq <= thr_t[h]).to(dtype)
        atk, rel = _times(freq, self.attack, self.release)
        env_state, env_out, done = _run(
            self.env, ctx, state["env"], _no_input(ctx, freq),
            {"attack_time": atk, "release_time": rel,
             "t_restart": params["t_restart"], "t_release": params["t_release"]})
        sig = (osc * env_out[..., 0, :] * params["amp"]).unsqueeze(-2)
        _, out = self.panner.process(ctx, {}, sig, {"pan": params["pan"]})
        new_phase = i32_of((u32_of(state["phase"]) + ecs[..., B]) & 0xFFFFFFFF)
        return {"phase": new_phase, "env": env_state}, out, done

    def kernel_voice(self, ctx: AudioCtx):
        """The hand wavetable kernel's partials (``kernels/wt_bank.py``),
        with exact cos/sin pan of the materialized pan every sample."""
        from ..kernels.wt_bank import additive_partials, wt_coefs
        from ..parallel.generic_bank import KernelVoiceSpec

        f2pi = _f2pi(ctx)
        atk, rel = _rate(self.attack, ctx.sample_rate), _rate(self.release, ctx.sample_rate)
        coefs = wt_coefs(self.mags, self.offsets, ctx.sample_rate)
        on_device = {}  # coefs as a tensor per device, for the torch body
        half = np.float32(0.5)

        def body(i_f, c, P, T):
            env, stage, t, rscale = _env_asr(c["stage"], c["t"], c["rscale"],
                                             T["t_restart"], T["t_release"],
                                             atk, rel)
            freq = P["freq"]
            dev = freq.device
            if dev not in on_device:
                on_device[dev] = torch.from_numpy(coefs).to(dev)
            acc = additive_partials(freq, _theta_full(c["phase"]), on_device[dev])
            phase = u32_add(c["phase"], _to_inc(freq * f2pi))
            sig = acc * (env * P["amp"])
            angle = (P["pan"] * half + half) * _HALF_PI
            new = {"phase": phase, "stage": stage, "t": t, "rscale": rscale}
            return new, (sig * torch.cos(angle), sig * torch.sin(angle))

        return KernelVoiceSpec(
            carry={"phase": ("u32", 0), "stage": ("f32", 0.0),
                   "t": ("f32", 0.0), "rscale": ("f32", 1.0)},
            body=body, idle_of=_stage_idle, cuda_body="additive",
            consts=np.concatenate([np.array([f2pi, atk, rel], np.float32),
                                   coefs.reshape(-1)]),
            voice_name=self.name())


class EnvelopeVoice(UGen):
    """A sine gated by a multi-segment :class:`Envelope` with per-segment
    shapes, looping and live ``time_scale`` (reference envelopes.rs:322-528),
    with exact equal-power pan. Its body folds the segment table per
    sample (``bank_common._make_env_multiseg``); the envelope-finished bit
    is the idle latch, and a voice frozen by ``t_stop`` is not idle."""

    inputs = 0
    outputs = 2
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("amp", 0.0125),
        pfloat("pan", 0.0),
        pfloat("time_scale", 1.0, range=(0.0, 20.0), logarithmic=True),
        ptrigger("t_restart"),
        ptrigger("t_stop"),
    )

    def __init__(self, envelope=None, freq: float = 440.0, amp: float = 0.0125,
                 pan: float = 0.0, time_scale: float = 1.0):
        if envelope is None:
            # the default 4-segment pluck-ish program: rise, drop, sag, fade
            envelope = Envelope(0.0, [(0.01, 1.0), (0.05, 0.6),
                                      (0.2, 0.4, "sinusoidal"), (0.3, 0.0)])
        if not isinstance(envelope, Envelope):
            raise ValueError("envelope must be an Envelope instance")
        self.env = envelope
        self.osc = SinWt(freq)
        self.panner = Pan2(pan)
        self.pdefaults = {"freq": float(freq), "amp": float(amp), "pan": float(pan),
                          "time_scale": float(time_scale)}

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"osc": self.osc.init(ctx, device), "env": self.env.init(ctx, device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        """SinWt * Envelope * amp, then Pan2 (voices.py:191-219); the
        envelope's ``jump_to_segment`` is held at 0."""
        freq = params["freq"]
        no_in = _no_input(ctx, freq)
        osc_state, osc_out, _ = _run(self.osc, ctx, state["osc"], no_in, _osc_params(freq))
        env_state, env_out, done = _run(
            self.env, ctx, state["env"], no_in,
            {"time_scale": params["time_scale"],
             "jump_to_segment": torch.zeros(freq.shape, dtype=torch.int32,
                                            device=freq.device),
             "t_restart": params["t_restart"], "t_stop": params["t_stop"]})
        sig = osc_out * env_out * params["amp"].unsqueeze(-2)
        _, out = self.panner.process(ctx, {}, sig, {"pan": params["pan"]})
        return {"osc": osc_state, "env": env_state}, out, done

    def kernel_voice(self, ctx: AudioCtx):
        """SinWt's phase, the segment-table envelope, polynomial Pan2 gains.
        Constants: f2pi, 1/sr, the start value, looping, S, the distinct
        shapes present (4 slots), then recip[S], dur[S], val[S], shape[S]."""
        from ..parallel.generic_bank import KernelVoiceSpec

        f2pi = _f2pi(ctx)
        segs, shapes = self.env.segment_table()
        estep = _make_env_multiseg(segs, self.env.looping, self.env.start_value, shapes)
        base_scale = np.float32(1.0 / ctx.sample_rate)
        half = np.float32(0.5)
        present = env_present_shapes(shapes)

        def body(i_f, c, P, T):
            dt = P["time_scale"] * base_scale
            env, eseg, et, efrom, _fin = estep(c["eseg"], c["et"], c["efrom"], dt,
                                               T["t_restart"], T["t_stop"])
            sig = _sin_quant(c["phase"]) * (env * P["amp"])
            phase = u32_add(c["phase"], _to_inc(P["freq"] * f2pi))
            angle = (P["pan"] * half + half) * _HALF_PI
            new = {"phase": phase, "eseg": eseg, "et": et, "efrom": efrom}
            return new, (sig * _sin_poly(_HALF_PI - angle), sig * _sin_poly(angle))

        consts = np.concatenate([
            np.array([f2pi, base_scale, self.env.start_value, self.env.looping,
                      len(segs), len(present)], np.float32),
            np.array(present + [0] * (4 - len(present)), np.float32),
            segs.T.reshape(-1), shapes.astype(np.float32)])
        return KernelVoiceSpec(
            carry={"phase": ("u32", 0), "eseg": ("f32", ENV_SEG_FINISHED),
                   "et": ("f32", 0.0), "efrom": ("f32", self.env.start_value)},
            body=body, idle_of=lambda c: c["eseg"] == ENV_SEG_FINISHED,
            cuda_body="envelope", consts=consts.astype(np.float32),
            voice_name=self.name())


class ModalVoice(UGen):
    """Struck modal voice: an EnvAr mallet pulse of ``strike_ms``
    milliseconds retriggered by ``t_strike``, scaled by ``amp`` and
    normalized by the pulse's area, rings a :class:`ModalResonator` of M
    modes; Pan2 to stereo.

    Idle (the pool's latch): struck since it was last reclaimed, the
    mallet done, and the gain-weighted ring energy below
    ``done_threshold``. A never-struck voice is not idle."""

    inputs = 0
    outputs = 2
    may_set_done = True
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("amp", 0.25),
        pfloat("pan", 0.0, range=(-1.0, 1.0)),
        pfloat("decay", 1.0, range=(0.0, 100.0), kind=ParameterKind.SECONDS),
        ptrigger("t_strike"),
    )

    def __init__(self, resonator=None, freq: float = 440.0, amp: float = 0.25,
                 pan: float = 0.0, strike_ms: float = 2.0,
                 done_threshold: float = 1e-5):
        self.res = resonator if resonator is not None else ModalResonator.bell(freq)
        half = max(float(strike_ms), 0.05) * 5e-4  # attack + release = strike_ms
        self.exciter = EnvAr(half, half, scan=cumsum_base16)
        # a pulse drives a slow mode nearly coherently, so the ring scales
        # with the pulse's area (half*sr samples): normalized by it
        self._half = half
        self.done_threshold = float(done_threshold)
        self.pdefaults = {"freq": float(freq), "amp": float(amp), "pan": float(pan),
                          "decay": float(self.res.pdefaults["decay"])}
        self.panner = Pan2(pan)

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"res": self.res.init(ctx, device), "exc": self.exciter.init(ctx, device),
                "struck": torch.zeros((), dtype=torch.bool, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        """EnvAr mallet -> ModalResonator -> Pan2 (voices.py:1585-1623).
        Done fires at the block's last frame once the voice was struck, its
        mallet stopped and its ring energy fell below ``done_threshold``;
        it clears the struck flag."""
        freq = params["freq"]
        exc = self.exciter.pdefaults
        atk, rel = _times(freq, exc["attack_time"], exc["release_time"])
        exc_state, pulse, _ = _run(
            self.exciter, ctx, state["exc"], _no_input(ctx, freq),
            {"attack_time": atk, "release_time": rel, "t_restart": params["t_strike"]})
        inv_area = float(np.float32(1.0 / max(self._half * ctx.sample_rate, 1.0)))
        res_state, wet = self.res.process(
            ctx, state["res"], pulse * (params["amp"] * inv_area).unsqueeze(-2),
            {"freq": freq, "decay": params["decay"]})
        _, out = self.panner.process(ctx, {}, wet, {"pan": params["pan"]})
        struck = state["struck"] | params["t_strike"].any(dim=-1)
        quiet = self.res.ring_energy(res_state) < torch.tensor(
            self.done_threshold, dtype=ctx.dtype, device=freq.device)
        fire = struck & quiet & (exc_state["stage"] == STOPPED)
        done = torch.zeros(freq.shape, dtype=torch.bool, device=freq.device)
        done[..., -1] = fire
        return {"res": res_state, "exc": exc_state, "struck": struck & ~fire}, out, done

    def batch_key(self):
        return (type(self), self.res.batch_key(), self.done_threshold,
                self.exciter.pdefaults["attack_time"])

    def kernel_voice(self, ctx: AudioCtx):
        """M rotation-decay modes per voice, EnvAr mallet, polynomial Pan2.
        As in the JAX body, 1/decay is taken once per sample and each mode's
        exp argument is ``(K/(rel_m*sr)) * (1/decay)``; decays come from
        ``_exp_poly`` and the rotation from ``_sincos_halfturn``, and a mode
        at or above pi is dead (r = 0). Constants: atk, rel, 1/area, 2pi/sr,
        thr^2, M, then ratios[M], k_exp[M], gains[M], gains^2[M]. On the
        card M <= 16 takes the library body (``modal1`` ... ``modal16``);
        past 16 modes the spec names none, and this torch body is lowered
        to a CUDA body of its own (``kernels/lower.py``) at the bank's first
        launch."""
        from ..parallel.generic_bank import KernelVoiceSpec

        res = self.res
        M = res.n_modes
        sr = np.float32(ctx.sample_rate)
        exc = self.exciter.pdefaults
        atk = _rate(exc["attack_time"], ctx.sample_rate)
        rel = _rate(exc["release_time"], ctx.sample_rate)
        inv_area = np.float32(1.0 / max(self._half * ctx.sample_rate, 1.0))
        c2pi = np.float32(2.0 * np.pi) / sr
        pi_f, half = np.float32(np.pi), np.float32(0.5)
        zero, one = np.float32(0.0), np.float32(1.0)
        ratios = np.asarray([np.float32(res.ratios[m]) for m in range(M)], np.float32)
        k_exp = np.asarray([np.float32(np.float32(_LN10_M3) / (np.float32(res.decays[m]) * sr))
                            for m in range(M)], np.float32)
        gains = np.asarray([np.float32(res.gains[m]) for m in range(M)], np.float32)
        g2 = np.asarray([np.float32(float(res.gains[m]) ** 2) for m in range(M)], np.float32)
        thr2 = np.float32(self.done_threshold ** 2)

        def body(i_f, c, P, T):
            strike = T["t_strike"]
            pulse, stage, t = _env_ar(c["stage"], c["t"], strike, atk, rel)
            struck = c["struck"]
            if strike is not None:
                struck = torch.maximum(struck, strike.to(torch.float32))
            x = pulse * (P["amp"] * inv_area)
            inv_decay = one / P["decay"]
            freq = P["freq"]
            new = {"stage": stage, "t": t, "struck": struck}
            acc = zero
            for m in range(M):
                # the f32 grouping of ModalResonator: (2pi/sr) * (freq*ratio)
                theta = c2pi * (freq * ratios[m])
                r = _exp_poly(k_exp[m] * inv_decay)
                r = torch.where(theta < pi_f, r, zero)
                sth_u, cth_u = _sincos_halfturn(theta)
                cth = r * cth_u
                sth = r * sth_u
                s0, s1 = c[f"s{m}a"], c[f"s{m}b"]
                s0n = cth * s0 - sth * s1 + x
                s1n = sth * s0 + cth * s1
                new[f"s{m}a"], new[f"s{m}b"] = s0n, s1n
                acc = acc + gains[m] * s1n
            angle = (P["pan"] * half + half) * _HALF_PI
            return new, (acc * _sin_poly(_HALF_PI - angle), acc * _sin_poly(angle))

        def idle_of(c):
            e2 = zero
            for m in range(M):
                e2 = e2 + g2[m] * (c[f"s{m}a"] * c[f"s{m}a"] + c[f"s{m}b"] * c[f"s{m}b"])
            return (c["struck"] > zero) & (e2 < thr2) & (c["stage"] == zero)

        carry = {"stage": ("f32", 0.0), "t": ("f32", 0.0), "struck": ("f32", 0.0)}
        for m in range(M):
            carry[f"s{m}a"] = ("f32", 0.0)
            carry[f"s{m}b"] = ("f32", 0.0)
        consts = np.concatenate([np.array([atk, rel, inv_area, c2pi, thr2, M], np.float32),
                                 ratios, k_exp, gains, g2])
        return KernelVoiceSpec(carry=carry, body=body, idle_of=idle_of,
                               cuda_body=f"modal{M}" if M <= 16 else None, consts=consts,
                               voice_name=self.name())


class SamplerVoice(UGen):
    """Sample-playback voice for a ``VoiceBank``: one shared buffer, per-voice
    rate, amp and pan, an ASR envelope, a restart trigger
    (voices.py:909-1334; BufferReader, ugens/buffer.rs:21-190, at voice
    scale).

    Read positions are computed in closed form for the whole block: the loop
    wrap is an integer modulus, a restart re-anchors the positions at its
    exact frame (the last restart of a block wins), so a bank of V voices is
    two ``[V, B]`` gathers from the shared buffer plus elementwise math. The
    loop boundary is rounded to whole frames.

    The port has the gather read only. The JAX package's ``tiled`` and
    ``resample`` reads are TPU reformulations of the same gather, held
    bit-identical to it by its tests, and here they are flags on the gather
    read with their semantics kept:

    * ``tiled=True`` plays at unit rate (the ``rate`` param is ignored),
      needs the buffer at the engine's sample rate and a loop of at least
      one block, and makes the voice block-dependent with a superblock cap
      of one loop length, as the tiled read does; a one-shot voice's
      pointer stops at the loop's end;
    * ``resample=True`` clamps the rate to ``[0, max_rate]``.
    """

    inputs = 0
    outputs = 2
    params = (
        pfloat("rate", 1.0),
        pfloat("amp", 0.5),
        pfloat("pan", 0.0),
        ptrigger("t_restart"),
        ptrigger("t_release"),
    )

    def __init__(self, buffer, rate: float = 1.0, amp: float = 0.5, pan: float = 0.0,
                 loop: bool = True, start_s: float = 0.0, end_s: float = -1.0,
                 attack: float = 0.005, release: float = 0.05, tiled: bool = False,
                 resample: bool = False, max_rate: float = 2.0):
        data = np.asarray(buffer.data if hasattr(buffer, "data") else buffer)
        if data.ndim == 2:
            data = data[0]
        self._data = data.astype(np.float32)
        self._buf_sr = float(getattr(buffer, "sample_rate", 48000))
        n = len(self._data)
        self._start = int(round(start_s * self._buf_sr))
        end = n if end_s < 0 else min(n, int(round(end_s * self._buf_sr)))
        self._loop_len = max(end - self._start, 1)
        self.loop = bool(loop)
        self.tiled = bool(tiled)
        self.resample = bool(resample)
        if self.tiled and self.resample:
            raise ValueError("tiled and resample are mutually exclusive")
        self.max_rate = float(max_rate)
        self.pdefaults = {"rate": float(rate), "amp": float(amp), "pan": float(pan)}
        self._attack = float(attack)
        self._release = float(release)
        self.env = EnvAsr(attack, release, scan=cumsum_base16)
        self.panner = Pan2(pan)
        self._source = Buffer(self._data, int(self._buf_sr))  # its device copies

    def batch_key(self):
        return (type(self), id(self._data), self._start, self._loop_len, self.loop,
                self._attack, self._release, self.tiled, self.resample, self.max_rate)

    def init(self, ctx: AudioCtx, device="cpu"):
        if self.tiled:
            if self._buf_sr != float(ctx.sample_rate):
                raise ValueError(
                    "tiled SamplerVoice needs the buffer at the engine sample rate "
                    f"({self._buf_sr} != {ctx.sample_rate})")
            if self._loop_len < ctx.block_size:
                raise ValueError(
                    f"tiled SamplerVoice needs loop_len >= block_size "
                    f"({self._loop_len} < {ctx.block_size})")
            # the tiled read's contract: exact up to one loop length
            self.block_invariant = False
            self.superblock_cap = self._loop_len
        return {"pos_int": torch.zeros((), dtype=torch.int32, device=device),
                "pos_frac": torch.zeros((), dtype=ctx.dtype, device=device),
                "playing": torch.zeros((), dtype=torch.bool, device=device),
                "env": self.env.init(ctx, device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        B, dtype, L = ctx.block_size, ctx.dtype, self._loop_len
        amp = params["amp"]
        dev = amp.device
        buf = self._source.on(dev, dtype)[0]
        if self.tiled:
            step = torch.ones(amp.shape[:-1] + (1,), dtype=dtype, device=dev)
        else:
            # block-rate pitch, from the block's first sample
            step = params["rate"][..., :1] * float(np.float32(self._buf_sr / ctx.sample_rate))
            if self.resample:
                step = step.clamp(0.0, float(np.float32(self.max_rate)))
        t = torch.arange(B, device=dev).to(dtype)
        base = (state["pos_int"].to(dtype) + state["pos_frac"]).unsqueeze(-1)

        # closed-form positions: continue from state, or re-anchor at the
        # block's last restart frame tf
        pos = base + step * t
        end_pos = base + step * B
        playing = state["playing"]
        if not ctx.no_events:
            trig = params["t_restart"]
            any_trig = trig.any(-1, keepdim=True)
            tf = torch.where(trig, torch.arange(B, device=dev),
                             torch.full_like(trig, -1, dtype=torch.long)).amax(-1, keepdim=True)
            fresh = step * (t - tf.to(dtype))
            pos = torch.where(any_trig & (t >= tf.to(dtype)), fresh, pos)
            end_pos = torch.where(any_trig, step * (B - tf.to(dtype)), end_pos)
            playing = playing | any_trig[..., 0]
        ipos = torch.floor(pos)
        frac = pos - ipos
        ipos = ipos.to(torch.int32).long()
        if self.loop:
            idx, idx1 = ipos.remainder(L), (ipos + 1).remainder(L)
            alive = playing.unsqueeze(-1)
        else:
            idx, idx1 = ipos.clamp(0, L - 1), (ipos + 1).clamp(0, L - 1)
            alive = playing.unsqueeze(-1) & (ipos < L)
        s0 = self._start
        a, b = buf[s0 + idx], buf[s0 + idx1]
        sig = torch.where(alive, a + (b - a) * frac, torch.zeros((), dtype=dtype, device=dev))

        # the end-of-block pointer: the same trajectory at t = B
        e_int = torch.floor(end_pos)
        pos_frac = (end_pos - e_int)[..., 0]
        pos_int = e_int.to(torch.int32)[..., 0]
        if self.loop:
            pos_int = pos_int.remainder(L)
        elif self.tiled:
            pos_int = pos_int.clamp(max=L)

        no_in = _no_input(ctx, amp)
        atk, rel = _times(amp, self._attack, self._release)
        env_state, env_out, done = _run(
            self.env, ctx, state["env"], no_in,
            {"attack_time": atk, "release_time": rel,
             "t_restart": params["t_restart"], "t_release": params["t_release"]})
        sig = (sig * env_out[..., 0, :] * amp).unsqueeze(-2)
        _, out = self.panner.process(ctx, {}, sig, {"pan": params["pan"]})
        return ({"pos_int": pos_int, "pos_frac": pos_frac, "playing": playing,
                 "env": env_state}, out, done)


class PluckedVoice(UGen):
    """A Karplus-Strong string with a built-in exciter: per-voice Threefry
    noise gated by a one-pole burst envelope that ``t_pluck`` retriggers,
    so ``VoiceBank(PluckedVoice(), V)`` is a V-string ensemble with
    sample-accurate per-voice plucks (voices.py:1335-1516).

    The voice is blockwise: the loop geometry is taken once per block from
    the block's first sample, the ring ``[T, B]`` (T tiles of one block) is
    read as the window ``[s, s + B)`` of its flat ``T*B`` samples, and one
    tile is written per block at the shared tile pointer ``wq``. Loops are
    clamped to at least one block (freq <= sample_rate / block_size), so
    the voice is block-dependent (``block_invariant = False``) unless
    ``max_freq`` declares the shortest loop (``superblock_cap``). The noise
    is keyed by (seed, ``vseed`` at the block's first sample, absolute
    frame): give each voice its own ``vseed`` (``voice_defaults=
    dict(vseed=np.arange(V))``) to decorrelate the plucks. ``seed=None``
    draws from ``next_randomness_seed`` in construction order.

    Params: freq/amp/damp/brightness floats, ``t_pluck`` trigger, ``vseed``
    int. ``wq`` and ``frame`` advance alike for every voice: a bank keeps
    them unbatched (``shared_state_keys``)."""

    inputs = 0
    outputs = 1
    block_invariant = False
    shared_state_keys = ("wq", "frame")
    params = (
        pfloat("freq", 220.0, range=(1.0, 20000.0), logarithmic=True,
               kind=ParameterKind.FREQUENCY),
        pfloat("amp", 0.5),
        pfloat("damp", 0.996, range=(0.0, 1.0)),
        pfloat("brightness", 0.7, range=(0.0, 1.0)),
        ptrigger("t_pluck"),
        pinteger("vseed", 0),
    )

    def __init__(self, freq: float = 220.0, amp: float = 0.5, damp: float = 0.996,
                 brightness: float = 0.7, min_freq: float = 27.5,
                 burst_seconds: float = 0.0015, seed=None, max_freq=None):
        from ..ugens.noise import next_randomness_seed

        self.min_freq = float(min_freq)
        self.max_freq = None if max_freq is None else float(max_freq)
        self.burst_seconds = float(burst_seconds)
        self.seed = next_randomness_seed() if seed is None else int(seed)
        self.pdefaults = {"freq": float(freq), "amp": float(amp),
                          "damp": float(damp), "brightness": float(brightness)}

    def init(self, ctx: AudioCtx, device="cpu"):
        B = ctx.block_size
        # whole blocks covering the longest loop and the interpolation's
        # headroom, and one spare tile for the block's write
        L = int(np.ceil((ctx.sample_rate / self.min_freq + 2) / B)) * B + B
        if self.max_freq is not None:
            # loops never get shorter than sr/max_freq: superblocks up to
            # that length keep every read behind the write frontier
            self.superblock_cap = max(1, min(L, int(ctx.sample_rate / self.max_freq)))

        def zero():
            return torch.zeros((), dtype=ctx.dtype, device=device)

        return {"buf": torch.zeros((L // B, B), dtype=ctx.dtype, device=device),
                "wq": torch.zeros((), dtype=torch.int32, device=device),
                "ap_in": zero(), "ap_out": zero(), "d_last": zero(), "lp": zero(),
                "env": zero(),
                # the u32 frame counter as its int32 bit pattern
                "frame": torch.zeros((), dtype=torch.int32, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        from ..core.dsp import affine_scan_1d
        from ..ugens.noise import M32, advance_frame, fold_in, prng_key, uniform
        from ..ugens.physical import string_geometry

        B = ctx.block_size
        dtype = ctx.dtype
        buf, wq = state["buf"], state["wq"]
        T = buf.shape[-2]
        L = T * B
        dev = buf.device

        # the burst noise, keyed by (seed, vseed, absolute frame)
        frames = (u32_of(state["frame"]) + torch.arange(B, device=dev)) & M32
        vseed = u32_of(params["vseed"][..., 0]).unsqueeze(-1)
        key = fold_in(prng_key(torch.full_like(vseed, self.seed & M32)), vseed)
        u = uniform(fold_in(key, frames), 1, dtype)[..., 0] * 2.0 - 1.0

        # the burst envelope: e[t] = 1 on a pluck, else g * e[t-1]
        trig = params["t_pluck"].to(dtype)
        g = scalar_of(np.exp(-1.0 / max(self.burst_seconds * ctx.sample_rate, 1.0)), dtype)
        a = g * (1.0 - trig)
        e_pre, _ = affine_scan_1d(a, trig, state["env"])
        env = a * e_pre + trig
        exc = u * env * params["amp"]

        # the loop geometry, once per block; reads stay at least one tile
        # behind the write tile
        nf, coeff, b1, damp = string_geometry(
            params["freq"][..., 0], params["brightness"][..., 0], params["damp"][..., 0],
            ctx.sample_rate, self.min_freq, L, dtype)
        nf = nf.clamp(B, L - B)

        # the ring's window [s, s + B) of the flat T*B samples
        s = (wq.long() * B - nf) % L
        idx = (s.unsqueeze(-1) + torch.arange(B, device=dev)) % L
        raw = torch.gather(buf.reshape(buf.shape[:-2] + (L,)), -1, idx)

        # the allpass interpolator, then the average and the one-pole
        coeff, b1, damp = coeff.unsqueeze(-1), b1.unsqueeze(-1), damp.unsqueeze(-1)
        raw_prev = torch.cat([state["ap_in"].unsqueeze(-1), raw[..., :-1]], dim=-1)
        bvec = coeff * raw + raw_prev
        a_ap = (-coeff).expand(raw.shape)
        d_pre, _ = affine_scan_1d(a_ap, bvec, state["ap_out"])
        d = a_ap * d_pre + bvec
        d_prev = torch.cat([state["d_last"].unsqueeze(-1), d[..., :-1]], dim=-1)
        h = 0.5 * (d + d_prev)
        a0 = 1.0 - b1
        lp_pre, _ = affine_scan_1d(b1.expand(h.shape), a0 * h, state["lp"])
        lp = b1 * lp_pre + a0 * h
        write = exc + damp * lp

        # one tile written at the shared pointer wq
        buf = buf.index_copy(-2, wq.long().reshape(1), write.unsqueeze(-2))
        new = {"buf": buf, "wq": ((wq + 1) % T).to(torch.int32),
               "ap_in": raw[..., -1], "ap_out": d[..., -1], "d_last": d[..., -1],
               "lp": lp[..., -1], "env": env[..., -1],
               "frame": advance_frame(state["frame"], B)}
        return new, write.unsqueeze(-2)


class FMCascade(UGen):
    """An N-stage FM cascade as ONE node: stage 0 sine at ``freq``, stage k's
    frequency ``base + depth * out[k-1]``, the last stage times ``amp``
    (the reference's 256-stage FM cascade benchmark shape,
    knaster_benchmarks/benches/graph_dsp_performance.rs:38-80, hand-fused).

    Two paths, as in the JAX package: the fused kernel (``use_kernel``, f32
    only; params read at block rate; ``kernels/fm_cascade.py``, the port of
    ``_process_pallas``) and the scan form (a loop over the stages with
    per-sample params) for ``use_kernel=False`` or f64. Their saturation
    differs above 96 kHz, as the JAX package's two paths do: see
    ``kernels/fm_cascade.py``."""

    inputs = 0
    outputs = 1
    params = (
        pfloat("freq", 100.0, kind=ParameterKind.FREQUENCY),
        pfloat("base", 200.0, kind=ParameterKind.FREQUENCY),
        pfloat("depth", 100.0),
        pfloat("amp", 0.1),
    )

    def __init__(self, n_stages: int = 256, freq: float = 100.0,
                 base: float = 200.0, depth: float = 100.0, amp: float = 0.1,
                 use_kernel: bool = True):
        self.n_stages = int(n_stages)
        self.pdefaults = {
            "freq": float(freq),
            "base": float(base),
            "depth": float(depth),
            "amp": float(amp),
        }
        self.use_kernel = bool(use_kernel)
        if self.use_kernel:
            # the kernel's one shared row bounds a superblock's length (the
            # JAX package's Pallas cascade has no such cap)
            from ..kernels.fm_cascade import MAX_BLOCK

            self.superblock_cap = MAX_BLOCK

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"phases": torch.zeros((self.n_stages,), dtype=torch.int32,
                                      device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        f2pi = float(_f2pi(ctx))
        scale = float(np.float32(2.0 * np.pi / TABLE_SIZE))
        if self.use_kernel and ctx.dtype == torch.float32:
            from ..kernels.fm_cascade import fm_cascade

            p = torch.stack([params["freq"][0], params["base"][0],
                             params["depth"][0], params["amp"][0]])
            phases = state["phases"].clone()
            out = fm_cascade(params=p, phases=phases, block_size=ctx.block_size,
                             f2pi=f2pi, scale=scale)
            return {"phases": phases}, out[None, :]
        return self._process_scan(ctx, state, params, f2pi, scale)

    def _process_scan(self, ctx, state, params, f2pi, scale):
        """The scan form (voices.py:614-637): u32 increments with the uint32
        convert's saturation, ``sin`` of the quantized index in ctx.dtype."""
        base, depth = params["base"], params["depth"]
        # np.float32(2**31 - 1) is 2^31 in f32; exact 2^31 - 1 in f64
        hi = 2.0**31 - 1
        ph = u32_of(state["phases"])

        def stage(freq, ph0):
            inc = (freq * f2pi).clamp(0.0, hi).to(torch.int64)
            csum = torch.cumsum(inc, dim=0)
            idx = ((ph0 + csum - inc) >> 16) & 16383
            return torch.sin(idx.to(ctx.dtype) * scale), (ph0 + csum[-1]) & 0xFFFFFFFF

        out, new = stage(params["freq"], ph[0])
        phases = [new]
        for k in range(1, self.n_stages):
            out, new = stage(base + depth * out, ph[k])
            phases.append(new)
        return {"phases": i32_of(torch.stack(phases))}, (out * params["amp"])[None, :]
