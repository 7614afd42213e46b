"""Port of knaster_tpu/models/voices.py: the bank voices' declarations and kernel bodies.

* ``SineVoice`` — the reference's ``many_sines`` voice
  (knaster/examples/many_sines.rs: EnvAr * (SinWt.wr_mul(amp)) >> Pan2).
* ``FMVoice`` — 2-operator FM with an AR envelope (the fm_bench family).
* ``SubtractiveVoice`` — polyBLEP saw -> SVF lowpass -> ASR envelope.
* ``AdditiveVoice`` — a wavetable cycle re-synthesized from its harmonics.
* ``FMCascade`` — an N-stage FM cascade as one graph node, with its own
  kernel (``kernels/fm_cascade.py``).

Each voice declares its parameter table, defaults and envelope times (what
the fused banks read) and ``kernel_voice(ctx)``: the per-sample body the
generic ``FusedVoiceBank`` runs, in torch over ``[V]`` tensors (the plain
version) and by name as a CUDA body. Each body is the math of its
``mosaic_voice`` in the JAX package, op for op. The vmap ``process`` path
is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen
from ..kernels.bank_common import (
    _HALF_PI, _blep, _env_ar, _env_asr, _sin_quant, _svf_low_coeffs,
    _theta_full, _to_inc, i32_of, u32_add, u32_of,
)
from ..primitives.params import ParameterKind, pfloat, ptrigger
from ..ugens.wavetable import FRACTIONAL_PART, TABLE_SIZE, harmonics_from_table


def _rate(seconds, sample_rate):
    """Per-sample envelope increment, as the JAX package rounds it."""
    return np.float32(1.0 / max(seconds * sample_rate, 1.0))


def _f2pi(ctx: AudioCtx):
    """u32 phase units per Hz at the context's sample rate."""
    return np.float32(TABLE_SIZE * FRACTIONAL_PART / ctx.sample_rate)


def _stage_idle(carry):
    return carry["stage"] == 0.0


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
