"""Port of knaster_tpu/models/voices.py: the bank voices' declarations and kernel bodies.

* ``SineVoice`` — the reference's ``many_sines`` voice
  (knaster/examples/many_sines.rs: EnvAr * (SinWt.wr_mul(amp)) >> Pan2).
* ``FMVoice`` — 2-operator FM with an AR envelope (the fm_bench family).
* ``SubtractiveVoice`` — polyBLEP saw -> SVF lowpass -> ASR envelope.
* ``AdditiveVoice`` — a wavetable cycle re-synthesized from its harmonics.
* ``EnvelopeVoice`` — a sine gated by a multi-segment ``Envelope``.
* ``ModalVoice`` — a struck ``ModalResonator`` (EnvAr mallet, Pan2).
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
    _HALF_PI, ENV_SEG_FINISHED, _blep, _env_ar, _env_asr, _exp_poly,
    _make_env_multiseg, _sin_poly, _sin_quant, _sincos_halfturn,
    _svf_low_coeffs, _theta_full, _to_inc, env_present_shapes, i32_of, u32_add,
    u32_of,
)
from ..primitives.params import ParameterKind, pfloat, ptrigger
from ..ugens.envelopes import EnvAr, Envelope
from ..ugens.modal import _LN10_M3, ModalResonator
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
        self.pdefaults = {"freq": float(freq), "amp": float(amp), "pan": float(pan),
                          "time_scale": float(time_scale)}

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
        self.exciter = EnvAr(half, half)
        # a pulse drives a slow mode nearly coherently, so the ring scales
        # with the pulse's area (half*sr samples): normalized by it
        self._half = half
        self.done_threshold = float(done_threshold)
        self.pdefaults = {"freq": float(freq), "amp": float(amp), "pan": float(pan),
                          "decay": float(self.res.pdefaults["decay"])}

    def batch_key(self):
        return (type(self), self.res.batch_key(), self.done_threshold,
                self.exciter.pdefaults["attack_time"])

    def kernel_voice(self, ctx: AudioCtx):
        """M rotation-decay modes per voice, EnvAr mallet, polynomial Pan2.
        As in the JAX body, 1/decay is taken once per sample and each mode's
        exp argument is ``(K/(rel_m*sr)) * (1/decay)``; decays come from
        ``_exp_poly`` and the rotation from ``_sincos_halfturn``, and a mode
        at or above pi is dead (r = 0). Constants: atk, rel, 1/area, 2pi/sr,
        thr^2, M, then ratios[M], k_exp[M], gains[M], gains^2[M]. The CUDA
        body takes M <= 16 (``modal1`` ... ``modal16``)."""
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
                               cuda_body=f"modal{M}", consts=consts,
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
