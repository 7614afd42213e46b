"""The fused additive wavetable bank kernel: wrapper, plain torch version and launch count.

Replaces ``knaster_tpu/parallel/pallas_bank.py::_wt_kernel`` (called from
``PallasWavetableVoiceBank.process``) with the CUDA C++ kernel in
``csrc/wt_bank.cu``, built for sm_90a by ``kernels/build.py``.

Per voice and sample it computes what ``_wt_kernel`` computes: the
materialized freq/amp/pan ramps (``_mat``), the packed restart and release
bits, the EnvAsr state machine (``_env_asr``), sin/cos of the
full-resolution fundamental angle (``_theta_full``), H partials by phasor
recurrence weighted by the table's A/B coefficients and masked per sample
against the hoisted Nyquist thresholds, equal-power pan (``_pan_gains``)
and the stereo mix. The A/B/threshold constants are computed on the host by
``wt_coefs`` exactly as the JAX package does (f64, rounded to f32): the
plain version reads them as a ``[3, H]`` tensor on the state's device, the
kernel by value as a kernel parameter, the host image ``coef_image`` builds
(H, then the table padded to 8, 16, 32 or 64 harmonics with entries that
contribute nothing), read by a fully unrolled harmonic loop as constant
operands. A table of more than 64 harmonics takes the kernel's run-time
variant (``bank_common.RUNTIME_H``): its image is H alone and the kernel
reads the ``[3, H]`` tensor itself, one broadcast load a constant.

What bounds it on an H100: FP32 issue, ~7 ops per harmonic per
voice-sample plus one sincosf. The kernel sums the stereo mix itself: each
CTA of 256 voices in a shared-memory tile after one barrier (event-free
blocks) or by warp shuffles into warp rows added at the end (eventful
blocks), the CTA rows in a fixed order (``bank_common.mix_rows``,
``mix_tickets``), so no reduction launch follows.

Tolerance: phase, stage, t and rscale are bit-equal to the plain version;
the mix passes through the card's ``sincosf``, which may differ from
torch's sin/cos by an ulp, carried through the recurrence, and sums the
terms in another order, so it is compared within a stated tolerance.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``wt_bank_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bank_common as bc
from .bank_common import (_env_asr, _mat, _pan_gains, _theta_full, _to_inc,
                          _trig_bit)

KERNEL = "wt_bank"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

N_FLOAT = 3  # freq, amp, pan (AdditiveVoice's float params, in bank order)
N_TRIG = 2  # t_restart, t_release
FREQ, AMP, PAN = 0, 1, 2
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 8 \
    + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p]


def wt_coefs(mags, offsets, sample_rate):
    """f32 [3, H]: per harmonic the A (sin) and B (cos) weights of the
    table's partials and the Nyquist threshold ``nyq/(h+1)``, computed in
    f64 and rounded to f32 as ``PallasWavetableVoiceBank.process`` does."""
    mags = np.asarray(mags, np.float32)
    phi = np.asarray(offsets, np.uint32).astype(np.float64) * (2.0 * np.pi / 2.0**32)
    acoef = (mags * np.cos(phi)).astype(np.float32)
    bcoef = (mags * np.sin(phi)).astype(np.float32)
    nyq = float(sample_rate / 2.0)
    thr = np.array([np.float32(np.float64(nyq) / (h + 1))
                    for h in range(len(mags))], np.float32)
    return np.stack([acoef, bcoef, thr])


def coef_image(coefs):
    """The host image of the kernel's parameter from the ``[3, H]`` table of
    ``wt_coefs``: f32 [1 + 3*HMAX], H, then A, B and thr each padded to
    HMAX, the smallest of ``bank_common.HARMONIC_SLOTS`` that holds H; past
    the largest, f32 [1], H alone (``bank_common.RUNTIME_H``: the kernel
    reads the table from the ``coefs`` tensor)."""
    coefs = np.asarray(coefs, np.float32)
    H = coefs.shape[1]
    hmax = bc.harmonic_slots(H)
    if hmax == bc.RUNTIME_H:
        return np.array([H], np.float32)
    return np.concatenate([[np.float32(H)],
                           bc.padded_harmonics(coefs, hmax).reshape(-1)]).astype(np.float32)


def _validate(ramps, rounds, act, words, phase, stage, t, rscale, coefs,
              block_size):
    f32 = torch.float32
    V, B, D = bc.validate_block(
        KERNEL, N_FLOAT, N_TRIG,
        [("phase", phase, torch.int32), ("stage", stage, f32), ("t", t, f32),
         ("rscale", rscale, f32)],
        ramps, rounds, act, words, block_size)
    H = coefs.shape[1] if isinstance(coefs, torch.Tensor) and coefs.dim() == 2 else 0
    if H < 1:
        raise ValueError(f"{KERNEL}: coefs must be a [3, H] tensor with H >= 1")
    bc.check(KERNEL, "coefs", coefs, f32, (3, H), phase.device)
    return V, B, D, H


def wt_bank(*, ramps, rounds, act, words, phase, stage, t, rscale, coefs,
            block_size, atk, rel, f2pi, image=None):
    """One block of the fused additive wavetable bank.

    ramps:  f32 [3, 5, V] anchored ramp groups of freq, amp, pan. Event-free
            blocks carry amp with ``act`` folded in and pan as the
            linear-angle pack (a0, da, lt, rt, rem).
    rounds: f32 [3, 5, D, V] breakpoints, or None for an event-free block.
    act:    f32 [V] 0/1 active gain (eventful only).
    words:  int32 [2, ceil(B/32), V] restart and release trigger bits
            (eventful only).
    phase:  int32 [V] bit pattern of the u32 phase.
    stage, t, rscale: f32 [V] EnvAsr state.
    coefs:  f32 [3, H] from ``wt_coefs``, on the state's device.
    atk, rel, f2pi: f32-representable floats.
    image:  ``coef_image`` of the same table, a host array: the kernel's
            parameter (the kernel needs it; the plain version does not
            read it).

    Returns (mix f32 [2, B], phase, stage, t, rscale). CPU tensors run
    ``wt_bank_plain``; CUDA tensors launch the kernel."""
    operands = dict(ramps=ramps, rounds=rounds, act=act, words=words,
                    phase=phase, stage=stage, t=t, rscale=rscale, coefs=coefs,
                    block_size=block_size, atk=atk, rel=rel, f2pi=f2pi, image=image)
    if phase.device.type == "cpu":
        return wt_bank_plain(**operands)
    outs = empty_outputs(phase, block_size)
    launch(outs, **operands)
    mix, _, *state = outs
    return (mix, *state)


def empty_outputs(phase, block_size):
    """(mix [2, B], mix scratch (``bank_common.empty_mix``), phase, stage,
    t, rscale)."""
    V = phase.shape[0]
    return (*bc.empty_mix(V, 2, block_size, phase.device),
            torch.empty_like(phase),
            *(torch.empty((V,), dtype=torch.float32, device=phase.device)
              for _ in range(3)))


def launch(outs, *, ramps, rounds, act, words, phase, stage, t, rscale, coefs,
           block_size, atk, rel, f2pi, image=None):
    """Launch the CUDA kernel on the current stream, writing ``outs`` (from
    ``empty_outputs``). Raises for anything but CUDA tensors of the
    documented layout, for a missing or mismatched ``image``, and if the
    launch fails."""
    global LAUNCHES
    V, B, D, H = _validate(ramps, rounds, act, words, phase, stage, t, rscale,
                           coefs, block_size)
    device = phase.device
    bc.require_cuda(KERNEL, device)
    hmax = bc.harmonic_slots(H)
    if not (isinstance(image, np.ndarray) and image.dtype == np.float32
            and image.shape == (1 + 3 * hmax,) and image.flags.c_contiguous
            and image[0] == H):
        raise ValueError(f"{KERNEL}: image must be coef_image(coefs) of the [3, {H}] "
                         "table, a contiguous f32 host array")
    mix, work, phase_out, stage_out, t_out, rscale_out = outs
    bc.check(KERNEL, "mix", mix, torch.float32, (2, B), device)
    bc.check(KERNEL, "work", work, torch.float32, (bc.mix_scratch_rows(V), 2, B), device)
    bc.check(KERNEL, "phase_out", phase_out, torch.int32, (V,), device)
    for name, x in (("stage_out", stage_out), ("t_out", t_out),
                    ("rscale_out", rscale_out)):
        bc.check(KERNEL, name, x, torch.float32, (V,), device)

    from .build import load_library

    lib = load_library(KERNEL)
    ptr = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tickets = bc.mix_tickets(V, device, stream)
        err = lib.ktt_wt_bank(
            ptr(ramps), ptr(rounds), ptr(act), ptr(words), ptr(phase),
            ptr(stage), ptr(t), ptr(rscale), image.ctypes.data_as(ctypes.c_void_p),
            image.shape[0], ptr(coefs), ptr(work), ptr(mix), ptr(tickets), ptr(phase_out),
            ptr(stage_out), ptr(t_out), ptr(rscale_out), V, B, D,
            int(rounds is not None), ctypes.c_float(atk), ctypes.c_float(rel),
            ctypes.c_float(f2pi), ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1


def additive_partials(freq, theta, coefs):
    """The band-limited oscillator: H partials of the fundamental angle
    ``theta`` by phasor recurrence, each masked by ``freq <= thr[h]``."""
    acoef, bcoef, thr = coefs[0], coefs[1], coefs[2]
    s1, c1 = torch.sin(theta), torch.cos(theta)
    s, c = s1, c1
    zero = torch.zeros_like(freq)
    acc = torch.where(freq <= thr[0], acoef[0] * s + bcoef[0] * c, zero)
    for h in range(1, coefs.shape[1]):
        s, c = s * c1 + c * s1, c * c1 - s * s1
        part = acoef[h] * s + bcoef[h] * c
        acc = acc + torch.where(freq <= thr[h], part, zero)
    return acc


def wt_bank_plain(*, ramps, rounds, act, words, phase, stage, t, rscale, coefs,
                  block_size, atk, rel, f2pi, image=None):
    """``wt_bank`` in plain torch: a Python loop over the B samples with
    [V]-wide ops in the kernel's order. The mix is one ``torch.sum`` per
    sample and channel. ``image`` (the kernel's parameter) is not read."""
    V, B, _, _ = _validate(ramps, rounds, act, words, phase, stage, t, rscale,
                           coefs, block_size)
    dev = phase.device
    atk, rel, f2pi = (bc.scalar(x, dev) for x in (atk, rel, f2pi))
    eventful = rounds is not None
    rg = (lambda p: rounds[p]) if eventful else (lambda p: None)
    ph = bc.u32_of(phase)
    outl, outr = [], []
    for i in range(B):
        i_f = float(i)
        restart = _trig_bit(i, words[0]) if eventful else None
        release = _trig_bit(i, words[1]) if eventful else None
        env, stage, t, rscale = _env_asr(stage, t, rscale, restart, release,
                                         atk, rel)
        freq = _mat(i_f, ramps[FREQ], rg(FREQ))
        acc = additive_partials(freq, _theta_full(ph), coefs)
        ph = bc.u32_add(ph, _to_inc(freq * f2pi))
        gain = env * _mat(i_f, ramps[AMP], rg(AMP))
        if eventful:
            gain = gain * act
        sig = acc * gain
        panl, panr = _pan_gains(i_f, ramps[PAN], rg(PAN))
        outl.append(torch.sum(sig * panl))
        outr.append(torch.sum(sig * panr))
    mix = torch.stack([torch.stack(outl), torch.stack(outr)])
    return mix, bc.i32_of(ph), stage, t, rscale
