"""The fused subtractive bank kernel: wrapper, plain torch version and launch count.

Replaces ``knaster_tpu/parallel/pallas_bank.py::_sub_kernel`` (called from
``PallasSubtractiveVoiceBank.process``) with the CUDA C++ kernel in
``csrc/sub_bank.cu``, built for sm_90a by ``kernels/build.py``.

Per voice and sample it computes what ``_sub_kernel`` computes: the
materialized freq/cutoff/q/amp ramps (``_mat``), the packed restart and
release bits, the EnvAsr state machine (``_env_asr``), a polyBLEP sawtooth
(no > sr/4 sine fallback, as in the TPU kernel), the SVF lowpass
coefficients from the per-sample cutoff and q (``_svf_low_coeffs``), one SVF
step, and the mono mix.

What bounds it on an H100: FP32 issue, with three IEEE divides per
voice-sample; the mix is a per-sample warp reduction into
``[ceil(V/32), 1, B]`` partials summed by ``torch.sum``.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``sub_bank_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bank_common as bc
from .bank_common import _blep, _env_asr, _mat, _svf_low_coeffs, _trig_bit

KERNEL = "sub_bank"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

N_FLOAT = 4  # freq, cutoff, q, amp (SubtractiveVoice's float params)
N_TRIG = 2  # t_restart, t_release
FREQ, CUT, Q, AMP = 0, 1, 2, 3
STATE = ("t", "ic1", "ic2", "stage", "et", "rscale")  # all f32 [V]
ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 \
    + [ctypes.c_void_p]


def _validate(ramps, rounds, act, words, state, block_size):
    return bc.validate_block(
        KERNEL, N_FLOAT, N_TRIG,
        [(name, state[name], torch.float32) for name in STATE],
        ramps, rounds, act, words, block_size)


def sub_bank(*, ramps, rounds, act, words, t, ic1, ic2, stage, et, rscale,
             block_size, atk, rel, inv_sr, pi_inv_sr):
    """One block of the fused subtractive bank.

    ramps:  f32 [4, 5, V] anchored ramp groups of freq, cutoff, q, amp;
            event-free blocks carry amp with ``act`` folded in.
    rounds: f32 [4, 5, D, V] breakpoints, or None for an event-free block.
    act:    f32 [V] 0/1 active gain (eventful only).
    words:  int32 [2, ceil(B/32), V] restart and release trigger bits
            (eventful only).
    t:      f32 [V] saw phase in [0, 1); ic1, ic2: SVF integrator states;
    stage, et, rscale: f32 [V] EnvAsr state.
    atk, rel, inv_sr, pi_inv_sr: f32-representable floats.

    Returns (mix f32 [1, B], t, ic1, ic2, stage, et, rscale). CPU tensors
    run ``sub_bank_plain``; CUDA tensors launch the kernel."""
    operands = dict(ramps=ramps, rounds=rounds, act=act, words=words, t=t,
                    ic1=ic1, ic2=ic2, stage=stage, et=et, rscale=rscale,
                    block_size=block_size, atk=atk, rel=rel, inv_sr=inv_sr,
                    pi_inv_sr=pi_inv_sr)
    if t.device.type == "cpu":
        return sub_bank_plain(**operands)
    outs = empty_outputs(t, block_size)
    launch(outs, **operands)
    partial, *state = outs
    return (partial.sum(dim=0), *state)


def empty_outputs(t, block_size):
    """(partial mix [ceil(V/32), 1, B], t, ic1, ic2, stage, et, rscale)."""
    V = t.shape[0]
    return (bc.empty_partial(V, 1, block_size, t.device),
            *(torch.empty_like(t) for _ in STATE))


def launch(outs, *, ramps, rounds, act, words, t, ic1, ic2, stage, et,
           rscale, block_size, atk, rel, inv_sr, pi_inv_sr):
    """Launch the CUDA kernel on the current stream, writing ``outs`` (from
    ``empty_outputs``). Raises for anything but CUDA tensors of the
    documented layout, and if the launch fails."""
    global LAUNCHES
    state = dict(t=t, ic1=ic1, ic2=ic2, stage=stage, et=et, rscale=rscale)
    V, B, D = _validate(ramps, rounds, act, words, state, block_size)
    device = t.device
    bc.require_cuda(KERNEL, device)
    partial, *state_out = outs
    bc.check(KERNEL, "partial", partial, torch.float32,
             ((V + 31) // 32, 1, B), device)
    for name, x in zip(STATE, state_out):
        bc.check(KERNEL, f"{name}_out", x, torch.float32, (V,), device)

    from .build import load_library

    lib = load_library(KERNEL)
    ptr = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_sub_bank(
            ptr(ramps), ptr(rounds), ptr(act), ptr(words),
            *(ptr(state[name]) for name in STATE), ptr(partial),
            *(ptr(x) for x in state_out), V, B, D, int(rounds is not None),
            ctypes.c_float(atk), ctypes.c_float(rel), ctypes.c_float(inv_sr),
            ctypes.c_float(pi_inv_sr), ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1


def sub_bank_plain(*, ramps, rounds, act, words, t, ic1, ic2, stage, et,
                   rscale, block_size, atk, rel, inv_sr, pi_inv_sr):
    """``sub_bank`` in plain torch: a Python loop over the B samples with
    [V]-wide ops in the kernel's order. The mix is one ``torch.sum`` per
    sample, so it differs from the kernel's warp-tree sum by rounding
    only."""
    state = dict(t=t, ic1=ic1, ic2=ic2, stage=stage, et=et, rscale=rscale)
    V, B, _ = _validate(ramps, rounds, act, words, state, block_size)
    dev = t.device
    atk, rel, inv_sr, pi_inv_sr = (bc.scalar(x, dev)
                                   for x in (atk, rel, inv_sr, pi_inv_sr))
    one, two, half = np.float32(1.0), np.float32(2.0), np.float32(0.5)
    eventful = rounds is not None
    rg = (lambda p: rounds[p]) if eventful else (lambda p: None)
    out = []
    for i in range(B):
        i_f = float(i)
        restart = _trig_bit(i, words[0]) if eventful else None
        release = _trig_bit(i, words[1]) if eventful else None
        env, stage, et, rscale = _env_asr(stage, et, rscale, restart, release,
                                          atk, rel)
        # polyBLEP sawtooth (polyblep.rs saw): y = 2*frac(t+0.5)-1 - blep
        dt = torch.clamp(_mat(i_f, ramps[FREQ], rg(FREQ)) * inv_sr, 0.0, 0.5)
        tt = t + half
        tt = tt - torch.floor(tt)
        saw = two * tt - one - _blep(tt, dt)
        t = t + dt
        t = t - torch.floor(t)
        a1, a2, a3 = _svf_low_coeffs(pi_inv_sr * _mat(i_f, ramps[CUT], rg(CUT)),
                                     _mat(i_f, ramps[Q], rg(Q)))
        # SVF step (svf.rs process_sample, m = (0, 0, 1))
        v3 = saw - ic2
        v1 = a1 * ic1 + a2 * v3
        v2 = ic2 + a2 * ic1 + a3 * v3
        ic1 = two * v1 - ic1
        ic2 = two * v2 - ic2
        gain = env * _mat(i_f, ramps[AMP], rg(AMP))
        if eventful:
            gain = gain * act
        out.append(torch.sum(v2 * gain))
    return torch.stack(out)[None], t, ic1, ic2, stage, et, rscale
