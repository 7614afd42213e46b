"""The fused 2-operator FM bank kernel: wrapper, plain torch version and launch count.

Replaces ``knaster_tpu/parallel/pallas_bank.py::_fm_kernel`` (called from
``PallasFMVoiceBank.process``) with the CUDA C++ kernel in
``csrc/fm_bank.cu``, built for sm_90a by ``kernels/build.py``.

Per voice and sample it computes what ``_fm_kernel`` computes: the
materialized freq/ratio/index/amp ramps (``_mat``), the packed restart bit,
the EnvAr state machine (``_env_ar``), the modulator's table-quantized sine
on its u32 phase advanced by ``freq*ratio``, the carrier's audio-rate
frequency ``freq*(1 + index*mod)`` and its sine, and the mono mix.

What bounds it on an H100: FP32 issue. A sounding voice-sample costs
roughly 60 float/integer ops (two sines, four ramps, the envelope, the two
increments and the mix; an eventful sample adds 15*D breakpoint selects);
memory is ~100 bytes per voice per block (20 ramp floats, act and 4 state
words in, 4 out). In an event-free block the kernel reads both sines from
a shared-memory table of ``_sin_quant``'s first quadrant, takes once what
is the same at every sample (``bank_common.ramp_flat_over_block``: freq,
ratio, index, amp and the modulator's increment), and lets a warp whose
gains are all zero (``env_ar_steady``: stopped voices) skip the carrier's
sine and the mix; both phases still advance sample by sample, since the
carrier's increment reads the modulator's sine. An event-free block takes
``act`` and the kernel folds it into amp (``bank_common.fold_act``, op for
op). The kernel sums the mix itself (``bank_common.empty_mix``,
``mix_tickets``): no reduction launch follows.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``fm_bank_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bank_common as bc
from .bank_common import _env_ar, _mat, _sin_quant, _to_inc, _trig_bit, fold_act

KERNEL = "fm_bank"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

N_FLOAT = 4  # freq, ratio, index, amp (FMVoice's float params, in bank order)
N_TRIG = 1  # t_restart
FREQ, RATIO, INDEX, AMP = 0, 1, 2, 3
ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 \
    + [ctypes.c_void_p]


def _validate(ramps, rounds, act, words, phm, phc, stage, t, block_size):
    i32, f32 = torch.int32, torch.float32
    return bc.validate_block(
        KERNEL, N_FLOAT, N_TRIG,
        [("phm", phm, i32), ("phc", phc, i32), ("stage", stage, f32),
         ("t", t, f32)],
        ramps, rounds, act, words, block_size, act_always=True)


def fm_bank(*, ramps, rounds, act, words, phm, phc, stage, t, block_size,
            atk, rel, f2pi):
    """One block of the fused FM bank.

    ramps:  f32 [4, 5, V] anchored ramp groups of freq, ratio, index, amp,
            as the bank holds them.
    rounds: f32 [4, 5, D, V] breakpoints, or None for an event-free block.
    act:    f32 [V] 0/1 active gain, every block (event-free blocks fold it
            into amp, ``bank_common.fold_act``).
    words:  int32 [1, ceil(B/32), V] restart trigger bits (eventful only).
    phm, phc: int32 [V] bit patterns of the modulator and carrier u32 phases.
    stage, t: f32 [V] EnvAr state.
    atk, rel, f2pi: f32-representable floats.

    Returns (mix f32 [1, B], phm, phc, stage, t). CPU tensors run
    ``fm_bank_plain``; CUDA tensors launch the kernel."""
    operands = dict(ramps=ramps, rounds=rounds, act=act, words=words, phm=phm,
                    phc=phc, stage=stage, t=t, block_size=block_size, atk=atk,
                    rel=rel, f2pi=f2pi)
    if phm.device.type == "cpu":
        return fm_bank_plain(**operands)
    outs = empty_outputs(phm, block_size)
    launch(outs, **operands)
    mix, _, *state = outs
    return (mix, *state)


def empty_outputs(phm, block_size):
    """(mix [1, B], mix scratch (``bank_common.empty_mix``), phm, phc,
    stage, t) buffers."""
    V = phm.shape[0]
    f32 = torch.float32
    return (*bc.empty_mix(V, 1, block_size, phm.device),
            torch.empty_like(phm), torch.empty_like(phm),
            torch.empty((V,), dtype=f32, device=phm.device),
            torch.empty((V,), dtype=f32, device=phm.device))


def launch(outs, *, ramps, rounds, act, words, phm, phc, stage, t, block_size,
           atk, rel, f2pi):
    """Launch the CUDA kernel on the current stream, writing ``outs`` (from
    ``empty_outputs``): the mix and the new state. Raises for anything but
    CUDA tensors of the documented layout, and if the launch fails."""
    global LAUNCHES
    V, B, D = _validate(ramps, rounds, act, words, phm, phc, stage, t,
                        block_size)
    device = phm.device
    bc.require_cuda(KERNEL, device)
    mix, work, phm_out, phc_out, stage_out, t_out = outs
    bc.check(KERNEL, "mix", mix, torch.float32, (1, B), device)
    bc.check(KERNEL, "work", work, torch.float32, (bc.mix_scratch_rows(V), 1, B), device)
    for name, x, dtype in (("phm_out", phm_out, torch.int32),
                           ("phc_out", phc_out, torch.int32),
                           ("stage_out", stage_out, torch.float32),
                           ("t_out", t_out, torch.float32)):
        bc.check(KERNEL, name, x, dtype, (V,), device)

    from .build import load_library

    lib = load_library(KERNEL)
    ptr = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tickets = bc.mix_tickets(V, device, stream)
        err = lib.ktt_fm_bank(
            ptr(ramps), ptr(rounds), ptr(act), ptr(words), ptr(phm), ptr(phc),
            ptr(stage), ptr(t), ptr(work), ptr(mix), ptr(tickets), ptr(phm_out),
            ptr(phc_out), ptr(stage_out), ptr(t_out), V, B, D, int(rounds is not None),
            ctypes.c_float(atk), ctypes.c_float(rel), ctypes.c_float(f2pi),
            ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1


def fm_bank_plain(*, ramps, rounds, act, words, phm, phc, stage, t,
                  block_size, atk, rel, f2pi):
    """``fm_bank`` in plain torch: a Python loop over the B samples with
    [V]-wide ops in the kernel's order, on whatever device the tensors are
    on; an event-free block folds act into amp first, as the kernel's
    prologue does. The mix is one ``torch.sum`` per sample, so it differs
    from the kernel's fixed-order sum by rounding only."""
    V, B, _ = _validate(ramps, rounds, act, words, phm, phc, stage, t,
                        block_size)
    dev = phm.device
    atk, rel, f2pi = (bc.scalar(x, dev) for x in (atk, rel, f2pi))
    one = np.float32(1.0)
    eventful = rounds is not None
    rg = (lambda p: rounds[p]) if eventful else (lambda p: None)
    if not eventful:
        ramps = ramps.clone()
        fold_act(ramps[AMP], act)
    pm, pc = bc.u32_of(phm), bc.u32_of(phc)
    out = []
    for i in range(B):
        i_f = float(i)
        restart = _trig_bit(i, words[0]) if eventful else None
        env, stage, t = _env_ar(stage, t, restart, atk, rel)
        gain = env * _mat(i_f, ramps[AMP], rg(AMP))
        if eventful:
            gain = gain * act
        freq = _mat(i_f, ramps[FREQ], rg(FREQ))
        mod = _sin_quant(pm)
        pm = bc.u32_add(pm, _to_inc(freq * _mat(i_f, ramps[RATIO], rg(RATIO))
                                    * f2pi))
        car_freq = freq * (one + _mat(i_f, ramps[INDEX], rg(INDEX)) * mod)
        car = _sin_quant(pc)
        pc = bc.u32_add(pc, _to_inc(car_freq * f2pi))
        out.append(torch.sum(car * gain))
    return torch.stack(out)[None], bc.i32_of(pm), bc.i32_of(pc), stage, t
