"""The fused sine-bank kernel: wrapper, plain torch version and launch count.

Replaces ``knaster_tpu/parallel/pallas_bank.py::_sine_kernel`` (the Pallas
TPU kernel called from ``PallasSineVoiceBank.process``) with the CUDA C++
kernel in ``csrc/sine_bank.cu``, built for sm_90a by ``kernels/build.py``.

Per voice and sample it computes what ``_sine_kernel`` computes: the
materialized freq/amp/pan ramps (``_mat``, with D breakpoint rounds in
eventful blocks), the packed restart/release trigger bits (``_trig_bit``),
the saturating u32 phase increment (``_to_inc``), the table-quantized sine
from the folded-quadrant degree-9 polynomial (``_sin_quant``), the EnvAsr
state machine (``_env_asr`` / ``_env_asr_free``) and the equal-power pan
gains (``_pan_gains``), and mixes the bank to stereo.

What bounds it on an H100: FP32 issue. Each voice-sample costs roughly 40
float/integer ops where its ramps move or its envelope runs (the sine and
pan polynomials most of them; an eventful sample adds ``cosf``/``sinf`` and
15*D breakpoint selects), about 17 where the voice is sustained or stopped
and its ramps are flat (the sine read from a shared-memory table of its
first quadrant, the phase add, three multiplies and the mix); memory is a few tens of bytes per voice per block (15 ramp floats,
act and 4 state words in, 4 out). An event-free block takes the raw ramp
groups and ``act``: the kernel folds act into amp and builds the
linear-angle pan pack itself (``bank_common.fold_act``, ``pan_pack``: what
the wavetable bank stages on the host, op for op), then takes
once what is the same at every sample (``bank_common``
``pack_flat_over_block``, ``ramp_flat_over_block``, ``env_asr_steady``).
The kernel sums the stereo mix itself (``bank_common.empty_mix``,
``mix_tickets``): no reduction launch follows.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``sine_bank_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import bank_common as bc
from .bank_common import (_env_asr, _mat, _pan_gains, _sin_quant, _to_inc,
                          _trig_bit, fold_act, pan_pack)

KERNEL = "sine_bank"
# kernel launches since import (or since a caller reset it): a run shows
# its main path went through the kernel by reading this around it
LAUNCHES = 0

N_FLOAT = 3  # freq, amp, pan (SineVoice's float params, in bank order)
N_TRIG = 2  # t_restart, t_release
FREQ, AMP, PAN = 0, 1, 2
ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 \
    + [ctypes.c_void_p]


def _validate(ramps, rounds, act, words, phase, stage, t, rscale, block_size):
    """Check every operand against the layout the kernel reads; returns
    (V, B, D) with D = 0 for an event-free block."""
    f32 = torch.float32
    return bc.validate_block(
        KERNEL, N_FLOAT, N_TRIG,
        [("phase", phase, torch.int32), ("stage", stage, f32), ("t", t, f32),
         ("rscale", rscale, f32)],
        ramps, rounds, act, words, block_size, act_always=True)


def sine_bank(*, ramps, rounds, act, words, phase, stage, t, rscale,
              block_size, atk, rel, f2pi):
    """One block of the fused sine bank.

    ramps:  f32 [3, 5, V] — per float param (freq, amp, pan) the anchored
            ramp group (v0, step, el, dur, tgt), as the bank holds it.
    rounds: f32 [3, 5, D, V] breakpoints (v0, step, dur, tgt, frame), or
            None for an event-free block.
    act:    f32 [V] 0/1 active gain, every block (event-free blocks fold it
            into amp, ``bank_common.fold_act``).
    words:  int32 [2, ceil(B/32), V] restart and release trigger bits
            (eventful only).
    phase:  int32 [V] bit pattern of the u32 oscillator phase.
    stage, t, rscale: f32 [V] EnvAsr state.
    atk, rel, f2pi: f32-representable floats (per-sample envelope rates and
            phase units per Hz).

    Returns (mix f32 [2, B], phase, stage, t, rscale), the state new
    tensors. CPU tensors run ``sine_bank_plain``; CUDA tensors launch the
    kernel."""
    operands = dict(ramps=ramps, rounds=rounds, act=act, words=words,
                    phase=phase, stage=stage, t=t, rscale=rscale,
                    block_size=block_size, atk=atk, rel=rel, f2pi=f2pi)
    if phase.device.type == "cpu":
        return sine_bank_plain(**operands)
    outs = empty_outputs(phase, block_size)
    launch(outs, **operands)
    mix, _, *state = outs
    return (mix, *state)


def empty_outputs(phase, block_size):
    """The kernel's output buffers for a bank of ``phase.shape[0]`` voices:
    (mix [2, B], mix scratch (``bank_common.empty_mix``), phase, stage, t,
    rscale)."""
    V = phase.shape[0]
    return (*bc.empty_mix(V, 2, block_size, phase.device),
            torch.empty_like(phase),
            *(torch.empty((V,), dtype=torch.float32, device=phase.device)
              for _ in range(3)))


def launch(outs, *, ramps, rounds, act, words, phase, stage, t, rscale,
           block_size, atk, rel, f2pi):
    """Launch the CUDA kernel on the current stream, writing ``outs`` (from
    ``empty_outputs``): the mix and the new state.
    Raises for anything but CUDA tensors of the documented layout, and if
    the launch fails."""
    global LAUNCHES
    V, B, D = _validate(ramps, rounds, act, words, phase, stage, t, rscale,
                        block_size)
    device = phase.device
    bc.require_cuda(KERNEL, device)
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
        err = lib.ktt_sine_bank(
            ptr(ramps), ptr(rounds), ptr(act), ptr(words),
            ptr(phase), ptr(stage), ptr(t), ptr(rscale),
            ptr(work), ptr(mix), ptr(tickets), ptr(phase_out), ptr(stage_out),
            ptr(t_out), ptr(rscale_out),
            V, B, D, int(rounds is not None),
            ctypes.c_float(atk), ctypes.c_float(rel), ctypes.c_float(f2pi),
            ctypes.c_void_p(stream),
        )
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1


# --------------------------------------------------------------------------
# plain torch version: the same arithmetic, op for op, over [V] per sample
# --------------------------------------------------------------------------

def sine_bank_plain(*, ramps, rounds, act, words, phase, stage, t, rscale,
                    block_size, atk, rel, f2pi):
    """``sine_bank`` in plain torch: a Python loop over the B samples with
    [V]-wide ops in the kernel's order, on whatever device the tensors are
    on. An event-free block stages its operands first as the kernel's
    prologue does (act folded into amp, the pan pack). The u32 phase is
    carried as int64 in [0, 2^32) (torch has no uint32 arithmetic) and
    returned as its int32 bit pattern. The mix is one ``torch.sum`` per
    sample and channel, so it differs from the kernel's fixed-order sum by
    rounding only."""
    V, B, _ = _validate(ramps, rounds, act, words, phase, stage, t, rscale,
                        block_size)
    dev = phase.device
    atk, rel, f2pi = (bc.scalar(x, dev) for x in (atk, rel, f2pi))
    eventful = rounds is not None
    rg = (lambda p: rounds[p]) if eventful else (lambda p: None)
    if not eventful:
        ramps = stage_event_free(ramps, act)
    ph = bc.u32_of(phase)
    outl, outr = [], []
    for i in range(B):
        i_f = float(i)
        restart = _trig_bit(i, words[0]) if eventful else None
        release = _trig_bit(i, words[1]) if eventful else None
        env, stage, t, rscale = _env_asr(stage, t, rscale, restart, release,
                                         atk, rel)
        gain = env * _mat(i_f, ramps[AMP], rg(AMP))
        if eventful:
            gain = gain * act
        freq = _mat(i_f, ramps[FREQ], rg(FREQ))
        osc = _sin_quant(ph)
        ph = bc.u32_add(ph, _to_inc(freq * f2pi))
        sig = osc * gain
        panl, panr = _pan_gains(i_f, ramps[PAN], rg(PAN))
        outl.append(torch.sum(sig * panl))
        outr.append(torch.sum(sig * panr))
    mix = torch.stack([torch.stack(outl), torch.stack(outr)])
    return mix, bc.i32_of(ph), stage, t, rscale


def stage_event_free(ramps, act):
    """An event-free block's [3, 5, V] ramp groups as the kernel's prologue
    stages them: act folded into amp, pan swapped for the linear-angle pack
    (``bank_common.fold_act``, ``pan_pack``)."""
    out = ramps.clone()
    fold_act(out[AMP], act)
    out[PAN] = pan_pack(ramps[PAN])
    return out
