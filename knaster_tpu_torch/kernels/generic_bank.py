"""The generic fused voice-bank kernel: wrapper, plain torch harness and launch count.

Replaces ``knaster_tpu/parallel/generic_bank.py::_generic_kernel`` (called
from ``PallasVoiceBank.process``) with the CUDA C++ harness in
``csrc/generic_bank.cu``, templated over a device body per library voice.
A voice brings a ``KernelVoiceSpec`` (``parallel/generic_bank.py``): its
carry table, a torch body over ``[V]`` tensors (what the plain harness here
runs), and the name of its CUDA body (``BODIES``), its own CUDA source, or
neither (its torch body is lowered).

Per voice and sample the harness does what ``_generic_kernel`` does:
materialize every float param (``_mat``), read each trigger's bit from its
packed words in eventful blocks (``None`` in event-free blocks), run the
body on the carry, multiply each output by the 0/1 active gain per sample,
and mix the C channels.

What bounds it on an H100: the body's FP32/SFU issue, as in the
hand-written banks. The kernel sums the mix itself: in an event-free block
each CTA of 256 voices sums a tile of 16 (channel, sample) columns in
shared memory after one barrier; in an eventful block each warp sums by
shuffles into a row of its own and the CTA adds its warp rows at the end;
the CTA rows are summed in the kernel in a fixed order (``bank_common``
``mix_rows``, ``mix_tickets``), so a launch returns the ``[C, B]`` mix and
no reduction launch follows. The body constants reach the kernel by value,
as a parameter packed here on the host (``const_image``): the Additive
body's A/B/thresholds padded to its instantiation (8, 16, 32 or 64
harmonics) and the Modal body's per-mode constants are read by unrolled
loops as constant operands (an Additive table of more harmonics is read
from the device constants, one broadcast load a constant); the Envelope body's segment table is staged once
per CTA into shared memory from the device constants and selected by index
(``bank_common.env_segment_index``). In an event-free block what reads only
params that are flat over it is taken once (``bank_common``
``ramp_flat_over_block``): a stereo body's pan gains, the Subtractive
body's SVF coefficients.

The carry crosses the kernel as one ``[NC, V]`` int32 tensor: u32 carries
as their bit pattern, f32 carries bit-cast. The body constants (envelope
rates, phase units per Hz, the additive body's A/B/thresholds, the
envelope body's segment table, the modal body's per-mode ratios, decay
factors and gains) cross as a small f32 tensor on the device and as the
host image of the kernel parameter.

The bodies: Sine, FM, Subtractive, Additive (unrolled up to 64 harmonics,
a run-time loop past), Envelope and Modal (one instantiation per mode count, M = 1 ... 16:
the carry is a register array whose length the compiler must know). A
user voice brings its own body as CUDA source (``spec.cuda_source``): it
is compiled against ``csrc/generic_harness.cuh`` into a library of its own
(``build.load_user_body``) at its first launch, its counts checked against
the voice, and launched with the same arguments; its constants are
``spec.consts`` as they are. A voice with neither (a user voice from its
torch body alone, a ModalVoice past 16 modes) has its torch body lowered to
such a source once (``lower.lower_body``, kept on the spec) and built the
same way; its constants are literals in the source.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise: a body the lowering refuses, a build that fails), CPU tensors run
``generic_bank_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bank_common as bc
from .bank_common import _mat, _trig_bit

KERNEL = "generic_bank"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

# CUDA body name -> (id in csrc/generic_bank.cu, float params, triggers,
# carry words, outputs). The modal body is one instantiation per mode count
# M = 1 ... 16 ("modal<M>", id 4 + M, 3 + 2M carry words); a ModalVoice of
# more modes names no library body, and its torch body is lowered.
BODIES = {
    "sine": (0, 3, 2, 4, 2),
    "fm": (1, 4, 1, 4, 1),
    "subtractive": (2, 4, 2, 6, 1),
    "additive": (3, 3, 2, 4, 2),
    "envelope": (4, 4, 2, 4, 2),
    **{f"modal{m}": (4 + m, 4, 1, 3 + 2 * m, 2) for m in range(1, 17)},
}
ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
ENVELOPE_HEAD = 10  # the envelope constants before its segment table


def const_image(spec):
    """The host image of the CUDA body's kernel parameter (its ``Consts``
    struct in ``csrc/generic_bank.cu``), f32, from ``spec.consts``; built
    once per spec. Sine, FM, Subtractive: the constants as they are.
    Additive (f2pi, atk, rel, A[H], B[H], thr[H]): f2pi, atk, rel, H, then
    A, B and thr each padded to the instantiation's harmonic count
    (``bank_common.padded_harmonics``); past 64 harmonics f2pi, atk, rel, H
    alone (``bank_common.RUNTIME_H``: the body reads the table from the
    device constants). Envelope: the 10-float head (its
    segment table stays on the device). Modal (atk, rel, 1/area, 2pi/sr,
    thr^2, M, ratio[M], k_exp[M], gain[M], gain^2[M]): atk, rel, 1/area,
    2pi/sr, ratio, k_exp, gain. A user body (``spec.cuda_source``): the
    constants as they are. A lowered body: its one unused float (the
    constants are literals in its source)."""
    image = getattr(spec, "_cuda_image", None)
    if image is not None:
        return image
    body = spec.cuda_body
    k = np.asarray(np.zeros(0) if spec.consts is None else spec.consts, np.float32)
    if body is None and spec.cuda_source is None:
        image = spec._lowered.image
    elif spec.cuda_source is not None or body in ("sine", "fm", "subtractive"):
        image = k
    elif body == "additive":
        H = (k.shape[0] - 3) // 3
        hmax = bc.harmonic_slots(H)
        image = np.concatenate([k[:3], [np.float32(H)]])
        if hmax != bc.RUNTIME_H:
            table = bc.padded_harmonics(k[3:].reshape(3, H), hmax)
            image = np.concatenate([image, table.reshape(-1)])
    elif body == "envelope":
        image = k[:ENVELOPE_HEAD]
    else:
        M = int(k[5])
        image = np.concatenate([k[:4], k[6:6 + 3 * M]])
    spec._cuda_image = np.ascontiguousarray(image, np.float32)
    return spec._cuda_image


class ParamView:
    """P[name] -> the float param at this sample, materialized once per
    sample and name (the Pallas harness's ``_ParamView``)."""

    def __init__(self, i_f, ramps, rounds, float_names):
        self._i_f = i_f
        self._ramps = ramps
        self._rounds = rounds
        self._index = {n: k for k, n in enumerate(float_names)}
        self._cache = {}

    def __getitem__(self, name):
        if name not in self._cache:
            k = self._index[name]
            rg = None if self._rounds is None else self._rounds[k]
            self._cache[name] = _mat(self._i_f, self._ramps[k], rg)
        return self._cache[name]


def _validate(spec, float_names, trig_names, ramps, rounds, act, words, carry,
              consts, block_size):
    nc = len(spec.carry)
    if not isinstance(carry, torch.Tensor) or carry.dim() != 2:
        raise ValueError(f"{KERNEL}: carry must be an int32 [{nc}, V] tensor")
    V = carry.shape[1]
    dev = carry.device
    bc.check(KERNEL, "carry", carry, torch.int32, (nc, V), dev)
    n = consts.shape[0] if isinstance(consts, torch.Tensor) and consts.dim() == 1 else -1
    bc.check(KERNEL, "consts", consts, torch.float32, (n,), dev)
    return bc.validate_block(
        KERNEL, len(float_names), len(trig_names),
        [("carry[0]", carry[0], torch.int32)], ramps, rounds, act, words,
        block_size, act_always=True)


def generic_bank(*, spec, float_names, trig_names, n_out, ramps, rounds, act,
                 words, carry, consts, block_size):
    """One block of the generic bank.

    spec:   the voice's ``KernelVoiceSpec``; float_names / trig_names: the
            voice's float and trigger params in bank order; n_out: C.
    ramps:  f32 [nf, 5, V] anchored ramp groups (nothing folded in).
    rounds: f32 [nf, 5, D, V] breakpoints, or None for an event-free block.
    act:    f32 [V] 0/1 active gain, every block.
    words:  int32 [nt, ceil(B/32), V] trigger bits (eventful only).
    carry:  int32 [NC, V] carry words in ``spec.carry`` order.
    consts: f32 [n] body constants (``spec.consts``) on the carry's device.

    Returns (mix f32 [C, B], carry int32 [NC, V]). CPU tensors run
    ``generic_bank_plain``; CUDA tensors launch the kernel."""
    operands = dict(spec=spec, float_names=float_names, trig_names=trig_names,
                    n_out=n_out, ramps=ramps, rounds=rounds, act=act,
                    words=words, carry=carry, consts=consts,
                    block_size=block_size)
    if carry.device.type == "cpu":
        return generic_bank_plain(**operands)
    outs = empty_outputs(carry, n_out, block_size)
    launch(outs, **operands)
    mix, _, carry_out = outs
    return mix, carry_out


def empty_outputs(carry, n_out, block_size):
    """(mix [C, B], mix scratch (``bank_common.empty_mix``), carry [NC, V])
    buffers."""
    mix, work = bc.empty_mix(carry.shape[1], n_out, block_size, carry.device)
    return mix, work, torch.empty_like(carry)


def launch(outs, *, spec, float_names, trig_names, n_out, ramps, rounds, act,
           words, carry, consts, block_size):
    """Launch the CUDA harness with the voice's body on the current stream,
    writing ``outs`` (from ``empty_outputs``). Raises for an unknown library
    body, a torch body the lowering refuses, anything but CUDA tensors of
    the documented layout, a build that fails, and a launch that fails."""
    global LAUNCHES
    V, B, D = _validate(spec, float_names, trig_names, ramps, rounds, act,
                        words, carry, consts, block_size)
    device = carry.device
    if spec.cuda_body is None and spec.cuda_source is None:
        lowered(spec, float_names, trig_names, n_out)
    elif spec.cuda_body is not None and spec.cuda_body not in BODIES:
        raise ValueError(
            f"{KERNEL}: voice {spec.voice_name} names no known CUDA body "
            f"(cuda_body={spec.cuda_body!r}; known: {sorted(BODIES)})")
    bc.require_cuda(KERNEL, device)
    if spec.cuda_body is None:
        lib, counts = user_body(spec)
        body_id = 0
        what = (f"user body of {spec.voice_name}" if spec.cuda_source is not None
                else f"body lowered from the torch body of {spec.voice_name}")
    else:
        lib = None
        body_id, *counts = BODIES[spec.cuda_body]
        what = f"{spec.cuda_body} body"
    nf, nt, nc, c = counts
    if (nf, nt, nc, c) != (len(float_names), len(trig_names), len(spec.carry),
                           n_out):
        raise ValueError(
            f"{KERNEL}: the {what} takes {nf} float params, "
            f"{nt} triggers, {nc} carry words and {c} outputs; voice "
            f"{spec.voice_name} has {len(float_names)}, {len(trig_names)}, "
            f"{len(spec.carry)} and {n_out}")
    image = const_image(spec)
    mix, work, carry_out = outs
    bc.check(KERNEL, "mix", mix, torch.float32, (n_out, B), device)
    bc.check(KERNEL, "work", work, torch.float32, (bc.mix_scratch_rows(V), n_out, B),
             device)
    bc.check(KERNEL, "carry_out", carry_out, torch.int32, tuple(carry.shape),
             device)

    if lib is None:
        from .build import load_library

        lib = load_library(KERNEL)
    ptr = bc.ptr
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tickets = bc.mix_tickets(V, device, stream)
        err = lib.ktt_generic_bank(
            body_id, ptr(ramps), ptr(rounds), ptr(act), ptr(words), ptr(carry),
            ptr(consts), image.ctypes.data_as(ctypes.c_void_p), ptr(work), ptr(mix),
            ptr(tickets), ptr(carry_out), V, B, D, int(rounds is not None),
            consts.shape[0], image.shape[0], ctypes.c_void_p(stream))
    bc.raise_on_error(KERNEL, lib, err)
    LAUNCHES += 1


def lowered(spec, float_names, trig_names, n_out):
    """The spec's torch body lowered to a CUDA body (``lower.lower_body``)
    at the first call, then kept on the spec. Raises ValueError, naming the
    voice and the op, for a body the lowering refuses."""
    if spec._lowered is None:
        from .lower import lower_body

        spec._lowered = lower_body(spec, float_names, trig_names, n_out)
    return spec._lowered


def user_body(spec):
    """(library, (NF, NT, NC, C)) of a voice's own CUDA body: its
    ``cuda_source``, or the source lowered from its torch body (``lowered``
    first); built and loaded at the first call, then kept on the spec.
    Raises with nvcc's output if the build fails."""
    if spec._cuda_lib is None:
        from .build import load_user_body, user_body_counts

        source = spec.cuda_source if spec.cuda_source is not None else spec._lowered.source
        lib = load_user_body(source)
        spec._cuda_lib = (lib, user_body_counts(lib))
    return spec._cuda_lib


def generic_bank_plain(*, spec, float_names, trig_names, n_out, ramps, rounds,
                       act, words, carry, consts, block_size):
    """``generic_bank`` in plain torch: a Python loop over the B samples
    running the voice's torch body on [V] tensors. The body's sample index
    ``i_f`` is a 0-d f32 tensor, as the JAX kernel's traced index and the
    harness's ``p.i_f`` are, so arithmetic on it rounds in f32. u32 carries
    are unpacked to int64 in [0, 2^32) for the body and packed back after.
    The mix is one ``torch.sum`` per sample and channel."""
    V, B, _ = _validate(spec, float_names, trig_names, ramps, rounds, act,
                        words, carry, consts, block_size)
    vals = {}
    for k, (name, (kind, _)) in enumerate(spec.carry.items()):
        vals[name] = bc.u32_of(carry[k]) if kind == "u32" else carry[k].view(torch.float32)
    eventful = rounds is not None
    outs = [[] for _ in range(n_out)]
    index = torch.arange(B, dtype=torch.float32, device=act.device)
    for i in range(B):
        P = ParamView(float(i), ramps, rounds, float_names)
        T = {name: (_trig_bit(i, words[k]) if eventful else None)
             for k, name in enumerate(trig_names)}
        vals, rows = spec.body(index[i], vals, P, T)
        for ch in range(n_out):
            outs[ch].append(torch.sum(rows[ch] * act))
    mix = torch.stack([torch.stack(o) for o in outs])
    packed = torch.stack([
        bc.i32_of(vals[name]) if kind == "u32" else vals[name].view(torch.int32)
        for name, (kind, _) in spec.carry.items()])
    return mix, packed
