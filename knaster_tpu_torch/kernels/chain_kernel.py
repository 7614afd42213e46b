"""The collapsed-chain kernel: program, bodies, wrapper, plain torch version, launch count.

Replaces the Pallas kernel of ``knaster_tpu/graph/chain_kernel.py::run``
(kernel :265, call :333) with the CUDA C++ kernel in
``csrc/chain_kernel.cu``. The kernel is compiled once; what a chain does
arrives as a ``ChainProgram``, the int32 program
``graph/chain_kernel.py::lower`` builds from a chain plan (layout in the
kernel source). ``chain_kernel_plain`` runs the same program in torch.

``BODIES`` are the stage bodies the kernel's ``switch`` knows, each with
its opcode and its plain torch version (what a UGen's ``kernel_stage``
names): ``constant`` (Constant), ``sinwt`` (SinWt's no-reset path),
``math`` (MathUGen add/sub/mul/div), ``math1`` (Math1UGen's unary ops but
trunc and fract), ``polyblep`` (PolyBlep), ``svf`` (SvfFilter),
``onepole_lpf`` and ``onepole_hpf``, ``env_asr`` and ``env_ar`` (the
event-free closed forms, with a done row), ``pan2`` (Pan2, two output
channels), ``sin_numeric`` and ``phasor`` (SinNumeric's no-reset path and
Phasor: an f32 phase summed in ``core/dsp.cumsum_base16``'s association
over the whole block), ``white_noise`` (WhiteNoise: jax.random's Threefry
restated, bit-identical) and ``sample_delay`` (SampleDelay: a ring of L
state words, ``arg`` = L). Each plain version calls the block function its
UGen's ``process`` calls, so the kernel path and the scan executor share
one arithmetic. A new body is one more case in the kernel and one more entry
here; the program and the harness stay as they are.

State words are 32-bit: u32 phases, f32 values (the SVF's two ``ic``, the
one-pole's ``last``, the envelopes' ``t`` and ``release_scale``, the float
oscillators' ``phase``), the envelopes' int32 ``stage``, WhiteNoise's u32
frame and seed, SampleDelay's ring of L f32 words and its int32 write
position, each as its bit pattern. Integer params (the PolyBlep waveform,
the SVF filter type) reach the kernel in the f32 param planes: a whole number below 2^24 is exact there, and larger ones still
select as the int would (clamped to the last waveform, equal to no filter
type).

What bounds it on an H100: K*p dependent bodies, each a few instructions
a sample plus, for the scan bodies, log2(B) barrier-separated steps; see
the kernel source. ``launch_plan`` chooses, before each launch, where the
slot, carry and scan-scratch rows live: in one CTA's shared memory for
short blocks (``layout`` "shared"); over a thread-block cluster of up to
16 CTAs on neighbouring SMs, each holding a contiguous chunk of the
samples in its own shared memory, for superblock lengths ("cluster", up to
C * ``SMEM_LIMIT`` bytes of rows); and in a global workspace the wrapper
allocates only for rows past what a cluster holds ("global"). It also
chooses how the param planes and the state words reach the stage loop
(``staging``): one CTA copies every stage's into shared memory before the
loop where they fit, a cluster running a long chain copies stage k + 1's
during stage k, and the rest read them from device memory each stage.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run ``chain_kernel_plain``. Nothing falls back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from functools import cached_property
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import bank_common as bc

KERNEL = "chain_kernel"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3 \
    + [ctypes.c_void_p] * 2

HEADER = 8
RECORD = 10
SRC_SLOT, SRC_CARRY, SRC_ROW, SRC_PLANE = 0, 1, 2, 3
# dynamic shared memory a block can take on an H100 (232,448 bytes), less
# the kernel's static 64 words
SMEM_LIMIT = 227 * 1024 - 256
LAYOUTS = ("shared", "cluster", "global")  # csrc/chain_kernel.cu kLayout*
STAGINGS = ("ring", "whole", "direct")    # csrc/chain_kernel.cu kStage*
PORTABLE_CLUSTER = 8  # the largest cluster every Hopper card schedules
MAX_CLUSTER = 16      # the largest, where the card allows a non-portable one
# Chosen on an H100 from forced layouts (PERF.md §6): one CTA up to
# SHARED_SAMPLES samples (at 1024 it beat every cluster but on the FM and
# PolyBlep cascades, by under 5% there), and past that a cluster of CTAs of
# at most CLUSTER_CHUNK samples (a cluster of 16 was the fastest at 8192)
SHARED_SAMPLES = 1024
CLUSTER_CHUNK = 512
# a cluster stages params two stages ahead only for chains this long: there
# the ring beat reading them from device memory by 1-2% at 8192 samples, and
# lost 1-5% on the chains of 8-11 stages (PERF.md §6)
RING_STAGES = 128

@dataclass(frozen=True)
class Body:
    """A stage body of the kernel: its opcode, the param names it reads (in
    order), its state words (``n_words``, plus ``arg`` more for a ring), the
    [B] rows of scratch its scans use, and its plain torch version
    ``plain(arg, ins, pars, words, consts) -> (outs, new_words[, done])``
    over [B] rows (``words`` a 1-D int64 tensor of u32 values, ``consts`` =
    (f2pi, scale, sample_rate, B), ``new_words`` 0-d or 1-D int64 u32
    tensors in word order, ``done`` a bool row)."""

    name: str
    op: int
    params: Tuple[str, ...]
    n_words: int
    plain: Callable
    scratch: int = 0
    ring: bool = False

    def words(self, arg: int) -> int:
        """The state words of a stage of this body with ``arg``."""
        return self.n_words + (arg if self.ring else 0)


def _f32(word):
    """A state word (int64 u32 value) as the f32 it holds."""
    return bc.i32_of(word).view(torch.float32)


def _word(x):
    """A 0-d f32 or int32 tensor as a state word (int64 u32 value)."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return bc.u32_of(x.to(torch.int32))


def _constant_plain(arg, ins, pars, words, consts):
    return [pars[0]], []


def _sinwt_plain(arg, ins, pars, words, consts):
    """SinWt.process without resets (osc.py), on one [B] row."""
    from ..ugens.osc import U32_MASK, _f32_to_u32

    f2pi, scale = consts[:2]
    freq, poff = pars
    (ph0,) = words
    inc = _f32_to_u32(freq * f2pi)
    csum = torch.cumsum(inc, dim=0)
    phases = ph0 + csum - inc
    off = _f32_to_u32(poff * 65536.0)
    idx = ((phases + off) >> 16) & 16383
    return [torch.sin(idx.to(torch.float32) * scale)], [(ph0 + csum[-1]) & U32_MASK]


def _math_plain(arg, ins, pars, words, consts):
    from ..ugens.math import _BINOPS, KERNEL_BINOPS

    op, c = _BINOPS[KERNEL_BINOPS[arg]], len(ins) // 2
    return [op(ins[i], ins[c + i]) for i in range(c)], []


def _math1_plain(arg, ins, pars, words, consts):
    from ..ugens.math import _UNOPS, KERNEL_UNOPS

    op = _UNOPS[KERNEL_UNOPS[arg]]
    return [op(x) for x in ins], []


def _polyblep_plain(arg, ins, pars, words, consts):
    from ..ugens.polyblep import polyblep_block

    t, out = polyblep_block(bc.i32_of(words[0]), pars[0], pars[1], pars[2], consts[2])
    return [out], [bc.u32_of(t)]


def _svf_plain(arg, ins, pars, words, consts):
    from ..ugens.filters import svf_block

    ic = torch.stack([_f32(words[0]), _f32(words[1])])
    ic, y = svf_block(ic, ins[0], *pars, consts[2])
    return [y], [_word(ic[0]), _word(ic[1])]


def _onepole_plain(highpass):
    def plain(arg, ins, pars, words, consts):
        from ..ugens.filters import onepole_block

        last, y = onepole_block(_f32(words[0]), ins[0], pars[0], consts[2], highpass)
        return [y], [_word(last)]

    return plain


def _env_plain(form_name):
    def plain(arg, ins, pars, words, consts):
        from ..ugens import envelopes

        atk = envelopes.rate_from_time(pars[0], consts[2])
        rel = envelopes.rate_from_time(pars[1], consts[2])
        # the words in the sorted order of the state's names
        stage, t, rscale, out, done = getattr(envelopes, form_name)(
            bc.i32_of(words[1]), _f32(words[2]), _f32(words[0]), atk, rel)
        return [out], [_word(rscale), _word(stage), _word(t)], done

    return plain


def _pan2_plain(arg, ins, pars, words, consts):
    from ..ugens.pan import pan2_block

    return list(pan2_block(ins[0], pars[0])), []


def _float_osc_plain(phasor):
    def plain(arg, ins, pars, words, consts):
        from ..ugens import osc

        ph0 = _f32(words[0])
        inv_sr = osc.recip_sample_rate(consts[2], ph0)
        carry, out = (osc.phasor_block(ph0, pars[0], inv_sr) if phasor
                      else osc.sin_numeric_block(ph0, pars[0], pars[1], inv_sr))
        return [out], [_word(carry)]

    return plain


def _white_noise_plain(arg, ins, pars, words, consts):
    from ..ugens.noise import advance_frame, white_noise_block

    # the words in the sorted order of the state's names: frame, seed
    frame, seed = bc.i32_of(words[0]), bc.i32_of(words[1])
    out = white_noise_block(seed, frame, consts[3], torch.float32)
    return [out], [bc.u32_of(advance_frame(frame, consts[3])), words[1]]


def _sample_delay_plain(arg, ins, pars, words, consts):
    from ..ugens.delay import delay_samples, sample_delay_block

    L = arg
    buf = bc.i32_of(words[:L]).view(torch.float32)
    d = delay_samples(pars[0], consts[2], L)
    buf, pos, out = sample_delay_block(buf, bc.i32_of(words[L]), ins[0], d)
    return [out], [bc.u32_of(buf.view(torch.int32)), bc.u32_of(pos)]


BODIES: Dict[str, Body] = {
    b.name: b for b in (
        Body("constant", 0, ("value",), 0, _constant_plain),
        Body("sinwt", 1, ("freq", "phase_offset"), 1, _sinwt_plain),
        Body("math", 2, (), 0, _math_plain),
        Body("math1", 3, (), 0, _math1_plain),
        Body("polyblep", 4, ("waveform", "freq", "pulse_width"), 1, _polyblep_plain),
        # the 2x2 scan's six rows, twice (Hillis-Steele steps ping-pong)
        Body("svf", 5, ("filter", "cutoff_freq", "q", "gain"), 2, _svf_plain, 12),
        Body("onepole_lpf", 6, ("cutoff_freq",), 1, _onepole_plain(False), 4),
        Body("onepole_hpf", 7, ("cutoff_freq",), 1, _onepole_plain(True), 4),
        # words: release_scale, stage, t; the two cumsums, twice
        Body("env_asr", 8, ("attack_time", "release_time"), 3,
             _env_plain("asr_closed_form"), 4),
        Body("env_ar", 9, ("attack_time", "release_time"), 3,
             _env_plain("ar_closed_form"), 4),
        Body("pan2", 10, ("pan",), 0, _pan2_plain),
        # the f32 phase; the increments, their prefix sums and the sums'
        # upper levels (core/dsp.py cumsum_base16)
        Body("sin_numeric", 11, ("freq", "phase_offset"), 1, _float_osc_plain(False), 3),
        Body("phasor", 12, ("freq",), 1, _float_osc_plain(True), 3),
        # words: frame, seed
        Body("white_noise", 13, (), 2, _white_noise_plain),
        # words: the ring (arg = L of them), then pos
        Body("sample_delay", 14, ("delay_time",), 1, _sample_delay_plain, ring=True),
    )
}
_BY_OP = {b.op: b for b in BODIES.values()}
# the bodies of chain_kernel_small, the kernel for programs of these alone
# (csrc/chain_kernel.cu)
SMALL_OPS = frozenset(BODIES[n].op for n in ("constant", "sinwt", "math", "math1"))


@dataclass
class ChainProgram:
    """A lowered chain: the int32 program (host copy) and its header counts.
    ``on(device)`` is the device copy, uploaded once."""

    words: Tuple[int, ...]
    n_planes: int  # planes the program reads (1 + the largest plane index)
    _device: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)
    _plans: Dict[Tuple, "LaunchPlan"] = field(default_factory=dict, repr=False)

    @property
    def period(self):
        return self.words[0]

    @property
    def n_carry(self):
        return self.words[1]

    @property
    def n_slots(self):
        return self.words[2]

    @property
    def n_ext(self):
        return self.words[3]

    @property
    def n_state(self):
        return self.words[4]

    @property
    def n_out(self):
        return self.words[5]

    @property
    def n_done(self):
        return self.words[6]

    @property
    def n_scratch(self):
        return self.words[7]

    @cached_property
    def has_ring(self) -> bool:
        """Whether a body of the program keeps a ring of state words
        (SampleDelay)."""
        return any(rec[0].ring for rec in self.records())

    @cached_property
    def all_bodies(self) -> bool:
        """Whether the program uses a body outside ``SMALL_OPS``: it then
        runs ``chain_kernel_all``, else ``chain_kernel_small``."""
        w = self.words
        return any(w[w[HEADER + self.n_carry + j]] not in SMALL_OPS
                   for j in range(self.period))

    def on(self, device) -> torch.Tensor:
        key = str(device)
        t = self._device.get(key)
        if t is None:
            t = self._device[key] = torch.tensor(self.words, dtype=torch.int32,
                                                 device=device)
        return t

    def records(self):
        """Per offset: (body, arg, inputs [[(kind, idx)]], params
        [(kind, idx)], outputs [(slot, plane)], state_row, done_plane)."""
        w = self.words
        recs = []
        for j in range(self.period):
            r = w[HEADER + self.n_carry + j]
            (op, arg, n_in, n_par, n_out, srow, in_tab, par_tab, out_tab,
             done) = w[r:r + RECORD]
            ins = []
            for c in range(n_in):
                start, count = w[in_tab + 2 * c], w[in_tab + 2 * c + 1]
                ins.append([(w[start + 2 * i], w[start + 2 * i + 1])
                            for i in range(count)])
            pars = [(w[par_tab + 2 * i], w[par_tab + 2 * i + 1]) for i in range(n_par)]
            outs = [(w[out_tab + 2 * c], w[out_tab + 2 * c + 1]) for c in range(n_out)]
            recs.append((_BY_OP[op], arg, ins, pars, outs, srow, done))
        return recs


def _validate(program, planes, state, rows, K, block_size):
    """Check the operands against the program; returns (K, B)."""
    if not isinstance(program, ChainProgram):
        raise TypeError(f"{KERNEL}: program must be a ChainProgram")
    if not isinstance(state, torch.Tensor):
        raise TypeError(f"{KERNEL}: state must be a tensor")
    K, B = int(K), int(block_size)
    if K < 1 or B < 1:
        raise ValueError(f"{KERNEL}: K and block_size must be at least 1, got {K}, {B}")
    dev = state.device
    bc.check(KERNEL, "state", state, torch.int32, (program.n_state, K), dev)
    if planes.dim() != 3 or planes.shape[0] < program.n_planes:
        raise ValueError(f"{KERNEL}: planes must be [>= {program.n_planes}, K, B]")
    bc.check(KERNEL, "planes", planes, torch.float32, (planes.shape[0], K, B), dev)
    bc.check(KERNEL, "rows", rows, torch.float32,
             (program.n_ext + program.n_carry, B), dev)
    return K, B


def chain_kernel(program, *, planes, state, rows, K, block_size, f2pi, scale,
                 sample_rate):
    """One block of one collapsed chain.

    program: the ``ChainProgram`` of the chain.
    planes:  f32 [n_planes, K, B] — the stage-stacked param planes (float
             params, then integer params as whole-number floats).
    state:   int32 [n_state, K] — the state words (32-bit bit patterns).
    rows:    f32 [n_ext + n_carry, B] — the external rows, then the carry
             rows stage 0 reads.
    f2pi, scale, sample_rate: f32-representable floats (the u32 phase units
             per Hz shared by SinWt and PolyBlep, SinWt's radians per table
             index, the sample rate).

    Returns (out f32 [n_out, K, B], state_out int32 [n_state, K], done bool
    [n_done, K, B]), new tensors. CPU tensors run ``chain_kernel_plain``;
    CUDA tensors launch the kernel."""
    operands = dict(planes=planes, state=state, rows=rows, K=K, block_size=block_size,
                    f2pi=f2pi, scale=scale, sample_rate=sample_rate)
    if state.device.type == "cpu":
        return chain_kernel_plain(program, **operands)
    outs = empty_outputs(program, state.device, K, block_size)
    launch(outs, program, **operands)
    return outs


def empty_outputs(program, device, K, block_size):
    """The kernel's output buffers: (out [n_out, K, B], state_out [n_state,
    K], done [n_done, K, B])."""
    K, B = int(K), int(block_size)
    return (torch.empty((program.n_out, K, B), dtype=torch.float32, device=device),
            torch.empty((program.n_state, K), dtype=torch.int32, device=device),
            torch.empty((program.n_done, K, B), dtype=torch.bool, device=device))


def row_floats(program, block_size) -> int:
    """The floats of the kernel's rows at ``block_size``: a row per slot
    (two for a carried slot, one per stage parity) and the bodies' scan
    scratch, B each."""
    return (program.n_slots + program.n_carry + program.n_scratch) * int(block_size)


def _round4(n):
    return (n + 3) // 4 * 4


def scalar_words(program) -> int:
    """The state words a stage of the program reads besides SampleDelay's
    rings: what the kernel prefetches for each stage."""
    return sum(rec[0].n_words for rec in program.records())


def smem_bytes(program, chunk, staged, global_rows=False, depth=2) -> int:
    """The dynamic shared memory a CTA of the kernel takes for ``chunk``
    samples with ``staged`` param planes staged ahead, ``depth`` stages at
    a time (2, or K when every stage is staged before the loop; the layout
    at the head of ``run_chain`` in csrc/chain_kernel.cu): the descriptors,
    the program, two mbarriers, the exchange slots, the rows (none with
    ``global_rows``), the staged rows, the scalar words of ``depth`` stages,
    the record headers, the words' state rows, the list of records the
    stage loop runs, the slots' forwarded sources and the records' word
    counts and skip flags."""
    n_prog, cs, n_words = len(program.words), _round4(int(chunk)), scalar_words(program)
    rows = 0 if global_rows else 4 * (row_floats(program, 1)) * cs
    return (16 * n_prog + 4 * _round4(n_prog) + 16 + 256 + rows + 4 * staged * depth * cs
            + 4 * _round4(depth * n_words) + 48 * program.period + 4 * _round4(n_words)
            + 4 * _round4(program.period) + 4 * _round4(2 * program.n_slots)
            + 4 * _round4(2 * program.period))


def stage_threads(n) -> int:
    """Threads of a CTA for ``n`` samples: whole warps, at most 1024
    (csrc/stage_scan.cuh stage_threads)."""
    return min(1024, (int(n) + 31) // 32 * 32)


@dataclass(frozen=True)
class LaunchPlan:
    """Where a launch keeps its rows (``layout``, one of ``LAYOUTS``), the
    CTAs of its cluster (1 but for "cluster"), the samples of each (``chunk``
    = B / cluster), its threads a CTA, its dynamic shared memory a CTA, the
    param planes it stages, and how (``staging``, one of ``STAGINGS``):
    every stage's planes and words before the stage loop ("whole"), two
    stages at a time ("ring"), or none, each stage reading its words and
    planes from device memory ("direct")."""

    layout: str
    cluster: int
    chunk: int
    threads: int
    smem_bytes: int
    staged: int
    staging: str


def _plan(program, B, K, layout, C):
    """The staging of a layout, as measured fastest on an H100 (PERF.md §6):
    one CTA stages every stage's words and as many planes' every stage as
    fit beside the rows, before the stage loop, where at least one plane
    fits (or the program has none); a cluster stages as many planes as fit
    two stages at a time for chains of RING_STAGES or more; everything else,
    and any program with a SampleDelay ring (whose long cascade ran 15-37%
    slower staged), reads its words and planes from device memory."""
    chunk, on_global = B // C, layout == "global"
    threads = stage_threads(chunk)
    fixed = smem_bytes(program, chunk, 0, on_global)
    direct = LaunchPlan(layout, C, chunk, threads, fixed, 0, "direct")
    if program.has_ring:
        return direct
    if C == 1:
        words = smem_bytes(program, chunk, 0, on_global, depth=K)
        per_plane = 4 * K * _round4(chunk)
        staged = min(program.n_planes, max(0, SMEM_LIMIT - words) // per_plane)
        if words <= SMEM_LIMIT and (staged or not program.n_planes):
            return LaunchPlan(layout, C, chunk, threads, words + per_plane * staged, staged,
                              "whole")
        return direct
    if K < RING_STAGES:
        return direct
    per_plane = 8 * _round4(chunk)
    staged = min(program.n_planes, max(0, SMEM_LIMIT - fixed) // per_plane)
    return LaunchPlan(layout, C, chunk, threads, fixed + per_plane * staged, staged, "ring")


def cluster_sizes(program, block_size, max_cluster=MAX_CLUSTER):
    """The cluster sizes a launch at ``block_size`` can take, smallest
    first: C up to ``max_cluster`` (2 or more) that split B into chunks of a
    multiple of 32 samples whose rows fit a CTA's shared memory."""
    B = int(block_size)
    return [C for C in range(2, max_cluster + 1)
            if B % C == 0 and (B // C) % 32 == 0
            and smem_bytes(program, B // C, 0) <= SMEM_LIMIT]


def launch_plan(program, block_size, K, *, cluster=None, global_rows=False,
                max_cluster=MAX_CLUSTER) -> LaunchPlan:
    """The layout of a launch of K stages at ``block_size``, chosen before
    it.

    One CTA with its rows in shared memory where B is at most
    ``SHARED_SAMPLES`` and the rows fit; else a cluster: the smallest power
    of two C (up to ``max_cluster``) with B / C at most ``CLUSTER_CHUNK``, or
    past that the smallest C of ``cluster_sizes`` whose rows fit; else, only
    when no cluster holds the rows, one CTA with its rows in the global
    workspace. ``cluster`` forces a cluster size (1: one CTA with shared
    rows) and ``global_rows`` the workspace; a forced layout that cannot
    hold the rows raises ValueError. The layout does not depend on K; the
    staging does (``_plan``)."""
    B, K = int(block_size), int(K)
    key = (B, K, cluster, bool(global_rows), max_cluster)
    plan = program._plans.get(key)
    if plan is None:
        plan = program._plans[key] = _choose(program, B, K, cluster, global_rows,
                                             max_cluster)
    return plan


def _choose(program, B, K, cluster, global_rows, max_cluster):
    if B < 1:
        raise ValueError(f"{KERNEL}: block_size must be at least 1, got {B}")
    if global_rows:
        if cluster not in (None, 1):
            raise ValueError(f"{KERNEL}: global rows take one CTA, not a cluster of {cluster}")
        return _plan(program, B, K, "global", 1)
    if cluster is not None:
        C = int(cluster)
        if C == 1 and smem_bytes(program, B, 0) <= SMEM_LIMIT:
            return _plan(program, B, K, "shared", 1)
        if C > 1 and C in cluster_sizes(program, B, max(C, max_cluster)):
            return _plan(program, B, K, "cluster", C)
        raise ValueError(f"{KERNEL}: a cluster of {C} cannot hold the rows of "
                         f"{B} samples ({row_floats(program, B)} floats)")
    if B <= SHARED_SAMPLES and smem_bytes(program, B, 0) <= SMEM_LIMIT:
        return _plan(program, B, K, "shared", 1)
    sizes = cluster_sizes(program, B, max_cluster)
    want = 2
    while B // want > CLUSTER_CHUNK and want < max_cluster:
        want *= 2
    if sizes:
        # the smallest power of two from `want` on, else the smallest that fits
        C = min(sizes, key=lambda c: (c < want or c & (c - 1) != 0, c))
        return _plan(program, B, K, "cluster", C)
    return _plan(program, B, K, "global", 1)


def rows_in_shared(program, block_size, max_cluster=MAX_CLUSTER) -> bool:
    """Whether a launch at ``block_size`` keeps its rows in shared memory,
    one CTA's or a cluster's (else in a global workspace)."""
    return launch_plan(program, block_size, 1, max_cluster=max_cluster).layout != "global"


_MAX_CLUSTER = {}


def card_max_cluster(lib, device) -> int:
    """The largest cluster ``launch_plan`` may take on ``device``'s card:
    ``MAX_CLUSTER`` where the card can hold a non-portable cluster that
    large, else ``PORTABLE_CLUSTER`` (asked once per device)."""
    key = device.index
    if key not in _MAX_CLUSTER:
        got = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.ktt_chain_max_cluster(SMEM_LIMIT, ctypes.byref(got))
        bc.raise_on_error(KERNEL, lib, err)
        _MAX_CLUSTER[key] = got.value
    return _MAX_CLUSTER[key]


_LIB = []


def _load():
    """The kernel library, its extra entry points declared (once)."""
    if not _LIB:
        from .build import load_library

        lib = load_library(KERNEL)
        lib.ktt_chain_max_cluster.restype = ctypes.c_int
        lib.ktt_chain_max_cluster.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.ktt_chain_error_name.restype = ctypes.c_char_p
        lib.ktt_chain_error_name.argtypes = [ctypes.c_int]
        _LIB.append(lib)
    return _LIB[0]


def launch_error(lib, err, plan) -> RuntimeError:
    """The error a failed launch raises: the CUDA error by name, and the
    plan the card refused."""
    return RuntimeError(
        f"{KERNEL}: the {plan.layout} launch (cluster {plan.cluster}, {plan.threads} "
        f"threads, {plan.smem_bytes} bytes of shared memory a CTA) failed with CUDA error "
        f"{err} {lib.ktt_chain_error_name(err).decode()} "
        f"({lib.ktt_error_string(err).decode()})")


def launch(outs, program, *, planes, state, rows, K, block_size, f2pi, scale,
           sample_rate, global_rows=False, cluster=None):
    """Launch the CUDA kernel on the current stream, writing ``outs`` (from
    ``empty_outputs``), in the layout ``launch_plan`` picks for the card
    (``cluster`` and ``global_rows`` force one, as there); the workspace of
    the global layout is allocated here. Raises for anything but CUDA
    tensors of the layout the program needs, and, with the CUDA error's
    name, if the card refuses the launch. Returns the plan."""
    global LAUNCHES
    K, B = _validate(program, planes, state, rows, K, block_size)
    device = state.device
    bc.require_cuda(KERNEL, device)
    out, state_out, done = outs
    bc.check(KERNEL, "out", out, torch.float32, (program.n_out, K, B), device)
    bc.check(KERNEL, "state_out", state_out, torch.int32, (program.n_state, K), device)
    bc.check(KERNEL, "done", done, torch.bool, (program.n_done, K, B), device)
    lib = _load()
    plan = launch_plan(program, B, K, cluster=cluster, global_rows=global_rows,
                       max_cluster=card_max_cluster(lib, device))
    workspace = (torch.empty((max(1, row_floats(program, 1) * _round4(B)),),
                             dtype=torch.float32, device=device)
                 if plan.layout == "global" else None)
    prog = program.on(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ktt_chain_kernel(
            bc.ptr(prog), bc.ptr(planes), bc.ptr(state), bc.ptr(rows), bc.ptr(out),
            bc.ptr(state_out), bc.ptr(done), K, B, len(program.words),
            LAYOUTS.index(plan.layout), plan.cluster, plan.threads, plan.smem_bytes,
            plan.staged, STAGINGS.index(plan.staging), int(program.all_bodies),
            ctypes.c_float(f2pi),
            ctypes.c_float(scale), ctypes.c_float(sample_rate), bc.ptr(workspace),
            ctypes.c_void_p(stream))
    if err != 0:
        raise launch_error(lib, err, plan)
    LAUNCHES += 1
    return plan


def chain_kernel_plain(program, *, planes, state, rows, K, block_size, f2pi, scale,
                       sample_rate):
    """``chain_kernel`` in plain torch: the same program, a Python loop over
    the K stages and p offsets with [B]-wide ops, each body's plain version
    in the kernel's order, on whatever device the tensors are on."""
    K, B = _validate(program, planes, state, rows, K, block_size)
    consts = tuple(float(np.float32(c)) for c in (f2pi, scale, sample_rate)) + (B,)
    recs = program.records()
    n_ext = program.n_ext
    carry_src = program.words[HEADER:HEADER + program.n_carry]
    carry = [rows[n_ext + i] for i in range(program.n_carry)]
    words = bc.u32_of(state)
    new_words = torch.zeros_like(words)
    dev = state.device
    out = torch.zeros((program.n_out, K, B), dtype=torch.float32, device=dev)
    done_out = torch.zeros((program.n_done, K, B), dtype=torch.bool, device=dev)
    for k in range(K):
        slots = {}

        def fetch(kind, idx):
            if kind == SRC_SLOT:
                return slots[idx]
            if kind == SRC_CARRY:
                return carry[idx]
            if kind == SRC_ROW:
                return rows[idx]
            return planes[idx, k]

        for body, arg, ins, pars, outs, srow, done_plane in recs:
            in_rows = []
            for srcs in ins:
                if not srcs:
                    in_rows.append(torch.zeros((B,), dtype=torch.float32, device=dev))
                    continue
                acc = fetch(*srcs[0])
                for s in srcs[1:]:
                    acc = acc + fetch(*s)
                in_rows.append(acc)
            n = body.words(arg)
            vals, new, *done = body.plain(arg, in_rows, [fetch(*s) for s in pars],
                                          words[srow:srow + n, k], consts)
            if n:
                new_words[srow:srow + n, k] = torch.cat([w.reshape(-1) for w in new])
            for (slot, plane), v in zip(outs, vals):
                slots[slot] = v
                if plane >= 0:
                    out[plane, k] = v
            if done_plane >= 0:
                done_out[done_plane, k] = done[0]
        carry = [slots[s] for s in carry_src]
    return out, bc.i32_of(new_words), done_out
