#!/usr/bin/env python3
"""Drive the PyTorch port's fused voice banks on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device — a CUDA card is required; prints its name and power limit;
2. build — compiles every CUDA kernel of ``knaster_tpu_torch/csrc``, one
   nvcc per source, all at once;
3. kernel vs plain — each kernel (sine, FM, subtractive, wavetable, and the
   generic harness with its Sine, FM, Subtractive and Additive bodies) in
   both variants against its plain torch version on the card, at V in
   {1000, 131072} and B in {48, 64, 1024}, over eventful blocks (restarts,
   releases for the ASR voices, float sets, smoothing configs with ramps
   in flight, a depth-3 burst, active/note-on flags, saturating and
   negative frequencies) and event-free blocks; carried state bit-equal,
   mix within a stated tolerance;
4. slices — each bank through its public API at 131,072 voices, B=64,
   48 kHz, with the JAX package's seeded defaults: the sine bank through
   ``bench.py``'s sequence (512 staged trigger blocks of 256 events), the
   FM, generic-FM, subtractive and wavetable banks through 32 staged
   trigger blocks of 4096 events (``benchmarks/suite.py``'s
   event_capacity); then 750 event-free blocks (1 s of audio). Checks that
   every block launched the bank's kernel (its launch counter, reset just
   before), that every voice sounded, that the mix is finite and not
   silent, that the generic FM bank matches the hand FM bank, and prints
   voice-samples/s (and two more renders' rates, for the host's spread);
5. timings and profile — per kernel at V=131072, B=64: kernel ms (CUDA
   events over back-to-back ``launch()`` calls into preallocated outputs),
   wrapper ms and plain ms, event-free and eventful; then torch.profiler's
   device time by kernel over 100 event-free blocks of each bank.

The last lines are the kernel table (JSON), the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SR = 48000
N_VOICES = 131072  # bench.py's and benchmarks/suite.py's banks
BLOCK = 64
N_BLOCKS = SR // BLOCK  # 750 event-free blocks: 1 s of audio
SUITE_CAPACITY = 4096  # benchmarks/suite.py's event_capacity for the banks
H = 16  # bench_wavetable_bank's partials

# the TPU kernel each port kernel replaces
REPLACES = {
    "sine_bank": "knaster_tpu/parallel/pallas_bank.py:714",
    "fm_bank": "knaster_tpu/parallel/pallas_bank.py:915",
    "sub_bank": "knaster_tpu/parallel/pallas_bank.py:1093",
    "wt_bank": "knaster_tpu/parallel/pallas_bank.py:1325",
    "generic_bank": "knaster_tpu/parallel/generic_bank.py:103",
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_name_and_limit():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0].strip()


def mix_tolerance(V, peak):
    # the kernel sums each sample's mix as a warp tree plus a torch.sum over
    # warp partials, the plain version as one torch.sum over V: the same
    # terms in another order, so the f32 rounding differs and grows with
    # the number of terms (~sqrt(V)) and the magnitude of the sum. Kernels
    # that take sinf/cosf (wavetable, generic Sine/Additive) may differ from
    # torch's by an ulp per term, far below this bound at these amplitudes
    return 1e-5 * math.sqrt(V / 1024.0) * max(1.0, peak)


def bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


# --------------------------------------------------------------------------
# the banks: seeded defaults as the JAX package's benchmarks set them
# --------------------------------------------------------------------------

def sine_defaults(np, V, seed=0, amp=0.01):
    """bench.py's bank (bench.py:40-45)."""
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(100.0, 4000.0, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32),
            "pan": rng.uniform(-1.0, 1.0, V).astype(np.float32)}


def fm_defaults(np, V, seed=0, amp=0.005):
    """benchmarks/suite.py:550-555 (bench_fm_bank, bench_generic_bank)."""
    rng = np.random.default_rng(seed)
    return {"freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
            "ratio": rng.choice([0.5, 1.0, 2.0, 3.0], V).astype(np.float32),
            "index": rng.uniform(0.5, 3.0, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32)}


def sub_defaults(np, V, seed=0, amp=1e-4):
    """benchmarks/suite.py:837-842 (bench_subtractive_bank)."""
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(55, 880, V).astype(np.float32),
            "cutoff": rng.uniform(400, 8000, V).astype(np.float32),
            "q": rng.uniform(0.7, 4.0, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32)}


def wt_defaults(np, V, seed=0, amp=1e-4):
    """benchmarks/suite.py:771-778 (bench_wavetable_bank)."""
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(50, 2000, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32)}


def saw_table(ktt):
    """bench_wavetable_bank's table: a saw of H harmonics."""
    nb = ktt.NonAaWavetable()
    nb.add_saw(1, H + 1, 1.0)
    return nb.buffer


def make_bank(ktt, np, kind, V, capacity, seed=0, amp=None):
    """A bank of one kind with its benchmark's seeded defaults. Kinds:
    sine, fm, sub, wt (the hand banks) and generic-<body>."""
    amp_kw = {} if amp is None else {"amp": amp}
    if kind == "sine":
        return ktt.FusedSineVoiceBank(
            V, voice_defaults=sine_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    if kind == "fm":
        return ktt.FusedFMVoiceBank(
            V, voice_defaults=fm_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    if kind == "sub":
        return ktt.FusedSubtractiveVoiceBank(
            V, voice_defaults=sub_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    if kind == "wt":
        return ktt.FusedWavetableVoiceBank(
            V, table=saw_table(ktt), n_harmonics=H,
            voice_defaults=wt_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    body = kind.split("-", 1)[1]
    voice, defaults = {
        "sine": (ktt.SineVoice(), sine_defaults),
        "fm": (ktt.FMVoice(), fm_defaults),
        "subtractive": (ktt.SubtractiveVoice(), sub_defaults),
        "additive": (ktt.AdditiveVoice(table=saw_table(ktt), n_harmonics=H),
                     wt_defaults),
    }[body]
    return ktt.FusedVoiceBank(voice, V, voice_defaults=defaults(np, V, seed, **amp_kw),
                              event_capacity=capacity)


# the other float param each schedule ramps, and its target
OTHER = {"pan": 0.9, "ratio": 3.0, "cutoff": 900.0}


def schedule(bank, V, B):
    """Per-block event lists adapted to the voice's params: an eventful
    block exercising every event kind, event-free blocks with ramps in
    flight, a second eventful block (releases for the ASR voices, more
    restarts for the AR one)."""
    tr = bank.trig_index("t_restart")
    tq = bank.trig_index("t_release") if "t_release" in bank._trig_names else None
    fi, ai = bank.float_index("freq"), bank.float_index("amp")
    other = next(n for n in bank._float_names if n in OTHER)
    oi = bank.float_index(other)
    ev0 = [(v % B, v, tr, 1, 0.0) for v in range(0, V, 3)]
    if tq is not None:
        ev0 += [(B // 2, v, tq, 1, 0.0) for v in range(0, V, 9)]  # attack -> release
    ev0 += [
        (0, 7, fi, 0, 1234.0),                 # jump
        (B // 3, 8, ai, 0, 0.05),              # mid-block amp set
        (0, 9, oi, 4, float(2 * B)),           # smoothing config ...
        (1, 9, oi, 0, OTHER[other]),           # ... then a ramp over 2 blocks
        (0, 11, fi, 4, float(3 * B)),
        (2, 11, fi, 0, 2500.0),                # freq ramp in flight for 3 blocks
        (B // 4, 12, fi, 0, 700.0),            # depth-3 burst on one slot:
        (B // 2, 12, fi, 4, 0.0),              #   set, freeze, set
        (3 * B // 4, 12, fi, 0, 300.0),
        (0, 13, ai, 3, 0.0),                   # set inactive
        (0, 14, ai, 5, 0.0),                   # note-on
        (5 % B, 15, fi, 0, 1.0e5),             # saturating increment
        (6 % B, 16, fi, 0, -300.0),            # negative frequency: no advance
        (0, 17, fi, 4, float(B)),
        (B - 1, 17, fi, 0, 1.0e5),             # ramp into saturation
    ]
    second = tq if tq is not None else tr
    ev3 = [(v % B, v, second, 1, 0.0) for v in range(1, V, 3)]  # sustain -> release
    ev3 += [(0, 13, ai, 3, 1.0), (B // 2, 20, tr, 1, 0.0)]
    return [ev0, None, None, ev3, None]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def kernel_module(kind):
    from knaster_tpu_torch.kernels import (fm_bank, generic_bank, sine_bank,
                                           sub_bank, wt_bank)

    if kind.startswith("generic"):
        return generic_bank
    return {"sine": sine_bank, "fm": fm_bank, "sub": sub_bank, "wt": wt_bank}[kind]


def plain_of(mod):
    return getattr(mod, mod.KERNEL + "_plain")


def compare_block(torch, kind, bank, operands, label):
    """Run the kernel and the plain version on the same operands; require
    bit-equal state and the mix within tolerance. Returns (kernel outputs,
    max |mix difference|)."""
    mod = kernel_module(kind)
    k = bank.kernel(**operands)
    p = plain_of(mod)(**operands)
    torch.cuda.synchronize()
    for n, (a, b) in enumerate(zip(k[1:], p[1:])):
        if not torch.equal(bits(a), bits(b)):
            diff = int((bits(a) != bits(b)).sum())
            fail(f"{label}: state output {n} differs from the plain version "
                 f"in {diff} words")
    if not bool(torch.isfinite(k[0]).all()):
        fail(f"{label}: non-finite mix")
    err = float((k[0] - p[0]).abs().max())
    peak = float(p[0].abs().max())
    V = bank.n_voices
    if err > mix_tolerance(V, peak):
        fail(f"{label}: mix differs by {err} (peak {peak}, tolerance "
             f"{mix_tolerance(V, peak)})")
    return k, err


def phase_kernel_vs_plain(torch, np, ktt, dev, kind, Vs=(1000, N_VOICES),
                          Bs=(48, 64, 1024)):
    """One kernel (or generic body) against its plain version over the
    schedule at every V and B; returns the max |mix difference|."""
    max_err = 0.0
    for V in Vs:
        for B in Bs:
            ctx = ktt.AudioCtx(SR, B, torch.float32)
            bank = make_bank(ktt, np, kind, V, capacity=V, seed=V + B, amp=0.01)
            state = bank.init(ctx, device=dev)
            # phases near the top of the u32 range: the add must wrap
            rng = np.random.default_rng(V + B)
            for name in ("phase", "phm", "phc"):
                if name in state:
                    state[name] = torch.from_numpy(
                        rng.integers(2**32 - 2**26, 2**32, V, dtype=np.uint64)
                        .astype(np.uint32).view(np.int32)).to(dev)
            peak = 0.0
            for blk, evs in enumerate(schedule(bank, V, B)):
                events = None if evs is None else bank.node_events_from_lists(evs)
                operands, carry = bank.kernel_operands(ctx, state, events)
                k, err = compare_block(torch, kind, bank, operands,
                                       f"{kind} V={V} B={B} block {blk}")
                max_err = max(max_err, err)
                peak = max(peak, float(k[0].abs().max()))
                state, _ = bank.finish(ctx, carry, k)
            if peak == 0.0:
                fail(f"{kind} V={V} B={B}: silent mix")
        print(f"kernel vs plain {kind} V={V} B={Bs}: state bit-equal over "
              f"5 blocks each, max |mix diff| so far {max_err:.3e}")
    return max_err


def trigger_stages(bank):
    """Every voice triggered once, in eventful blocks of event_capacity
    restart events at frame 0."""
    trig = bank.trig_index("t_restart")
    cap = bank.event_capacity
    V = bank.n_voices
    return [bank.node_events_from_lists(
                [(0, v, trig, 1, 0.0) for v in range(base, min(base + cap, V))])
            for base in range(0, V, cap)]


def reset_counts():
    for kind in ("sine", "fm", "sub", "wt", "generic"):
        kernel_module(kind).LAUNCHES = 0


def read_counts():
    return {kernel_module(k).KERNEL: kernel_module(k).LAUNCHES
            for k in ("sine", "fm", "sub", "wt", "generic")}


def phase_slice(torch, np, ktt, dev, kind, card, sustains):
    """The bank's benchmark sequence through its public API: every voice
    triggered through staged eventful blocks, then 750 event-free blocks.
    Returns (bank, final state, kernel launches, mix [750, C, B],
    render seconds, host enqueue seconds)."""
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    capacity = 256 if kind == "sine" else SUITE_CAPACITY  # bench.py / suite.py
    bank = make_bank(ktt, np, kind, N_VOICES, capacity)
    state = bank.init(ctx, device=dev)
    stages = trigger_stages(bank)
    outs = torch.empty((N_BLOCKS, bank.voice.outputs, BLOCK), dtype=torch.float32,
                       device=dev)
    name = kernel_module(kind).KERNEL
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    for ev in stages:
        state, out = bank.process(ctx, state, events=ev)
    torch.cuda.synchronize()
    t_trigger = time.perf_counter() - t0
    n_sounding = int((state["stage"] != 0).sum())
    t0 = time.perf_counter()
    for b in range(N_BLOCKS):
        state, out = bank.process(ctx, state)
        outs[b].copy_(out)
    t_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    counts = read_counts()

    if len(stages) != -(-N_VOICES // capacity):
        fail(f"{kind}: built {len(stages)} staged trigger blocks")
    launches = counts[name]
    if launches != len(stages) + N_BLOCKS:
        fail(f"{kind}: {name} launched {launches} times for "
             f"{len(stages) + N_BLOCKS} blocks")
    if any(n for k, n in counts.items() if k != name):
        fail(f"{kind}: other kernels launched during its slice: {counts}")
    if n_sounding != N_VOICES:
        fail(f"{kind}: only {n_sounding} of {N_VOICES} voices sound after triggering")
    if not bool(torch.isfinite(outs).all()):
        fail(f"{kind}: non-finite samples in the rendered mix")
    peak = float(outs.abs().max())
    if peak == 0.0:
        fail(f"{kind}: the rendered mix is silent")
    n_end = int((state["stage"] != 0).sum())
    if sustains and n_end != N_VOICES:
        fail(f"{kind}: only {n_end} voices still sound after the event-free render")
    # two more renders of the same length, after the counts were read: the
    # host's share of the wall time varies, so print the spread within
    # this call (the voices do the same work whether sounding or not)
    renders = [t_render]
    for _ in range(2):
        t0 = time.perf_counter()
        for b in range(N_BLOCKS):
            state, _ = bank.process(ctx, state)
        torch.cuda.synchronize()
        renders.append(time.perf_counter() - t0)
    rates = [N_VOICES * N_BLOCKS * BLOCK / t for t in renders]
    print(f"slice {kind}: {N_VOICES} voices, {len(stages)} trigger blocks in "
          f"{t_trigger:.3f} s, {N_BLOCKS} event-free blocks in {t_render:.4f} s "
          f"(host enqueue {t_enqueue:.4f} s), mix peak {peak:.4g}, launches "
          f"{launches}, {n_end} voices sounding at the end")
    print(f"slice {kind}: {rates[0]:.6g} voice-samples/s event-free "
          f"({rates[0] / (600 * SR):.1f}x the 600-voice reference) on {card}; "
          f"two more renders: {rates[1]:.6g}, {rates[2]:.6g}")
    return bank, state, launches, outs, t_render, t_enqueue


def profile_blocks(torch, kind, bank, ctx, state, n=100):
    """Device time by kernel over ``n`` event-free blocks (torch.profiler,
    CUPTI). Prints the device-busy share of the profiled window and the
    kernels that fill it; the profiler's own host cost inflates the wall
    time, so the share is a lower bound on the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = bank.process(ctx, state)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print(f"profile {kind}: the profiler recorded no device time (not measured)")
        return
    print(f"profile {kind}: {n} event-free blocks, device busy "
          f"{busy_us / n:.2f} us/block of {wall_us / n:.2f} us/block wall under the "
          f"profiler ({100 * busy_us / wall_us:.1f}% busy), "
          f"{sum(e.count for e in kernels) / n:.1f} kernels/block")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / n:9.2f} us/block  x{e.count // n:<3d} "
              f"{e.key[:90]}")


def time_call(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def empty_outputs(mod, bank, operands):
    if mod.KERNEL == "generic_bank":
        return mod.empty_outputs(operands["carry"], bank.voice.outputs, BLOCK)
    first = next(operands[n] for n, _, _ in bank.STATE)
    return mod.empty_outputs(first, BLOCK)


def phase_timings(torch, ktt, kind, bank, state, card):
    """Kernel, wrapper and plain ms at V=131072, B=64, both variants."""
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    mod = kernel_module(kind)
    plain = plain_of(mod)
    ops, _ = bank.kernel_operands(ctx, state, None)
    outs = empty_outputs(mod, bank, ops)
    ms = time_call(torch, lambda: mod.launch(outs, **ops), 200)
    wrapper_ms = time_call(torch, lambda: bank.kernel(**ops), 200)
    plain_ms = time_call(torch, lambda: plain(**ops), 3)
    cap = bank.event_capacity
    ev = bank.node_events_from_lists(schedule(bank, N_VOICES, BLOCK)[0][:cap])
    ev_ops, _ = bank.kernel_operands(ctx, state, ev)
    ev_ms = time_call(torch, lambda: mod.launch(outs, **ev_ops), 100)
    ev_wrapper_ms = time_call(torch, lambda: bank.kernel(**ev_ops), 100)
    ev_plain_ms = time_call(torch, lambda: plain(**ev_ops), 3)
    print(f"timing {kind} V={N_VOICES} B={BLOCK} on {card}: event-free kernel "
          f"{ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms; "
          f"eventful kernel {ev_ms:.4f} ms, wrapper {ev_wrapper_ms:.4f} ms, "
          f"plain {ev_plain_ms:.3f} ms")
    return ms, plain_ms


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    import knaster_tpu_torch as ktt
    from knaster_tpu_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    paths = build.build_all()
    for name in paths:
        build.load_library(name)
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, so in paths.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- kernel vs plain --------------------------------------------------
    t0 = time.perf_counter()
    errs = {}
    for kind in ("sine", "fm", "sub", "wt", "generic-sine", "generic-fm",
                 "generic-subtractive", "generic-additive"):
        name = kernel_module(kind).KERNEL
        errs[name] = max(errs.get(name, 0.0),
                         phase_kernel_vs_plain(torch, np, ktt, dev, kind))
    print(f"kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- the slices -------------------------------------------------------
    t0 = time.perf_counter()
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    results = {}
    for kind, sustains in (("sine", True), ("fm", False), ("generic-fm", False),
                           ("sub", True), ("wt", True)):
        bank, state, launches, outs, _, _ = phase_slice(
            torch, np, ktt, dev, kind, card, sustains)
        # the slice's final state, one more block, kernel against plain
        operands, _ = bank.kernel_operands(ctx, state, None)
        _, err = compare_block(torch, kind, bank, operands,
                               f"slice {kind} final block")
        name = kernel_module(kind).KERNEL
        errs[name] = max(errs[name], err)
        results[kind] = (bank, state, launches, outs)
    # the generic harness with the FM body against the hand FM bank
    (_, s_hand, _, o_hand), (_, s_gen, _, o_gen) = results["fm"], results["generic-fm"]
    for key in ("phm", "phc", "stage", "t", "idle"):
        if not torch.equal(s_hand[key], s_gen[key]):
            fail(f"generic FM slice: {key} differs from the hand FM bank")
    gap = float((o_hand - o_gen).abs().max())
    if gap > 5e-7 * math.sqrt(N_VOICES / 512):
        fail(f"generic FM slice: mix differs from the hand FM bank by {gap}")
    print(f"slice generic-fm vs fm: state equal, max |mix diff| {gap:.3e}")
    print(f"slices: {time.perf_counter() - t0:.1f} s")

    # -- timings and profile at the main path's shape ---------------------
    t0 = time.perf_counter()
    table = []
    for kind in ("sine", "fm", "sub", "wt", "generic-fm"):
        bank, state, launches, _ = results[kind]
        ms, plain_ms = phase_timings(torch, ktt, kind, bank, state, card)
        profile_blocks(torch, kind, bank, ctx, state)
        name = kernel_module(kind).KERNEL
        table.append({
            "name": name,
            "route": "cuda",
            "source": f"knaster_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
        })
    print(f"timings and profile: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
