#!/usr/bin/env python3
"""Drive the PyTorch port's headline path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device — a CUDA card is required; prints its name and power limit;
2. build — compiles the port's CUDA kernel from ``knaster_tpu_torch/csrc``;
3. kernel vs plain — both variants of the sine-bank kernel against the
   plain torch version on the card, at V in {1000, 131072} and
   B in {48, 64, 1024}, over eventful blocks (triggers, releases, float
   sets, smoothing configs, a depth-3 burst, active/note-on flags,
   saturating and negative frequencies) and event-free blocks with ramps
   in flight; carried state bit-equal, mix within a stated tolerance;
4. slice — ``bench.py``'s sequence through ``FusedSineVoiceBank``: 131,072
   voices at B=64, 48 kHz, every voice triggered through 512 staged
   eventful blocks, then 750 event-free blocks (1 s of audio); checks the
   mix, that every voice sounds, that every block launched the kernel, and
   prints voice-samples/s.

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
N_VOICES = 131072  # bench.py's bank
BLOCK = 64
N_BLOCKS = SR // BLOCK  # 750 event-free blocks: 1 s of audio


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
    # the number of terms (~sqrt(V)) and the magnitude of the sum
    return 1e-5 * math.sqrt(V / 1024.0) * max(1.0, peak)


def bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def compare_block(sb, operands, label):
    """Run the kernel and the plain version on the same operands; require
    bit-equal state and the mix within tolerance. Returns (kernel outputs,
    max |mix difference|)."""
    import torch

    k = sb.sine_bank(**operands)
    p = sb.sine_bank_plain(**operands)
    torch.cuda.synchronize()
    for name, a, b in zip(("phase", "stage", "t", "rscale"), k[1:], p[1:]):
        if not torch.equal(bits(a), bits(b)):
            n = int((bits(a) != bits(b)).sum())
            fail(f"{label}: {name} differs from the plain version in {n} voices")
    if not bool(torch.isfinite(k[0]).all()):
        fail(f"{label}: non-finite mix")
    err = float((k[0] - p[0]).abs().max())
    peak = float(p[0].abs().max())
    V = operands["phase"].shape[0]
    if err > mix_tolerance(V, peak):
        fail(f"{label}: mix differs by {err} (peak {peak}, tolerance "
             f"{mix_tolerance(V, peak)})")
    return k, err


def schedule(bank, V, B):
    """Per-block event lists: an eventful block exercising every event
    kind, event-free blocks with ramps in flight, a release block."""
    tr, tq = bank.trig_index("t_restart"), bank.trig_index("t_release")
    fi, ai, pi = (bank.float_index(n) for n in ("freq", "amp", "pan"))
    ev0 = [(v % B, v, tr, 1, 0.0) for v in range(0, V, 3)]
    ev0 += [(B // 2, v, tq, 1, 0.0) for v in range(0, V, 9)]  # attack -> release
    ev0 += [
        (0, 7, fi, 0, 1234.0),                 # jump
        (B // 3, 8, ai, 0, 0.05),              # mid-block amp set
        (0, 9, pi, 4, float(2 * B)),           # smoothing config ...
        (1, 9, pi, 0, 0.9),                    # ... then a pan ramp over 2 blocks
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
    ev3 = [(v % B, v, tq, 1, 0.0) for v in range(1, V, 3)]   # sustain -> release
    ev3 += [(0, 13, ai, 3, 1.0), (B // 2, 20, tr, 1, 0.0)]
    return [ev0, None, None, ev3, None]


def phase_kernel_vs_plain(torch, np, dev, FusedSineVoiceBank, AudioCtx, sb):
    max_err = 0.0
    for V in (1000, N_VOICES):
        for B in (48, 64, 1024):
            rng = np.random.default_rng(V + B)
            defaults = {
                "freq": rng.uniform(100.0, 4000.0, V).astype(np.float32),
                "amp": np.full(V, 0.01, np.float32),
                "pan": rng.uniform(-1.0, 1.0, V).astype(np.float32),
            }
            ctx = AudioCtx(SR, B, torch.float32)
            bank = FusedSineVoiceBank(V, voice_defaults=defaults,
                                      event_capacity=V)
            state = bank.init(ctx, device=dev)
            # phases near the top of the u32 range: the add must wrap
            state["phase"] = torch.from_numpy(
                rng.integers(2**32 - 2**26, 2**32, V, dtype=np.uint64)
                .astype(np.uint32).view(np.int32)).to(dev)
            peak = 0.0
            for blk, evs in enumerate(schedule(bank, V, B)):
                events = None if evs is None else bank.node_events_from_lists(evs)
                operands, carry = bank.kernel_operands(ctx, state, events)
                k, err = compare_block(sb, operands, f"V={V} B={B} block {blk}")
                max_err = max(max_err, err)
                peak = max(peak, float(k[0].abs().max()))
                state, _ = bank.finish(ctx, carry, k)
            if peak == 0.0:
                fail(f"V={V} B={B}: silent mix")
            print(f"kernel vs plain V={V} B={B}: state bit-equal over 5 blocks, "
                  f"max |mix diff| so far {max_err:.3e}, peak {peak:.4f}")
    return max_err


def phase_slice(torch, np, dev, FusedSineVoiceBank, ctx, sb, card):
    """bench.py's sequence through the bank's public API; returns (bank,
    final state, kernel launches, render seconds, host enqueue seconds)."""
    rng = np.random.default_rng(0)
    defaults = {
        "freq": rng.uniform(100.0, 4000.0, N_VOICES).astype(np.float32),
        "amp": np.full(N_VOICES, 0.01, np.float32),
        "pan": rng.uniform(-1.0, 1.0, N_VOICES).astype(np.float32),
    }
    bank = FusedSineVoiceBank(N_VOICES, voice_defaults=defaults)
    state = bank.init(ctx, device=dev)
    trig = bank.trig_index("t_restart")
    cap = bank.event_capacity
    stages = [
        bank.node_events_from_lists(
            [(0, v, trig, 1, 0.0) for v in range(base, min(base + cap, N_VOICES))])
        for base in range(0, N_VOICES, cap)
    ]
    B = ctx.block_size
    outs = torch.empty((N_BLOCKS, 2, B), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()

    sb.LAUNCHES = 0
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
    launches = sb.LAUNCHES

    if len(stages) != N_VOICES // cap:
        fail(f"expected {N_VOICES // cap} staged trigger blocks, built {len(stages)}")
    if launches != len(stages) + N_BLOCKS:
        fail(f"kernel launched {launches} times for "
             f"{len(stages) + N_BLOCKS} blocks")
    if n_sounding != N_VOICES:
        fail(f"only {n_sounding} of {N_VOICES} voices sound after triggering")
    if not bool(torch.isfinite(outs).all()):
        fail("non-finite samples in the rendered mix")
    peak = float(outs.abs().max())
    if peak == 0.0:
        fail("the rendered mix is silent")
    if int((state["stage"] != 0).sum()) != N_VOICES:
        fail("voices stopped sounding during the event-free render")
    vs_per_s = N_VOICES * N_BLOCKS * B / t_render
    print(f"slice: {N_VOICES} voices, {len(stages)} trigger blocks in "
          f"{t_trigger:.3f} s, {N_BLOCKS} event-free blocks in {t_render:.4f} s "
          f"(host enqueue {t_enqueue:.4f} s), mix peak {peak:.3f}, "
          f"launches {launches}")
    print(f"slice: {vs_per_s:.6g} voice-samples/s event-free "
          f"({vs_per_s / (600 * SR):.1f}x the 600-voice reference) on {card}")
    return bank, state, launches, t_render, t_enqueue


def profile_blocks(torch, bank, ctx, state, n=100):
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
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile: {n} event-free blocks, device busy {busy_us / n:.2f} us/block "
          f"of {wall_us / n:.2f} us/block wall under the profiler "
          f"({100 * busy_us / wall_us:.1f}% busy), "
          f"{sum(e.count for e in kernels) / n:.1f} kernels/block")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    from knaster_tpu_torch import AudioCtx, FusedSineVoiceBank
    from knaster_tpu_torch.kernels import build
    from knaster_tpu_torch.kernels import sine_bank as sb

    dev = torch.device("cuda", 0)
    card = card_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- kernel vs plain --------------------------------------------------
    max_err = phase_kernel_vs_plain(torch, np, dev, FusedSineVoiceBank,
                                    AudioCtx, sb)

    # -- the slice: bench.py's sequence -----------------------------------
    ctx = AudioCtx(SR, BLOCK, torch.float32)
    bank, state, launches, t_render, t_enqueue = phase_slice(
        torch, np, dev, FusedSineVoiceBank, ctx, sb, card)
    cap = bank.event_capacity

    # the slice's final state, one more block, kernel against plain
    operands, _ = bank.kernel_operands(ctx, state, None)
    _, err = compare_block(sb, operands, "slice final block")
    max_err = max(max_err, err)

    # -- timings at the main path's shape (V=131072, B=64) ----------------
    # kernel: back-to-back launches into preallocated outputs (device-bound);
    # wrapper: sine_bank() as the bank calls it (allocation + partial sum)
    outs = sb.empty_outputs(operands["phase"], BLOCK)
    ms = time_call(torch, lambda: sb.launch(outs, **operands), 200)
    wrapper_ms = time_call(torch, lambda: sb.sine_bank(**operands), 200)
    plain_ms = time_call(torch, lambda: sb.sine_bank_plain(**operands), 3)
    ev_ops, _ = bank.kernel_operands(
        ctx, state, bank.node_events_from_lists(schedule(bank, N_VOICES, BLOCK)[0][:cap]))
    ev_ms = time_call(torch, lambda: sb.launch(outs, **ev_ops), 100)
    ev_plain_ms = time_call(torch, lambda: sb.sine_bank_plain(**ev_ops), 3)
    block_ms = 1e3 * t_render / N_BLOCKS
    print(f"timing V={N_VOICES} B={BLOCK} on {card}: event-free kernel "
          f"{ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms; "
          f"eventful kernel {ev_ms:.4f} ms, plain {ev_plain_ms:.3f} ms; "
          f"event-free block wall {block_ms:.4f} ms, "
          f"host enqueue {1e3 * t_enqueue / N_BLOCKS:.4f} ms/block")
    profile_blocks(torch, bank, ctx, state)

    print(json.dumps({"kernels": [{
        "name": "sine_bank",
        "route": "cuda",
        "source": "knaster_tpu_torch/csrc/sine_bank.cu",
        "replaces": "knaster_tpu/parallel/pallas_bank.py:714",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
