#!/usr/bin/env python3
"""Time the bank kernels of two source trees on one card, in turns.

    python3 tools/time_bank_kernel.py PARENT_TREE

PARENT_TREE is another checkout of the repository (for example the parent
commit unpacked by ``git archive`` into ``build/parent``). The script runs
four processes one after another, parent, this tree, this tree, parent; each
builds its own tree's bank libraries and times ``launch()`` into
preallocated outputs of every bank kernel at V = 131,072 voices: the generic kernel with
each body (Sine, FM, Subtractive, Additive at 16 harmonics, Envelope on the
suite's looping 4-segment program, Modal on the bell, M = 12), the
wavetable kernel (16 harmonics) and, as controls, the sine, FM and
subtractive kernels. Each at B = 64 and 1024, event-free and eventful (the
first ``event_capacity`` events of ``chip_smoke.py``'s schedule), from the
state every voice triggered once and four event-free blocks rendered. The
launches are captured in a CUDA graph and replayed between CUDA events
(``time_graph``), so that the host's launch rate (the wrappers check their
operands in Python, tens of microseconds a call) stays out of the device
time of the short kernels; beside it, the eager time (CUDA events over
back-to-back launches, ``chip_smoke.time_call``), which is what a render
sees. For the hand kernels (sine, FM, subtractive, wavetable) it also
captures the wrapper, ``bank.kernel(**operands)``, the same way: the
kernel plus whatever the wrapper launches after it (a tree whose kernel
leaves its mix as warp partials sums them there), so that two trees whose
kernels split the work differently time the same work. It prints one line
per (kernel, B, variant): each tree's faster run and the ratio this tree /
parent, then the card's ``name, power.limit``.
Needs a CUDA card.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("sine", "fm", "sub", "wt", "generic-sine", "generic-fm", "generic-subtractive",
         "generic-additive", "generic-envelope", "generic-modal")
HAND = ("sine", "fm", "sub", "wt")
BLOCKS = (64, 1024)
V = 131072
CAPACITY = 4096  # benchmarks/suite.py's event_capacity for the banks


def time_graph(torch, fn, reps):
    """Device ms a call of ``fn``: ``reps`` calls captured in one CUDA graph
    on a side stream (after a warm-up call there), the graph replayed once,
    then timed with CUDA events over one more replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_bank(cs, ktt, np, kind):
    """chip_smoke's bank of ``kind`` with its benchmark's seeded defaults."""
    if kind == "generic-envelope":
        rng = np.random.default_rng(0)
        d = {"freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
             "amp": np.full(V, 0.002, np.float32),
             "pan": rng.uniform(-1, 1, V).astype(np.float32),
             "time_scale": rng.uniform(0.5, 2.0, V).astype(np.float32)}
        voice = ktt.EnvelopeVoice(ktt.Envelope(0.0, cs.SUITE_ENV, looping=True))
        return ktt.FusedVoiceBank(voice, V, voice_defaults=d, event_capacity=CAPACITY)
    if kind == "generic-modal":
        return cs.modal_bank(ktt, np, V, CAPACITY, "bell")
    return cs.make_bank(ktt, np, kind, V, CAPACITY)


def child(tree):
    """Time ``tree``'s bank kernels; print one JSON line {kind: {key: ms}}."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import knaster_tpu_torch as ktt
    from knaster_tpu_torch.kernels import build

    build.build_all(("sine_bank", "fm_bank", "sub_bank", "wt_bank", "generic_bank"))
    dev = torch.device("cuda", 0)
    got = {}
    for kind in KINDS:
        bank = make_bank(cs, ktt, np, kind)
        mod = cs.kernel_module(kind)
        ctx = ktt.AudioCtx(cs.SR, 64, torch.float32)
        state = bank.init(ctx, device=dev)
        trig_name = "t_strike" if "t_strike" in bank._trig_names else "t_restart"
        trig = bank.trig_index(trig_name)
        for base in range(0, V, CAPACITY):
            ev = bank.node_events_from_lists(
                [(0, v, trig, 1, 0.0) for v in range(base, base + CAPACITY)])
            state, _ = bank.process(ctx, state, events=ev)
        for _ in range(4):
            state, _ = bank.process(ctx, state)
        got[kind] = {}
        for B in BLOCKS:
            ctx = ktt.AudioCtx(cs.SR, B, torch.float32)
            sched = (cs.body_schedule if kind in ("generic-envelope", "generic-modal")
                     else cs.schedule)(bank, V, B)[0][:CAPACITY]
            for variant, events in (("event-free", None),
                                    ("eventful", bank.node_events_from_lists(sched))):
                ops, _ = bank.kernel_operands(ctx, state, events)
                if mod.KERNEL == "generic_bank":
                    outs = mod.empty_outputs(ops["carry"], bank.voice.outputs, B)
                else:
                    outs = mod.empty_outputs(next(ops[n] for n, _, _ in bank.STATE), B)
                reps = 200 if B == 64 else 30
                got[kind][f"{B} {variant}"] = time_graph(
                    torch, lambda: mod.launch(outs, **ops), reps)
                got[kind][f"{B} {variant} eager"] = cs.time_call(
                    torch, lambda: mod.launch(outs, **ops), reps)
                if kind in HAND:
                    got[kind][f"{B} {variant} wrapper"] = time_graph(
                        torch, lambda: bank.kernel(**ops), reps)
    print("TIMES " + json.dumps(got), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    parent = os.path.abspath(sys.argv[1])
    runs = []
    for tree in (parent, HERE, HERE, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                             capture_output=True, text=True, cwd=tree, timeout=1800)
        lines = [l for l in out.stdout.splitlines() if l.startswith("TIMES ")]
        if out.returncode != 0 or not lines:
            sys.exit(f"timing {tree} failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        runs.append((tree, json.loads(lines[0][6:])))
    best = {}
    for tree, got in runs:
        for kind, per_key in got.items():
            for key, ms in per_key.items():
                best[(tree, kind, key)] = min(best.get((tree, kind, key), ms), ms)
    for kind in KINDS:
        for B in BLOCKS:
            for variant in ("event-free", "eventful"):
                key = f"{B} {variant}"
                p, c = best[(parent, kind, key)], best[(HERE, kind, key)]
                pe, ce = best[(parent, kind, key + " eager")], best[(HERE, kind, key + " eager")]
                print(f"bank {kind} V={V} B={B} {variant}: parent {p:.4f} ms, this tree "
                      f"{c:.4f} ms, ratio {c / p:.3f}; eager {pe:.4f} -> {ce:.4f} ms")
                if kind in HAND:
                    pw, cw = (best[(tree, kind, key + " wrapper")] for tree in (parent, HERE))
                    print(f"bank {kind} V={V} B={B} {variant} wrapper: parent {pw:.4f} ms, "
                          f"this tree {cw:.4f} ms, ratio {cw / pw:.3f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed")


if __name__ == "__main__":
    main()
