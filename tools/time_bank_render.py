#!/usr/bin/env python3
"""Time the banks end to end, through their public API, for two source trees on one card, in turns.

    python3 tools/time_bank_render.py PARENT_TREE

PARENT_TREE is another checkout of the repository (for example the parent
commit unpacked by ``git archive`` into ``build/parent``). The script runs
four processes one after another, parent, this tree, this tree, parent; each
imports its own tree's package and ``chip_smoke.py`` and, at 131,072 voices
(the modal bank 65,536), B = 64, 48 kHz, with ``chip_smoke.py``'s seeded
defaults:

- the hand sine and subtractive banks and every bank on the generic or
  wavetable kernel (``sine``, ``sub``, ``wt``, ``generic-sine``, ``-fm``,
  ``-subtractive``, ``-additive``, ``envelope_bank``, ``modal_bank``):
  every voice triggered, then three renders of 750
  event-free blocks (1 s of audio) through ``bank.process``, each timed
  between synchronizes: voice-samples/s; and torch.profiler's kernels a
  block over 100 more blocks;
- ``pool_envelope_bank`` (a ``VoicePool`` driving a 131,072-voice
  ``FusedVoiceBank(EnvelopeVoice())`` graph node, 1,024 note-ons a block
  for 128 blocks): three 2 s renders with 128-block superblocks, each from
  a fresh processor: realtime x.

It prints, per metric, each tree's runs (all of them: the host's spread is
the point) and the median of each tree, then the card's ``name,
power.limit``. Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANKS = ("sine", "sub", "wt", "generic-sine", "generic-fm", "generic-subtractive", "generic-additive",
         "envelope_bank", "modal_bank")
RENDERS = 3


def make_bank(cs, ktt, np, kind):
    """(bank, trigger name, voices) of ``kind`` as ``chip_smoke.py`` makes it."""
    if kind == "envelope_bank":
        V = cs.N_VOICES
        rng = np.random.default_rng(0)
        d = {"freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
             "amp": np.full(V, 0.002, np.float32),
             "pan": rng.uniform(-1, 1, V).astype(np.float32),
             "time_scale": rng.uniform(0.5, 2.0, V).astype(np.float32)}
        voice = ktt.EnvelopeVoice(ktt.Envelope(0.0, cs.SUITE_ENV, looping=True))
        bank = ktt.FusedVoiceBank(voice, V, voice_defaults=d,
                                  event_capacity=cs.SUITE_CAPACITY)
        return bank, "t_restart", V
    if kind == "modal_bank":
        V = cs.MODAL_VOICES
        return cs.modal_bank(ktt, np, V, cs.SUITE_CAPACITY, "bell"), "t_strike", V
    return (cs.make_bank(ktt, np, kind, cs.N_VOICES, cs.SUITE_CAPACITY), "t_restart",
            cs.N_VOICES)


def kernels_per_block(torch, bank, ctx, state, n=100):
    """torch.profiler's CUDA kernel count a block over ``n`` event-free blocks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = bank.process(ctx, state)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sum(e.count for e in kernels) / n


def child(tree):
    """Measure ``tree``; print one JSON line {metric: [runs]}."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import knaster_tpu_torch as ktt
    from knaster_tpu_torch.kernels import build

    build.build_all(("sine_bank", "sub_bank", "wt_bank", "generic_bank"))
    dev = torch.device("cuda", 0)
    ctx = ktt.AudioCtx(cs.SR, cs.BLOCK, torch.float32)
    got = {}
    for kind in BANKS:
        bank, trig_name, V = make_bank(cs, ktt, np, kind)
        state = bank.init(ctx, device=dev)
        trig = bank.trig_index(trig_name)
        cap = bank.event_capacity
        for base in range(0, V, cap):
            ev = bank.node_events_from_lists(
                [(0, v, trig, 1, 0.0) for v in range(base, min(base + cap, V))])
            state, _ = bank.process(ctx, state, events=ev)
        rates = []
        for _ in range(RENDERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(cs.N_BLOCKS):
                state, _ = bank.process(ctx, state)
            torch.cuda.synchronize()
            rates.append(V * cs.N_BLOCKS * cs.BLOCK / (time.perf_counter() - t0))
        got[f"{kind} voice-samples/s"] = rates
        got[f"{kind} kernels/block"] = [kernels_per_block(torch, bank, ctx, state)]
    frames = int(cs.GRAPH_SECONDS * cs.SR)
    rt = []
    for _ in range(RENDERS):
        proc, _, _ = cs.pool_processor(torch, np, ktt, dev, cs.CHUNK)
        proc._ensure_compiled()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proc.render(frames=frames, fetch=False)
        torch.cuda.synchronize()
        rt.append(frames / cs.SR / (time.perf_counter() - t0))
    got["pool_envelope_bank realtime x"] = rt
    print("RESULTS " + json.dumps(got), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    parent = os.path.abspath(sys.argv[1])
    runs = {parent: {}, HERE: {}}
    for tree in (parent, HERE, HERE, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                             capture_output=True, text=True, cwd=tree, timeout=1800)
        lines = [l for l in out.stdout.splitlines() if l.startswith("RESULTS ")]
        if out.returncode != 0 or not lines:
            sys.exit(f"measuring {tree} failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        for metric, values in json.loads(lines[0][8:]).items():
            runs[tree].setdefault(metric, []).extend(values)
    for metric in runs[parent]:
        p, c = runs[parent][metric], runs[HERE][metric]
        print(f"{metric}: parent {', '.join(f'{x:.6g}' for x in p)} (median "
              f"{statistics.median(p):.6g}); this tree {', '.join(f'{x:.6g}' for x in c)} "
              f"(median {statistics.median(c):.6g})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed")


if __name__ == "__main__":
    main()
