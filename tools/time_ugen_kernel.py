#!/usr/bin/env python3
"""Time the UGen kernels of two source trees on one card, in turns.

    python3 tools/time_ugen_kernel.py PARENT_TREE

PARENT_TREE is another checkout of the repository (for example the parent
commit unpacked by ``git archive`` into ``build/parent``). The script runs
four processes one after another, parent, this tree, this tree, parent;
each builds its own tree's UGen kernel libraries and times ``launch()`` of

- ``buffer_reader``: one mono reader at B = 64 and 512 (``buffer_player``'s
  block and superblock) and 8192, and 16,384 readers at B = 64;
- ``env_asr``: the state machine for one envelope at B = 64, the base-16
  closed form at 704 (``live_edit``'s shapes), both closed forms at 8192,
  and all three paths for 16,384 envelopes at B = 64 (a voice bank's
  width);
- as controls, ``galactic`` at B = 64 and 704, ``svf_filter`` for one
  filter at B = 64 and 704 and ``pink_noise`` for one generator at B = 64,

each on the operands its tree's ``chip_smoke.py`` makes (``reader_block``,
``env_asr_operands``, ``galactic_operands``, ``svf_block_operands``, f32).
The launches are captured in a CUDA graph and replayed between CUDA events
(``time_graph``), so that the host's launch rate (the wrappers check
their operands in Python, tens of microseconds a call) stays out of the
device time; beside it, the eager time (CUDA events over back-to-back
launches, ``chip_smoke.time_call``), which is what a render sees. It
prints one line per (kernel, shape): each tree's faster run and the ratio
this tree / parent, the spread of this tree's two runs, then the card's
``name, power.limit``. Needs a CUDA card.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READER = ((1, 64), (1, 512), (1, 8192), (16384, 64))
ENV = ((1, 64, "step"), (1, 704, "base16"), (1, 8192, "hillis_steele"), (1, 8192, "base16"),
       (16384, 64, "step"), (16384, 64, "hillis_steele"), (16384, 64, "base16"))
CONTROLS = (("galactic", 64), ("galactic", 704), ("svf_filter", 64), ("svf_filter", 704),
            ("pink_noise", 64))


def child(tree):
    """Time ``tree``'s UGen kernels; print one JSON line {shape: ms}."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import knaster_tpu_torch as ktt
    from knaster_tpu_torch.core.dsp import cumsum, cumsum_base16
    from knaster_tpu_torch.kernels import (build, buffer_reader, env_asr, galactic, pink_noise,
                                           svf_filter)

    build.build_all(("buffer_reader", "env_asr", "galactic", "svf_filter", "pink_noise"))
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    calls = {}
    for n, B in READER:
        buf, state, planes = cs.reader_block(torch, np, n, B, 1, f32, dev, 40)
        calls[f"buffer_reader n={n} B={B}"] = (
            lambda buf=buf, state=state, planes=planes: buffer_reader.launch(buf, state, *planes))
    paths = {"step": (False, cumsum), "hillis_steele": (True, cumsum),
             "base16": (True, cumsum_base16)}
    for n, B, path in ENV:
        ops = cs.env_asr_operands(torch, np, n, B, f32, dev, 120)
        calls[f"env_asr n={n} B={B} {path}"] = (
            lambda ops=ops, path=path: env_asr.launch(*ops, *paths[path]))
    for name, B in CONTROLS:
        if name == "galactic":
            ops = cs.galactic_operands(torch, np, ktt, B, f32, dev, 90)
            calls[f"galactic B={B}"] = lambda ops=ops: galactic.launch(*ops)
        elif name == "svf_filter":
            ic, x, params = cs.svf_block_operands(torch, np, 1, B, f32, dev, 70)
            calls[f"svf_filter n=1 B={B}"] = (
                lambda ic=ic, x=x, params=params: svf_filter.launch(ic, x, *params, cs.SR))
        else:
            state = {"seed": torch.zeros(1, dtype=torch.int32, device=dev),
                     "frame": torch.zeros(1, dtype=torch.int32, device=dev),
                     "whites": torch.zeros((1, pink_noise.OCTAVES), dtype=f32, device=dev),
                     "always_on": torch.zeros(1, dtype=f32, device=dev),
                     "counter": torch.ones(1, dtype=torch.int32, device=dev),
                     "pink": torch.zeros(1, dtype=f32, device=dev)}
            calls[f"pink_noise n=1 B={B}"] = (
                lambda state=state, B=B: pink_noise.launch(state, B))
    got = {}
    for key, fn in calls.items():
        reps = 20 if "8192" in key else 100
        got[key] = cs.time_graph(torch, fn, reps)
        got[key + " eager"] = cs.time_call(torch, fn, reps)
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
    best, mine = {}, {}
    for tree, got in runs:
        for key, ms in got.items():
            best[(tree, key)] = min(best.get((tree, key), ms), ms)
            if tree == HERE:
                mine.setdefault(key, []).append(ms)
    for key in runs[0][1]:
        if key.endswith(" eager"):
            continue
        p, c = best[(parent, key)], best[(HERE, key)]
        pe, ce = best[(parent, key + " eager")], best[(HERE, key + " eager")]
        spread = max(mine[key]) / min(mine[key]) - 1.0
        print(f"{key}: parent {p:.4f} ms, this tree {c:.4f} ms, ratio {c / p:.3f} (this "
              f"tree's two runs {spread * 100:.1f}% apart); eager {pe:.4f} -> {ce:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed")


if __name__ == "__main__":
    main()
