#!/usr/bin/env python3
"""Time the FM cascade kernel of two source trees on one card, in turns, beside the chain kernel.

    python3 tools/time_fm_cascade.py PARENT_TREE

PARENT_TREE is another checkout of the repository (for example the parent
commit unpacked by ``git archive`` into ``build/parent``). The script runs
four processes one after another, parent, this tree, this tree, parent; each
builds its own tree's ``fm_cascade`` and ``chain_kernel`` libraries and
times, at B in {16, 64, 1024, 8192} (CUDA events over back-to-back
launches into preallocated outputs, after one warm-up launch,
``chip_smoke.time_call``): ``fm_cascade``'s ``launch()`` at N = 256 stages
on ``chip_smoke.py``'s default params, in the layout its tree picks, and
the chain kernel on the same 256-stage cascade built as graph nodes
(``chip_smoke.build_cascade``, its lowered program as the graph gives it).
It prints one line per (kernel, B): each tree's faster run and the ratio
this tree / parent, and this tree's fm_cascade against the chain kernel in
the same processes; then the card's ``name, power.limit``. Needs a CUDA
card.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = (16, 64, 1024, 8192)


def child(tree):
    """Time ``tree``'s two kernels; print one JSON line {kernel: {B: ms}}."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import knaster_tpu_torch as kt
    from knaster_tpu_torch.kernels import build
    from knaster_tpu_torch.kernels import chain_kernel as kck
    from knaster_tpu_torch.kernels import fm_cascade as kfc

    build.build_all(("fm_cascade", "chain_kernel"))
    dev = torch.device("cuda", 0)
    f2pi, scale = cs.stage_consts(np)
    params = torch.tensor(cs.FM_PARAM_SETS[0][1], dtype=torch.float32, device=dev)
    got = {"fm_cascade": {}, "chain_kernel": {}}
    for B in BLOCKS:
        reps = 200 if B <= 1024 else 50
        ph = cs.u32_near_top(torch, np, cs.CASCADE, 0, dev)
        buf = torch.empty((B,), dtype=torch.float32, device=dev)
        ops = dict(params=params, phases=ph, block_size=B, f2pi=f2pi, scale=scale)
        got["fm_cascade"][B] = cs.time_call(torch, lambda: kfc.launch(buf, **ops), reps)
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B),
                                        device=dev)
        g.edit(lambda gg: cs.build_cascade(kt, gg, cs.CASCADE))
        program, cops = cs.capture_chain(torch, proc)
        outs = kck.empty_outputs(program, dev, cops["K"], B)
        got["chain_kernel"][B] = cs.time_call(
            torch, lambda: kck.launch(outs, program, **cops), reps)
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
        for name, per_b in got.items():
            for B, ms in per_b.items():
                key = (tree, name, int(B))
                best[key] = min(best.get(key, ms), ms)
    for B in BLOCKS:
        for name in ("fm_cascade", "chain_kernel"):
            p, c = best[(parent, name, B)], best[(HERE, name, B)]
            print(f"{name} N=256 B={B}: parent {p:.4f} ms, this tree {c:.4f} ms, "
                  f"ratio {c / p:.3f}")
        fc, ch = best[(HERE, "fm_cascade", B)], best[(HERE, "chain_kernel", B)]
        print(f"this tree B={B}: fm_cascade {fc:.4f} ms against the chain kernel "
              f"{ch:.4f} ms on the same cascade, ratio {fc / ch:.3f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed")


if __name__ == "__main__":
    main()
