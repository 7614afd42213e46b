#!/usr/bin/env python3
"""Time the chain kernel of two source trees on one card, in turns.

    python3 tools/time_chain_kernel.py PARENT_TREE [--reps-scale S]

PARENT_TREE is another checkout of the repository (for example the parent
commit unpacked by ``git archive`` into ``build/parent``). The script runs
four processes one after another, parent, this tree, this tree, parent; each
builds its own tree's chain-kernel library and times ``launch()`` (CUDA
events over back-to-back launches into preallocated outputs, after one
warm-up launch) on the chain paths of ``chip_smoke.py`` at B in 16, 64,
1024 and 8192, and the 256-stage FM cascade's chain at 131,072 samples
(its B = 1024 operands tiled 128 times). It prints one line per (path, B):
each tree's faster run and the ratio this tree / parent, then the card's
``name, power.limit``. Needs a CUDA card.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("fm_cascade", "polyblep_cascade", "graphic_eq_31", "phasor_cascade",
         "sin_numeric_cascade", "noise_chain", "echo_chain", "sample_delay_cascade")
BLOCKS = (16, 64, 1024, 8192)
LONG = 131072  # one 128-block render chunk at B = 1024


def reps_for(B):
    return 200 if B <= 1024 else (20 if B <= 8192 else 3)


def child(tree):
    """Time ``tree``'s kernel; print one JSON line {path: {B: ms}}."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import knaster_tpu_torch as kt
    from knaster_tpu_torch.kernels import build
    from knaster_tpu_torch.kernels import chain_kernel as kck

    build.build_all(("chain_kernel",))
    dev = torch.device("cuda", 0)
    builders = {"fm_cascade": lambda kt_, gg: cs.build_cascade(kt_, gg, cs.CASCADE)}
    builders.update(cs.chain_paths(kt))
    builders.update(cs.float_osc_paths(kt))
    builders.update(cs.noise_delay_paths(kt))
    got = {}
    for name in PATHS:
        got[name] = {}
        for B in BLOCKS:
            g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B),
                                            device=dev)
            g.edit(lambda gg: builders[name](kt, gg))
            program, ops = cs.capture_chain(torch, proc)
            runs = [(B, ops)]
            if name == "fm_cascade" and B == 1024:
                runs.append((LONG, cs.tile_operands(torch, ops, LONG // B)))
            for length, run in runs:
                outs = kck.empty_outputs(program, dev, run["K"], length)
                got[name][length] = cs.time_call(
                    torch, lambda: kck.launch(outs, program, **run), reps_for(length))
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
    for name in PATHS:
        for B in BLOCKS + ((LONG,) if name == "fm_cascade" else ()):
            p, c = best[(parent, name, B)], best[(HERE, name, B)]
            print(f"chain_kernel {name} B={B}: parent {p:.4f} ms, this tree {c:.4f} ms, "
                  f"ratio {c / p:.3f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed")


if __name__ == "__main__":
    main()
