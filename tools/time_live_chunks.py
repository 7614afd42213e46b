#!/usr/bin/env python3
"""Time the live soak's chunks on the card, without the stream's threads.

    python3 tools/time_live_chunks.py [bank cascade ir edit]

For each scenario of ``tools/realtime_soak.py`` (at its sizes): the warm
(``warm_for_stream(64)``) in seconds, then host ms of a 64-block chunk
rendered as the stream renders it (``render(fetch=False)`` and a
synchronize), five event-free and five after one round of the scenario's
live control each, with the kernels one eventful chunk launches
(torch.profiler) and the host's time by torch op in it: the ops a chunk,
and the TOP_OPS ops of most self time with their calls. ``cascade`` runs
twice: with the chain kernel, and with every chain on the scan executor
(``graph.chain_kernel._MODE = "0"``), which is where a trigger block's
chain ran before its untouched stages took the kernel. Prints one line a
scenario and mode, then the host's speed on two fixed probes (the µs of
one small op launched back to back, ``x.add_(1)`` on 64 floats on the
card, and the ms of a pure-Python loop of 1e6 additions: chunks measured
on two hosts are set against each other by them), and the card's name
and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 64
TOP_OPS = 6


def chunk_ms(torch, render, n=5):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def profile_chunk(torch, run):
    """(kernels, torch ops, [(op, host self ms, calls)] of the TOP_OPS ops
    of most host time) of ``run()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    ops = [e for e in avgs if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP_OPS]
    return (sum(e.count for e in avgs if e.device_type == DeviceType.CUDA),
            sum(e.count for e in ops),
            [(e.key[6:], e.self_cpu_time_total / 1e3, e.count) for e in top])


def host_probes(torch, dev):
    """(µs of one small op launched back to back on ``dev``, ms of a
    pure-Python loop of 1e6 additions)."""
    x = torch.zeros(64, device=dev)
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10000):
        x.add_(1)
    op_us = 1e6 * (time.perf_counter() - t0) / 10000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = 0
    for i in range(1000000):
        acc += i
    return op_us, 1e3 * (time.perf_counter() - t0)


def main(argv):
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_live_chunks.py: no CUDA card")
    import knaster_tpu_torch as kt
    import knaster_tpu_torch.graph.chain_kernel as tck
    import realtime_soak as rs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    runs = [(s, None) for s in (argv or rs.SCENARIOS)]
    if "cascade" in (argv or rs.SCENARIOS):
        runs.append(("cascade", "0"))
    for scenario, mode in runs:
        tck._MODE = mode
        rng = np.random.default_rng(0)
        g, proc = rs.processor(kt, dev)
        h = g.edit(lambda gg: rs.build(kt, gg, scenario, rng))
        t0 = time.perf_counter()
        proc.warm_for_stream(CHUNK)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0

        def chunk():
            proc.render(frames=CHUNK * rs.BLOCK, fetch=False)

        group = [0]

        def eventful():
            if scenario == "edit":
                g.edit(lambda gg: (gg.push(kt.SinWt(300.0)) * 0.002).to_graph_out())
            else:
                rs.control_round(kt, scenario, g, h, rng, group[0])
            group[0] += 1
            chunk()

        free = chunk_ms(torch, chunk)
        ev = chunk_ms(torch, eventful)
        n_k, n_ops, top = profile_chunk(torch, eventful)
        print(f"{scenario} (chain kernel {'off' if mode == '0' else 'on'}) on {card}: warm "
              f"{warm:.3f} s; event-free chunk ms {[round(x, 2) for x in free]}; eventful "
              f"chunk ms {[round(x, 2) for x in ev]}; {n_k} kernels and {n_ops} torch ops in "
              "an eventful chunk (profiled), the most host time: "
              + ", ".join(f"{k} {ms:.2f} ms / {n}" for k, ms, n in top), flush=True)
    tck._MODE = None
    op_us, py_ms = host_probes(torch, dev)
    print(f"host: {op_us:.2f} us a small op launched back to back, {py_ms:.1f} ms for 1e6 "
          "Python additions")
    print(card)


if __name__ == "__main__":
    main(sys.argv[1:])
