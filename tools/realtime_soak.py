#!/usr/bin/env python3
"""The realtime soak on the port: ``StreamBackend`` with live control.

    python3 tools/realtime_soak.py [--seconds 8] [--scenario all|bank|cascade|ir|edit]
                                   [--device cuda] [--voices 131072]
                                   [--cascade-nodes 256] [--ir-seconds 2]

The four scenarios of benchmarks/realtime_soak.py, at its sizes (48 kHz,
B = 64, 64-block chunks, a 96-block ring), rebuilt on ``knaster_tpu_torch``:

* ``bank`` — a ``FusedSineVoiceBank`` of 131,072 voices (event capacity
  512; freq U(80, 3000), amp 5e-5, pan U(-1, 1) from ``default_rng(0)``);
  every ~100 ms 64 restarts, the releases of the cluster two rounds back
  and 8 freq sets;
* ``cascade`` — 256 ``SinWt``, each modulating the next's freq (one
  collapsed chain); every ~100 ms a root freq set and a rotating
  ``reset_phase`` trigger;
* ``ir`` — ``PinkNoise(seed=11)`` x 0.2 into a 2 s stereo ``Convolver``
  (dry_wet 0.4); every ~100 ms four dry_wet sets at random offsets inside
  the next chunk;
* ``edit`` — 64 ``SinWt`` x 0.002; a node pushed and one freed, about two
  structural edits a second (async recompile).

Each runs ``--seconds`` of wall with the control loop on the calling
thread, then one more second for the last edit to sound: the window the
row's numbers come from. Then one more second of live control under
torch.profiler (its underruns counted apart), and the row, one JSON line: underruns, ``audio_consumed_s``, ``live_events``, the peak,
``startup_s`` (the warm and the prefill), the producer's chunks (their
host wall: the render, not the copy to the host; the card's work runs on
behind it), ``frames_written`` against the
wall, the device-busy share over the profiled second (the trace of
every thread: kernel, copy and fill time over its wall; "not measured"
where it records none), and for
``edit`` the edit-to-audible time: from ``graph.edit`` returning to the
consumer's reading the first frame of the program swapped in for it, as a
median and a max, and the compile worker's compiles: how many, how many
were program-cache hits, and the host ms medians of a compile (plan and
build) and of its warm. ``soak()`` is what chip_smoke.py's ``phase_live`` calls;
it raises where a thread of the stream failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SR = 48000
BLOCK = 64
CHUNK_BLOCKS = 64
LOOKAHEAD = 96
V = 131072
SCENARIOS = ("bank", "cascade", "ir", "edit")
GRACE_S = 1.0  # the stream runs on after the control loop: the last edit sounds


def build_bank(kt, g, rng, n_voices=V):
    bank = g.push(kt.FusedSineVoiceBank(
        n_voices, event_capacity=512,
        voice_defaults={
            "freq": rng.uniform(80, 3000, n_voices).astype(np.float32),
            "amp": np.full(n_voices, 5e-5, np.float32),
            "pan": rng.uniform(-1, 1, n_voices).astype(np.float32),
        },
    ))
    bank.to_graph_out()
    return bank


def build_cascade(kt, g, n=256):
    prev, sines = None, []
    for i in range(n):
        s = g.push(kt.SinWt(100.0 + i))
        sines.append(s)
        if prev is not None:
            mod = (prev * 100.0) + 200.0
            g.connect_param(g.handle(mod.channels[0][1]), 0, s, "freq")
        prev = s
    sig = prev * 0.1
    sig.to_graph_out()  # left
    sig.to_graph_out_channels([1])  # right: the same mono bus
    return sines


def impulse_response(seconds=2.0):
    t = np.arange(int(seconds * SR), dtype=np.float32) / SR
    decay = np.exp(-3.0 * t)
    rr = np.random.default_rng(3)
    return np.stack([rr.standard_normal(t.size).astype(np.float32) * decay,
                     rr.standard_normal(t.size).astype(np.float32) * decay]) * 0.02


def build_ir(kt, g, seconds=2.0):
    src = g.push(kt.PinkNoise(seed=11))
    conv = g.push(kt.Convolver(impulse_response(seconds), inputs=1, dry_wet=0.4))
    (src * 0.2).to(conv)
    conv.to_graph_out()  # stereo IR: both channels
    return conv


def build_edit(kt, g):
    hs = []
    for i in range(64):
        s = g.push(kt.SinWt(200.0 + 7.0 * i))
        (s * 0.002).to_graph_out()
        hs.append(s)
    return hs


def build(kt, g, scenario, rng, voices=V, cascade_nodes=256, ir_seconds=2.0):
    """The scenario's graph; returns its handles."""
    if scenario == "bank":
        return build_bank(kt, g, rng, voices)
    if scenario == "cascade":
        return build_cascade(kt, g, cascade_nodes)
    if scenario == "ir":
        return build_ir(kt, g, ir_seconds)
    return build_edit(kt, g)


def processor(kt, device):
    opts = kt.AudioProcessorOptions(block_size=BLOCK, sample_rate=SR)
    return kt.AudioProcessor.new(0, 2, opts, device=device)


def control_round(kt, scenario, graph, handles, rng, group, n_voices=V):
    """One ~100 ms round of the scenario's live control (edit: one
    structural edit); returns the events sent."""
    if scenario == "bank":
        trig = handles.voice_param("t_restart")
        rel = handles.voice_param("t_release")
        freqp = handles.voice_param("freq")
        base = (group * 64) % n_voices
        for v in range(base, base + 64):
            trig.trig(v)
        old = ((group - 2) * 64) % n_voices
        if group >= 2:
            for v in range(old, old + 64):
                rel.trig(v)
        for v in range(base, base + 8):
            freqp.set(v, float(rng.uniform(200, 2000)))
        return 64 + (64 if group >= 2 else 0) + 8
    if scenario == "cascade":
        handles[0].param("freq").set(float(rng.uniform(80, 160)))
        handles[(group * 17) % len(handles)].param("reset_phase").trig()
        return 2
    if scenario == "ir":
        dw = handles.param("dry_wet")
        for _ in range(4):
            off = int(rng.integers(0, CHUNK_BLOCKS * BLOCK))
            dw.set_after(float(rng.uniform(0.1, 0.9)), kt.Seconds.from_samples(off, SR))
        return 4
    raise ValueError(scenario)


def start_profiler(torch):
    """torch.profiler over the card's activity from every thread (the
    stream's threads launch the kernels), keeping only the trace where this
    torch can: its events are read after the stream stops."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    try:
        cfg = _ExperimentalConfig(profile_all_threads=True, trace_only=True)
    except TypeError:
        cfg = _ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA],
                                  experimental_config=cfg)
    prof.start()
    return prof


def busy_share(prof, wall_s):
    """The device-busy share of a profiled window: the kernels', copies'
    and fills' time in its trace over its wall, or None where the trace
    holds none."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    us = sum(e.get("dur", 0) for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return us / (1e6 * wall_s) if us else None


def soak(kt, torch, scenario, seconds=8.0, device="cuda", voices=V, cascade_nodes=256,
         ir_seconds=2.0, profile=True):
    """Stream ``scenario`` for ``seconds`` of wall with its control loop;
    returns (its row, see the module docstring; the processor). Raises
    where a stream thread failed."""
    rng = np.random.default_rng(0)
    graph, proc = processor(kt, device)
    handles = graph.edit(lambda g: build(kt, g, scenario, rng, voices, cascade_nodes,
                                         ir_seconds))
    reads = []  # (time, ring frames read) after each consumed block
    peak, consumed = [0.0], [0]
    backend = None

    def consumer(block):
        consumed[0] += block.shape[1]
        peak[0] = max(peak[0], float(np.abs(block).max()))
        reads.append((time.perf_counter(), backend.ring.frames_read))

    backend = kt.StreamBackend(SR, BLOCK, consumer=consumer, chunk_blocks=CHUNK_BLOCKS,
                               lookahead_blocks=LOOKAHEAD)
    # the producer's chunks (render without the copy to the host), host wall each
    chunk_s, render = [], proc.render

    def timed_render(*a, **k):
        t = time.perf_counter()
        out = render(*a, **k)
        if k.get("fetch") is False:
            chunk_s.append(time.perf_counter() - t)
        return out

    proc.render = timed_render
    frame0 = graph.clock.frames
    t0 = time.perf_counter()
    backend.start_processing(proc)
    startup_s = time.perf_counter() - t0
    t_start = time.perf_counter()
    n_events, group, edits = 0, 0, []
    hs = list(handles) if scenario == "edit" else None

    def control(until, record):
        """The control loop until ``until``; the edits count if ``record``."""
        nonlocal n_events, group
        while time.perf_counter() < until and backend.error is None:
            if scenario == "edit":
                def push_one(gg):
                    s = gg.push(kt.SinWt(float(rng.uniform(150, 2000))))
                    (s * 0.002).to_graph_out()
                    return s

                hs.append(graph.edit(push_one))
                if record:
                    edits.append((graph.revision, time.perf_counter()))
                time.sleep(0.25)
                if len(hs) > 66 and time.perf_counter() < until:
                    victim = hs.pop(0)
                    graph.edit(lambda gg: victim.free())
                    if record:
                        edits.append((graph.revision, time.perf_counter()))
                time.sleep(0.25)
            else:
                n_events += control_round(kt, scenario, graph, handles, rng, group, voices)
                time.sleep(0.1)
            group += 1

    prof, prof_wall = None, None
    try:
        control(t_start + seconds, True)
        time.sleep(GRACE_S)  # the last edit sounds
        # the gated window ends here; then one more second of live control
        # under the profiler, whose cost stays out of the window's numbers
        wall = time.perf_counter() - t_start
        written, underruns = backend.ring.frames_written, backend.underruns
        audio_s, window_peak = consumed[0] / SR, peak[0]
        n_chunks = len(chunk_s)
        if profile and torch.device(device).type == "cuda":
            prof, t_prof = start_profiler(torch), time.perf_counter()
            control(t_prof + 1.0, False)
            prof.stop()
            prof_wall = time.perf_counter() - t_prof
    finally:
        backend.stop()  # raises what a stream thread raised
    share = busy_share(prof, prof_wall) if prof is not None else None
    row = {
        "bench": "realtime_soak", "scenario": scenario,
        "config": f"block{BLOCK}_chunk{CHUNK_BLOCKS}_la{LOOKAHEAD}",
        "underruns": underruns,
        "wall_s": wall, "control_s": seconds,
        "audio_consumed_s": audio_s,
        "frames_written": written,
        "written_over_wall": written / (wall * SR),
        "live_events": len(edits) if scenario == "edit" else n_events,
        "peak": window_peak,
        "startup_s": startup_s,
        "chunks": n_chunks,
        "chunk_ms_median": 1e3 * float(np.median(chunk_s[:n_chunks])) if n_chunks else None,
        "chunk_ms_max": 1e3 * max(chunk_s[:n_chunks]) if n_chunks else None,
        "busy_share": share if share is not None else "not measured",
        "underruns_profiled": backend.underruns - underruns,
        "device": str(proc.device),
    }
    if scenario == "edit":
        lat, missing = edit_latencies(edits, proc.swaps, reads, frame0)
        row["edits"] = len(edits)
        row["edits_not_audible"] = missing
        row["edit_to_audible_s_median"] = float(np.median(lat)) if lat else None
        row["edit_to_audible_s_max"] = float(max(lat)) if lat else None
        # the compile worker's compiles (the stream's own warm excluded)
        worker = [c for c in proc.compiles if c["warm_ms"] is not None]
        row["compiles"] = len(worker)
        row["cache_hits"] = sum(c["hit"] for c in worker)
        row["compile_ms_median"] = (float(np.median([c["plan_ms"] + c["build_ms"]
                                                     for c in worker])) if worker else None)
        row["warm_ms_median"] = (float(np.median([c["warm_ms"] for c in worker]))
                                 if worker else None)
    return row, proc


def edit_latencies(edits, swaps, reads, frame0):
    """Per edit (revision, time it returned): the time until the consumer
    read the first frame of the first program swapped in at or after that
    revision. Returns (latencies, edits never heard)."""
    lat, missing = [], 0
    swaps = sorted(swaps, key=lambda s: s[0])
    for rev, t_edit in edits:
        frame = next((f for r, f in swaps if r >= rev), None)
        heard = None if frame is None else next(
            (t for t, n in reads if n > frame - frame0), None)
        if heard is None:
            missing += 1
        else:
            lat.append(heard - t_edit)
    return lat, missing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--scenario", default="all", choices=("all",) + SCENARIOS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--voices", type=int, default=V)
    ap.add_argument("--cascade-nodes", type=int, default=256)
    ap.add_argument("--ir-seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    import knaster_tpu_torch as kt

    for scenario in SCENARIOS if args.scenario == "all" else (args.scenario,):
        row, _ = soak(kt, torch, scenario, args.seconds, args.device, args.voices,
                      args.cascade_nodes, args.ir_seconds)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
