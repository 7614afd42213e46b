#!/usr/bin/env python3
"""examples/mesh_voice_cluster.py on the port: mesh-sharded voices in a graph.

    python3 tools/mesh_voice_cluster.py [--devices cuda:0 cuda:0 ...] [--fused]
                                        [--out build/mesh_voice_cluster.wav]

* a ``MeshVoiceBank`` (the voices sharded over ``--devices``, 16 a shard;
  by default one shard on every card) as an ordinary graph node, its left
  channel through an ``SvfFilter`` bus;
* ``SchedulingToken`` batches: each chord's releases, detuned freq sets and
  triggers are attached to one token and activated together, landing in
  the same block;
* the filter's parameter hints read back through ``Handle.param_hints()``.

The bank is the example's ``VoiceBank(SineVoice(...))``, or with
``--fused`` a ``FusedSineVoiceBank`` of the same voices (the sine kernel
on every shard). The graph renders on the first shard's device, where the
mix of the shards is summed. Writes the bounce to
``--out``.

The functions take the package as ``m``, so that the same graph and score
can be built over ``knaster_tpu`` (the JAX package, in the tests) and over
``knaster_tpu_torch``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000
BLOCK = 64
VOICES_PER_DEVICE = 16
BASE_HZ = 220.0
CHORDS = (
    (0, 4, 7),      # major
    (0, 3, 7),      # minor
    (0, 5, 9),      # sus
    (0, 4, 7, 11),  # maj7
)
CHORD_SECONDS = 1.0


def make_bank(m, V, fused=False):
    """(bank, detune): the example's V detuned, panned sine voices (seed
    7), as the vmap ``VoiceBank`` or as the fused sine bank."""
    rng = np.random.default_rng(7)
    detune = 2.0 ** (rng.uniform(-0.01, 0.01, V))
    defaults = {"freq": (BASE_HZ * detune).astype(np.float32),
                "pan": rng.uniform(-1, 1, V).astype(np.float32)}
    if fused:
        defaults["amp"] = np.full(V, 0.04, np.float32)
        return m.FusedSineVoiceBank(V, voice_defaults=defaults, attack=0.02,
                                    release=0.6), detune
    return m.VoiceBank(m.SineVoice(amp=0.04, attack=0.02, release=0.6), V,
                       voice_defaults=defaults), detune


def build(m, g, node):
    """Push the bank node and the filter bus: (bank handle, filter handle)."""
    h = g.push(node)
    filt = g.push(m.SvfFilter(cutoff_freq=2500.0, q=0.8))
    h.out([0]).to(filt)
    filt.to_graph_out_channels([0])
    h.out([1]).to_graph_out_channels([1])
    return h, filt


def schedule(m, h, detune, group, chords=CHORDS, spacing=CHORD_SECONDS):
    """Queue the chord progression, ``spacing`` seconds apart (the
    example's CHORD_SECONDS; the tests take shorter): each chord releases
    the last one's voices and retunes and triggers its own, all under one
    ``SchedulingToken``. Returns the seconds the chords span."""
    V = len(detune)
    trig = h.voice_param("t_restart")
    rel = h.voice_param("t_release")
    freq = h.voice_param("freq")
    t = 0.0
    prev = []
    for chord in chords:
        tok = m.SchedulingToken()
        when = m.Seconds.from_secs_f64(t)
        for v in prev:
            rel.trig_at(v, when, token=tok)
        prev = []
        for k, semi in enumerate(chord):
            f = BASE_HZ * 2.0 ** (semi / 12.0)
            for j in range(group // len(chord) + 1):
                v = (k * group // len(chord) + j) % V
                freq.set_at(v, float(f * detune[v]), when, token=tok)
                trig.trig_at(v, when, token=tok)
                prev.append(v)
        tok.activate()  # the whole chord change is one atomic batch
        t += spacing
    return t


def cluster(m, node, detune, chords=CHORDS, **new_kw):
    """A processor holding the graph with ``node`` (a ``MeshVoiceBank`` or
    the bank it wraps) and the score queued: (graph, processor, bank handle,
    filter handle, seconds). ``new_kw`` goes to ``AudioProcessor.new``
    (the port's ``device``)."""
    g, proc = m.AudioProcessor.new(
        0, 2, m.AudioProcessorOptions(block_size=BLOCK, sample_rate=SR), **new_kw)
    h, filt = g.edit(lambda gg: build(m, gg, node))
    seconds = schedule(m, h, detune, VOICES_PER_DEVICE, chords)
    return g, proc, h, filt, seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", nargs="+", default=None,
                    help="the shards' devices (default: one shard a card)")
    ap.add_argument("--fused", action="store_true",
                    help="a FusedSineVoiceBank in place of the vmap VoiceBank")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_voice_cluster.wav"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import knaster_tpu_torch as kt
    from knaster_tpu_torch.utils.wav import write_wav

    devices = args.devices or [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not devices:
        raise SystemExit("no CUDA card: pass --devices (e.g. --devices cpu cpu)")
    mesh = kt.make_mesh(devices)
    V = VOICES_PER_DEVICE * len(devices)
    print(f"mesh: {len(devices)} shard(s) on {', '.join(devices)}, {V} voices")
    bank, detune = make_bank(kt, V, fused=args.fused)
    g, proc, h, filt, seconds = cluster(kt, kt.MeshVoiceBank(bank, mesh), detune,
                                        device=devices[0])
    cut = filt.param_hints()["cutoff_freq"]
    print(f"cutoff hint: {cut.minimum}..{cut.maximum} Hz (logarithmic={cut.logarithmic})")
    audio = proc.render(seconds=seconds + 1.0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_wav(args.out, audio, SR)
    print(f"wrote {args.out}: peak {np.abs(audio).max():.3f}")


if __name__ == "__main__":
    main()
