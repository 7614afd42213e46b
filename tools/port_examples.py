#!/usr/bin/env python3
"""Ten of the JAX package's examples rebuilt over the port, rendered on the card.

    python3 tools/port_examples.py [names...] [--seconds S] [--device cuda]

The examples in ``examples/`` import ``knaster_tpu.prelude``. This module
builds the same graphs and scores over a package ``m``:
``knaster_tpu_torch`` here and in ``chip_smoke.py``, and also
``knaster_tpu`` in ``tests/test_torch_examples.py``, which holds the two
packages' renders against each other. Each function below cites the
example's lines. It takes ``m`` and a ``Run``, makes its processors
through the run, builds the example's graph and score, and renders
through ``Run.render``. The run keeps the audio and the seconds each
render took.

Cuts: ``seconds`` caps a render (the events after it are not scheduled),
and a few examples take a size (``voices``, ``strings``, ``notes``). With
no cut each renders what its example renders. ``live_edit`` streams
through ``StreamBackend`` for about 6 s of wall; ``live_edit_offline``
is its graph and edit rendered offline at a fixed block, for comparing
the two packages.

The CLI renders the named examples (all by default) on ``--device`` (the
card unless ``--device cpu``), writes each bounce to
``build/examples/<name>.wav`` and prints its peak, its realtime x and, for
``live_edit``, its underruns.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 48000
BLOCK = 64


def prelude(m):
    """``m.prelude``: the names the examples import with ``*``."""
    return importlib.import_module(f"{m.__name__}.prelude")


def noise_module(m):
    """``m.ugens.noise``: the counter that unseeded noise and Galactic
    draw their seeds from, in construction order."""
    return importlib.import_module(f"{m.__name__}.ugens.noise")


def bank_class(m, name):
    """The example's ``Pallas<name>`` under the JAX package; under the port
    the ``Fused<name>`` that takes its place (``WavetableVoiceBank`` →
    ``FusedWavetableVoiceBank``)."""
    return getattr(m, f"Pallas{name}", None) or getattr(m, f"Fused{name}")


class Run:
    """One example's processors and renders over the package ``m``.

    Every processor is made on ``device`` (the port's; None for the JAX
    package, which takes no device) with ``render_chunk_blocks`` of
    ``chunk_blocks`` where given (1: block by block). ``render`` keeps each
    render's audio
    in ``pieces`` and sums the wall seconds and frames rendered. Where
    ``head`` (seconds) is set, the first render of ``seconds=`` is split
    there: its first ``head`` seconds render alone, as a render cut at
    ``head`` renders them, so that they can be held against that render."""

    def __init__(self, m, device=None, head=None, chunk_blocks=None):
        self.m, self.device, self.head, self.chunk_blocks = m, device, head, chunk_blocks
        self.pieces, self.render_s, self.frames, self.info = [], 0.0, 0, {}
        self.renders = []  # (frames, wall seconds) of each render

    def processor(self, outputs=2, block_size=BLOCK):
        kw = {} if self.device is None else {"device": self.device}
        chunk = {} if self.chunk_blocks is None else {"render_chunk_blocks": self.chunk_blocks}
        opts = self.m.AudioProcessorOptions(block_size=block_size, sample_rate=SR, **chunk)
        return self.m.AudioProcessor.new(0, outputs, opts, **kw)

    def render(self, proc, keep=True, **kw):
        """``proc.render(**kw)`` as host numpy, timed; kept in ``pieces``
        unless ``keep`` is false."""
        if self.head is not None and keep and "seconds" in kw:
            head, self.head = int(round(self.head * SR)), None
            frames = int(round(kw.pop("seconds") * SR))
            if frames > head:
                a = self.render(proc, keep, frames=head, **kw)
                b = self.render(proc, keep, frames=frames - head, **kw)
                return np.concatenate([a, b], axis=1)
            kw["frames"] = frames
        t0 = time.perf_counter()
        audio = np.asarray(proc.render(**kw))
        secs = time.perf_counter() - t0
        self.renders.append((audio.shape[1], secs))
        self.render_s += secs
        self.frames += audio.shape[1]
        if keep:
            self.pieces.append(audio)
        return audio

    def audio(self):
        return np.concatenate(self.pieces, axis=1)

    def realtime_x(self, skip=0):
        """Rendered seconds of audio a wall second, over the renders after
        the first ``skip``."""
        frames = sum(f for f, _ in self.renders[skip:])
        secs = sum(s for _, s in self.renders[skip:])
        return frames / SR / secs if secs else float("nan")


def cut(full, seconds):
    return full if seconds is None else min(full, seconds)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def simple_sine(m, run, seconds=None):
    """examples/simple_sine.py:18-39: a 440 Hz sine whose amplitude is
    smoothed linearly over 0.1 s, rising in frequency and volume every
    0.25 s for 2.5 s, then 2 s more."""
    p = prelude(m)
    graph, proc = run.processor(2)

    def build(g):
        sine = g.push(p.SinWt(440.0))
        amp = g.push(p.Constant(0.2))
        sig = sine * amp
        sig.out([0, 0]).to_graph_out()
        return sine.param("freq"), amp.param("value")

    freq, amp = graph.edit(build)
    amp.smooth(p.Smoothing.linear(0.1))
    t = 0.0
    for i in range(11):
        if seconds is None or t < seconds:
            freq.set_at(440.0 + i * 44.0, t)
            amp.set_at((i + 1) / 20.0, t)
        t += 0.25
    run.render(proc, seconds=cut(t + 2.0, seconds))


def visualize_graph(m, run, seconds=1.0, svg_path=None):
    """examples/visualize_graph.py:15-34: a saw into a lowpass, an
    unstarted EnvAsr, Pan2, and an allpass echo fed back into the filter;
    its dot source and ``show_dot_svg`` (None without Graphviz's ``dot``)
    go into ``run.info``. The example renders nothing and never starts the
    envelope; here the envelope starts at 0 and is released at 0.5 s, and
    the patch renders ``seconds`` (1 s by default), so that it sounds."""
    p = prelude(m)
    graph, proc = run.processor(2)

    def build(g):
        saw = g.push(p.PolyBlep(p.Waveform.Sawtooth, 110.0), name="saw")
        filt = g.push(p.SvfFilter(p.SvfFilterType.Low, 1800.0, 1.0, 0.0), name="lpf")
        env = g.push(p.EnvAsr(0.01, 0.4), name="env")
        pan = g.push(p.Pan2(0.0), name="pan")
        saw.to(filt)
        (filt * env).to(pan)
        pan.to_graph_out()
        fb = g.push(p.AllpassFeedbackDelay(0.25, feedback=0.4), name="echo")
        filt.to(fb)
        fb.out([0]).to_feedback(filt)
        return env

    env = graph.edit(build)
    run.info["dot"] = p.to_dot(graph)
    run.info["svg"] = p.show_dot_svg(graph, svg_path or os.path.join(
        ROOT, "build", "examples", "visualize_graph.svg"))
    env.param("t_restart").trig()
    if seconds > 0.5:
        env.param("t_release").trig_at(p.Seconds.from_secs_f64(0.5))
    run.render(proc, seconds=seconds)


MANY_SINES = 600
MANY_SINES_SECONDS = 12.0


def many_sines(m, run, seconds=None, voices=MANY_SINES):
    """examples/many_sines.py:22-63: a vmap bank of 600 enveloped, panned
    ``SineVoice``s; every 10 ms a sample-accurate freq set and two
    restarts, the root moving every 16 sweeps of the voices."""
    p = prelude(m)
    end = cut(MANY_SINES_SECONDS, seconds)
    rng = np.random.default_rng(2026)
    graph, proc = run.processor(2)
    N = voices

    def build(g):
        bank = g.push(
            p.VoiceBank(
                p.SineVoice(amp=0.012, attack=0.01, release=0.1),
                N,
                voice_defaults={
                    "freq": rng.uniform(3000.0, 10000.0, N).astype(np.float32),
                    "pan": rng.uniform(-1.0, 1.0, N).astype(np.float32),
                },
                event_capacity=512,
            )
        )
        bank.to_graph_out()
        return bank

    bank = graph.edit(build)
    freq = bank.voice_param("freq")
    trig = bank.voice_param("t_restart")
    ratios = [1.0, 9 / 8, 6 / 5, 3 / 2, 8 / 5, 16 / 9, 2.0]
    root = 110.0
    t, loops = 0.0, 0
    while t < end:
        if loops % 16 == 0:
            root = 55.0 * 2.0 ** rng.integers(1, 4) * ratios[rng.integers(0, 7)]
        j = 0
        while j < N and t < end:
            freq.set_at(j, root * ratios[j % len(ratios)], t)
            trig.trig_at(j, t)
            trig.trig_at(int(rng.integers(0, N)), t)
            j += int(rng.integers(1, 10))
            t += 0.01
        loops += 1
    run.render(proc, seconds=end)


POOL_NOTES = 300
POOL_TAIL = 1.5


def voice_pool(m, run, notes=POOL_NOTES, tail=POOL_TAIL):
    """examples/voice_pool.py:37-85: ``VoicePool`` over a 64-voice vmap
    bank of ``SineVoice``s into a Galactic bus; 300 arpeggiated note-ons
    16 ms apart, each with its note-off 120 ms later, rendered in pieces of
    50 notes with a ``refresh`` after each, then a ``tail`` of reverb.
    ``run.info``: the notes scheduled and the pool's free voices at the
    end."""
    graph, proc = run.processor(2)

    def build(gg):
        bank = gg.push(m.VoiceBank(m.SineVoice(amp=0.02, attack=0.004, release=0.25), 64,
                                   event_capacity=512))
        verb = gg.push(m.Galactic(wet=0.35, bigness=0.8))
        bank.to(verb)
        verb.to_graph_out()
        return bank

    bank = graph.edit(build)
    pool = m.VoicePool(proc, bank)
    scale = [0, 3, 5, 7, 10]
    rng = np.random.default_rng(4)
    frame = scheduled = 0
    for i in range(notes):
        degree = scale[i % len(scale)] + 12 * (i // len(scale) % 3)
        freq = 110.0 * 2 ** (degree / 12.0)
        v = pool.note_on({"freq": freq, "pan": float(rng.uniform(-0.8, 0.8))},
                         at=m.Seconds.from_samples(frame, SR))
        if v is not None:
            pool.note_off(v, at=m.Seconds.from_samples(frame + int(0.12 * SR), SR))
            scheduled += 1
        frame += int(SR * 0.016)
        if i % 50 == 49:  # render as we go; envelopes finish, voices free up
            need = ((frame // 64) + 1) * 64 - proc.graph.clock.frames
            run.render(proc, frames=need)
            pool.refresh()
    if tail:
        run.render(proc, seconds=tail)
    pool.refresh()
    run.info.update(scheduled=scheduled, free=pool.free_count)


WT_VOICES = 16384
WT_SECONDS = 10.0


def wavetable_orchestra(m, run, seconds=None, voices=WT_VOICES):
    """examples/wavetable_orchestra.py:28-89: 16,384 voices of the fused
    wavetable bank (the example's ``PallasWavetableVoiceBank``; the port's
    ``FusedWavetableVoiceBank``, csrc/wt_bank.cu) over a saw-ish table of 24
    partials, event capacity 4,096: 24 waves of 170 sample-accurate
    restarts 0.25 s apart, then every voice released in 8 waves of 2,048
    from 6 s. The example scales the bounce to a 0.7 peak for its file;
    the audio here is the render's."""
    p = prelude(m)
    end = cut(WT_SECONDS, seconds)
    V = voices
    rng = np.random.default_rng(7)
    table = p.NonAaWavetable()
    table.add_saw(1, 20, 1.0)
    table.add_sine(5.0, 0.25, 0.0)
    degrees = np.array([0, 3, 7, 10, 14, 17])
    base = 55.0 * 2.0 ** (degrees[rng.integers(0, 6, V)] / 12.0)
    octave = 2.0 ** rng.integers(0, 5, V).astype(np.float32)
    detune = 2.0 ** (rng.normal(0.0, 0.004, V).astype(np.float32))
    freqs = (base * octave * detune).astype(np.float32)
    graph, proc = run.processor(2)

    def build(g):
        bank = g.push(bank_class(m, "WavetableVoiceBank")(
            V,
            table=table.buffer,
            n_harmonics=24,
            attack=0.8,
            release=2.5,
            voice_defaults={
                "freq": freqs,
                "amp": np.full(V, 0.0035, np.float32),
                "pan": rng.uniform(-1.0, 1.0, V).astype(np.float32),
            },
            event_capacity=4096,
        ))
        bank.to_graph_out()
        return bank

    bank = graph.edit(build)
    trig = bank.voice_param("t_restart")
    rel = bank.voice_param("t_release")
    order = rng.permutation(V)
    n_waves = 24
    for w in range(n_waves):
        if 0.25 * w < end:
            t = p.Seconds.from_secs_f64(0.25 * w)
            for v in order[w::n_waves][: 4096 // n_waves]:
                trig.trig(int(v), t=p.Time.at(t))
    n_rel = 8
    for w in range(n_rel):
        if 6.0 + 0.15 * w < end:
            t = p.Seconds.from_secs_f64(6.0 + 0.15 * w)
            for v in order[w::n_rel]:
                rel.trig(int(v), t=p.Time.at(t))
    run.render(proc, seconds=end)


STRUM = [82.41, 123.47, 164.81, 207.65, 246.94, 329.63]  # examples/plucked_strings.py:27
STRUM_GAP = 0.012


def plucked_strings(m, run, seconds=None):
    """examples/plucked_strings.py:31-63 (``main``): six
    ``PluckedString(long=True)``s excited by WhiteNoise * EnvAr bursts into
    Pan2s, strummed at 0.05 s and at 1.55 s, 3.5 s."""
    p = prelude(m)
    end = cut(3.5, seconds)
    g, proc = run.processor(2)

    def build(gg):
        triggers = []
        for i, f in enumerate(STRUM):
            noise = gg.push(p.WhiteNoise())
            env = gg.push(p.EnvAr(0.0008, 0.0025))
            s = gg.push(p.PluckedString(freq=f, damp=0.9965, brightness=0.65 + 0.05 * i,
                                        long=True, max_freq=max(STRUM) * 1.1))
            (noise * env * 0.6).to(s)
            pan = gg.push(p.Pan2((i - 2.5) / 4.0))
            s.to(pan)
            pan.to_graph_out()
            triggers.append(env.param("t_restart"))
        return triggers

    triggers = g.edit(build)
    for strum_t in (0.05, 1.55):
        for i, trig in enumerate(triggers):
            if strum_t + i * STRUM_GAP < end:
                trig.trig_at(p.Seconds.from_secs_f64(strum_t + i * STRUM_GAP))
    run.render(proc, seconds=end)


SHIMMER_STRINGS = 512
SHIMMER_SECONDS = 6.0


def plucked_shimmer(m, run, seconds=None, strings=SHIMMER_STRINGS):
    """examples/plucked_strings.py:66-103 (``shimmer``): a vmap bank of 512
    ``PluckedVoice``s on a pentatonic lattice, mono, each plucked once at a
    time drawn over the first 4.2 s (``set_after``), 6 s. A cut keeps the
    draws and drops the plucks past it."""
    p = prelude(m)
    end = cut(SHIMMER_SECONDS, seconds)
    n_strings = strings
    rng = np.random.default_rng(11)
    g, proc = run.processor(1)
    penta = np.array([0, 3, 5, 7, 10])
    degrees = rng.integers(0, 5, n_strings)
    octaves = rng.integers(0, 4, n_strings)
    freqs = 55.0 * 2 ** (octaves + penta[degrees] / 12.0)
    vd = {
        "vseed": np.arange(n_strings),
        "freq": freqs,
        "amp": np.full(n_strings, 2.0 / np.sqrt(n_strings)),
        "damp": rng.uniform(0.995, 0.999, n_strings),
        "brightness": rng.uniform(0.4, 0.9, n_strings),
    }

    def build(gg):
        b = gg.push(p.VoiceBank(p.PluckedVoice(max_freq=float(freqs.max()) * 1.1),
                                n_strings, voice_defaults=vd))
        b.to_graph_out()
        return b

    bank = g.edit(build)
    pluck = bank.voice_param("t_pluck")
    for v in range(n_strings):
        after = float(rng.uniform(0.0, SHIMMER_SECONDS * 0.7))
        if after < end:
            pluck.set_after(v, None, after)
    run.render(proc, seconds=end)


_SOURCES = {}


def grain_source(m, run):
    """examples/granular_texture.py:25-41 (``render_source``): a 1 s
    plucked string (WhiteNoise * EnvAr into ``PluckedString(220)``, mono)
    bounced into a Buffer. Its render is timed, not kept. Rendered once
    per package and device, as both granular examples start from it; a
    second call draws the seed the source's WhiteNoise drew, so that the
    seeds after it are those of the example."""
    p = prelude(m)
    key = (m.__name__, str(run.device))
    if key in _SOURCES:
        noise_module(m).next_randomness_seed()
        return _SOURCES[key]
    g, proc = run.processor(1)

    def build(gg):
        exciter = gg.push(p.WhiteNoise())
        burst = gg.push(p.EnvAr(0.001, 0.004))
        string = gg.push(p.PluckedString(220.0, damp=0.995, brightness=0.6))
        (exciter * burst).to(string)
        string.to_graph_out()
        return burst

    burst = g.edit(build)
    burst.param("t_restart").trig()
    _SOURCES[key] = p.Buffer(run.render(proc, keep=False, seconds=1.0), SR)
    return _SOURCES[key]


def granular_texture(m, run, seconds=None):
    """examples/granular_texture.py:44-88 (``main``): a ``GrainPlayer`` of
    64 grains at 200 grains/s over the plucked source into Galactic, its
    read position scrubbed by 50 sets over 5 s, 12 spawn accents, the
    density thinned at 5 s; 6 s."""
    p = prelude(m)
    end = cut(6.0, seconds)
    src = grain_source(m, run)
    g, proc = run.processor(2)

    def build(gg):
        cloud = gg.push(p.GrainPlayer(src, grains=64, density=200.0, grain_dur=0.06, pos=0.05,
                                      pos_jitter=0.02, rate_jitter=1.0, pan_spread=1.0,
                                      amp=0.4, seed=11))
        verb = gg.push(p.Galactic(replace=0.2, brightness=0.8, detune=0.2, bigness=0.7))
        cloud.to(verb)
        verb.to_graph_out()
        return cloud

    cloud = g.edit(build)
    pos = cloud.param("pos")
    for i in range(50):
        if i * 0.1 < end:
            pos.set_at(0.05 + 0.85 * (i / 50.0), p.Seconds.from_secs_f64(i * 0.1))
    spawn = cloud.param("t_spawn")
    for beat in range(12):
        if 0.25 + beat * 0.5 < end:
            spawn.trig_at(p.Seconds.from_secs_f64(0.25 + beat * 0.5))
    if 5.0 < end:
        cloud.param("density").set_at(40.0, p.Seconds.from_secs_f64(5.0))
    run.render(proc, seconds=end)


def granular_ensemble(m, run, seconds=None):
    """examples/granular_texture.py:91-130 (``main_ensemble``): eight
    ``GrainPlayer``s of one config over the shared source (one batched plan
    item), ``max_rate=2.0``, each position drifting by 12 sets 0.4 s
    apart; 5 s."""
    p = prelude(m)
    end = cut(5.0, seconds)
    src = grain_source(m, run)
    g, proc = run.processor(2)
    rng = np.random.default_rng(5)

    def build(gg):
        hs = []
        for i in range(8):
            hs.append(gg.push(p.GrainPlayer(
                src, grains=64, seed=100 + i,
                density=float(60.0 * 2 ** rng.uniform(-0.5, 1.0)),
                grain_dur=0.08, pos=0.05 + 0.1 * i, pos_jitter=0.03,
                rate=float(2 ** rng.uniform(-0.6, 0.6)),
                rate_jitter=0.3, pan_spread=1.0,
                max_rate=2.0, amp=0.12,
            )))
            hs[-1].to_graph_out()
        return hs

    hs = g.edit(build)
    for k, h in enumerate(hs):
        pp = h.param("pos")
        for i in range(12):
            if i * 0.4 < end:
                pp.set_at(0.05 + 0.08 * ((i + k) % 10), p.Seconds.from_secs_f64(i * 0.4))
    run.render(proc, seconds=end)


def synthetic_room_ir(seconds=2.0, rt60=1.4, seed=7):
    """examples/ir_reverb.py:27-43: a stereo noise IR with an exponential
    decay and a one-pole lowpass whose cutoff falls with time."""
    rng = np.random.default_rng(seed)
    L = int(seconds * SR)
    t = np.arange(L, dtype=np.float32) / SR
    decay = np.exp(-6.91 * t / rt60)
    ir = rng.standard_normal((2, L)).astype(np.float32) * decay[None, :]
    out = np.empty_like(ir)
    for c in range(2):
        y = 0.0
        a = np.clip(1.0 - t / seconds, 0.15, 1.0) * 0.6 + 0.1
        for i in range(L):
            y = y + a[i] * (ir[c, i] - y)
            out[c, i] = y
    out *= 0.15 / np.sqrt((out ** 2).sum(axis=1)).max()
    return out


_IR = {}


def ir_reverb(m, run, seconds=None):
    """examples/ir_reverb.py:46-75 (``main``): a PolyBlep saw shaped by
    EnvAr into a ``Convolver`` over the 2 s synthetic room (1500
    partitions at B = 64), eight notes 0.35 s apart; 4 s."""
    p = prelude(m)
    end = cut(4.0, seconds)
    if "ir" not in _IR:
        _IR["ir"] = synthetic_room_ir()
    ir = _IR["ir"]
    graph, proc = run.processor(2)

    def build(g):
        osc = g.push(p.PolyBlep(p.Waveform.Sawtooth, 220.0))
        env = g.push(p.EnvAr(0.005, 0.35))
        conv = g.push(m.Convolver(ir, dry_wet=0.6))
        (osc * env * 0.4).to(conv)
        conv.to_graph_out()
        return osc.param("freq"), env.param("t_restart")

    freq, trig = graph.edit(build)
    notes = [220.0, 277.18, 329.63, 440.0, 329.63, 277.18, 246.94, 220.0]
    for i, f in enumerate(notes):
        if 0.35 * i < end:
            at = m.Seconds.from_secs_f64(0.35 * i)
            freq.set_at(f, at)
            trig.trig_at(at)
    run.render(proc, seconds=end)


def buffer_player(m, run, seconds=None):
    """examples/buffer_player.py:19-40 with its synthesized input (a 1 s
    decaying 440 Hz sine, mono): ``BufferReader`` (on the card one launch
    of csrc/buffer_reader.cu a block) to both channels into Galactic; the
    buffer's 1 s and 3 s of tail."""
    p = prelude(m)
    t = np.arange(48000) / 48000
    data = (0.5 * np.sin(2 * np.pi * 440 * t) * np.exp(-3 * t)).astype(np.float32)
    buf = p.Buffer(data[None, :], 48000)
    graph, proc = run.processor(2)

    def build(g):
        player = g.push(p.BufferReader(buf, rate=1.0))
        reverb = g.push(p.Galactic(wet=0.4))
        src = player if buf.channels == 2 else player.out([0, 0])
        src.to(reverb)
        reverb.to_graph_out()

    graph.edit(build)
    run.render(proc, seconds=cut(buf.length_seconds() + 3.0, seconds))


def _live_voice(p, graph):
    """examples/live_edit.py:30-36: the subtractive voice as a node, both
    channels, restarted."""
    def build(g):
        v = g.push(p.SubtractiveVoice(freq=73.4, amp=0.3, release=2.0))
        v.out([0, 0]).to_graph_out()
        return v

    voice = graph.edit(build)
    voice.param("t_restart").trig()
    return voice


def _add_reverb(p, voice):
    """examples/live_edit.py:49-52: the edit, a Galactic inserted after the
    voice, replacing the graph's output."""
    def add_reverb(g):
        verb = g.push(p.Galactic(wet=0.8), name="verb")
        g.handle(voice.node_id).out([0, 0]).to(verb)
        verb.to_graph_out_replace()

    return add_reverb


def live_edit(m, run, before_s=1.5, after_s=2.0, release_s=2.0, timeout_s=30.0):
    """examples/live_edit.py:25-71: the subtractive voice streamed through
    ``StreamBackend`` (a 200-block lookahead) with a consumer collecting
    the blocks; after ``before_s`` a Galactic is inserted live (compiled in
    the background, swapped in between blocks) and the voice restarted
    0.5 s later; ``after_s`` after the swap a release, ``release_s`` more,
    stop. The port's package only (the JAX package's stream needs its own
    native ring). ``run.info``: underruns, whether the processor swapped
    to the edit's revision, the swaps, the stream's start-up seconds (its
    warm), the seconds from the edit to the swap seen, the ring's frames
    written and the wall from the stream's start (after its start-up) to
    the end of the release, the producer's chunks and their host ms
    (median, max, and the median of those after the swap). The captured
    blocks are the run's one piece."""
    p = prelude(m)
    graph, proc = run.processor(2)
    voice = _live_voice(p, graph)
    proc.run_without_inputs()  # warm the block programs
    chunk_s, chunk_at, render = [], [], proc.render

    def timed_render(*a, **k):  # the producer's chunks: host wall each
        t = time.perf_counter()
        frame = graph.clock.frames
        out = render(*a, **k)
        if k.get("fetch") is False:
            chunk_s.append(time.perf_counter() - t)
            chunk_at.append((frame, proc.compiled.revision))
        return out

    proc.render = timed_render
    captured = []
    backend = p.StreamBackend(SR, BLOCK, lookahead_blocks=200,
                              consumer=lambda blk: captured.append(blk.copy()))
    t0 = time.perf_counter()
    backend.start_processing(proc)
    t_start = time.perf_counter()
    try:
        time.sleep(before_s)
        t_edit = time.perf_counter()
        graph.edit(_add_reverb(p, voice))  # compiles in the background; swaps when ready
        voice.param("t_restart").trig_after(0.5)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            time.sleep(0.25)
            if proc.compiled and proc.compiled.revision == graph.revision:
                break
        swapped = bool(proc.compiled and proc.compiled.revision == graph.revision)
        swap_s = time.perf_counter() - t_edit
        n_before = len(chunk_s)
        time.sleep(after_s)
        voice.param("t_release").trig()
        time.sleep(release_s)
        wall = time.perf_counter() - t_start
        written, underruns = backend.ring.frames_written, backend.underruns
    finally:
        backend.stop()
    audio = np.concatenate(captured, axis=1)
    run.pieces.append(audio)
    after = chunk_s[n_before:]
    run.info.update(underruns=underruns, swapped=swapped, swaps=list(proc.swaps),
                    revision=graph.revision, startup_s=t_start - t0, swap_s=swap_s,
                    frames_written=written, wall_s=wall, written_over_wall=written / (wall * SR),
                    chunks=len(chunk_s),
                    chunk_ms_median=1e3 * float(np.median(chunk_s)) if chunk_s else None,
                    chunk_ms_max=1e3 * max(chunk_s) if chunk_s else None,
                    chunk_ms_median_after=1e3 * float(np.median(after)) if after else None,
                    # the slowest chunk: (ms, its first frame, the revision it rendered)
                    slowest_chunk=(1e3 * max(chunk_s), *chunk_at[int(np.argmax(chunk_s))])
                    if chunk_s else None,
                    # (revision, program-cache hit, plan + build ms, warm ms)
                    compiles=[(c["revision"], c["hit"], (c["plan_ms"] or 0) + (c["build_ms"] or 0),
                               c["warm_ms"]) for c in proc.compiles])


def live_edit_offline(m, run, edit_at=32, blocks=64):
    """``live_edit``'s graph and edit rendered offline at a fixed block:
    the restarted voice for ``edit_at`` blocks, the Galactic inserted (the
    voice's state carried into the new program) and the restart queued
    0.5 s later, as the example does, then to ``blocks`` in all."""
    p = prelude(m)
    graph, proc = run.processor(2)
    voice = _live_voice(p, graph)
    run.render(proc, frames=edit_at * BLOCK)
    graph.edit(_add_reverb(p, voice))
    voice.param("t_restart").trig_after(0.5)
    run.render(proc, frames=(blocks - edit_at) * BLOCK)


EXAMPLES = {
    "simple_sine": simple_sine,
    "visualize_graph": visualize_graph,
    "many_sines": many_sines,
    "voice_pool": voice_pool,
    "wavetable_orchestra": wavetable_orchestra,
    "plucked_strings": plucked_strings,
    "plucked_shimmer": plucked_shimmer,
    "granular_texture": granular_texture,
    "granular_ensemble": granular_ensemble,
    "ir_reverb": ir_reverb,
    "buffer_player": buffer_player,
    "live_edit": live_edit,
    "live_edit_offline": live_edit_offline,
}
# the examples' files (plucked_strings and granular_texture hold two each)
SOURCES = {
    "simple_sine": "examples/simple_sine.py:18-39",
    "visualize_graph": "examples/visualize_graph.py:15-34",
    "many_sines": "examples/many_sines.py:22-63",
    "voice_pool": "examples/voice_pool.py:37-85",
    "wavetable_orchestra": "examples/wavetable_orchestra.py:28-89",
    "plucked_strings": "examples/plucked_strings.py:31-63",
    "plucked_shimmer": "examples/plucked_strings.py:66-103",
    "granular_texture": "examples/granular_texture.py:25-88",
    "granular_ensemble": "examples/granular_texture.py:91-130",
    "ir_reverb": "examples/ir_reverb.py:27-75",
    "buffer_player": "examples/buffer_player.py:19-40",
    "live_edit": "examples/live_edit.py:25-71",
    "live_edit_offline": "examples/live_edit.py:30-52",
}


def play(name, m, device=None, head=None, chunk_blocks=None, **cut_kw):
    """Run the example ``name`` over ``m`` on ``device`` (``head`` and
    ``chunk_blocks`` as ``Run`` takes them), its noise and Galactic seeds
    drawn from a fresh counter as in a fresh process; returns its Run."""
    noise_module(m).reset_randomness_seeds()
    run = Run(m, device, head, chunk_blocks)
    EXAMPLES[name](m, run, **cut_kw)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"examples to render (default all): {list(EXAMPLES)}")
    ap.add_argument("--seconds", type=float, default=None,
                    help="cap each render at this many seconds (default: the example's)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import knaster_tpu_torch as kt
    from knaster_tpu_torch.utils.wav import write_wav

    names = args.names or list(EXAMPLES)
    if unknown := [n for n in names if n not in EXAMPLES]:
        raise SystemExit(f"unknown examples {unknown}; known: {list(EXAMPLES)}")
    out_dir = os.path.join(ROOT, "build", "examples")
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        kw = {}
        if args.seconds is not None and name not in ("voice_pool", "live_edit"):
            kw["seconds"] = args.seconds
        run = play(name, kt, args.device, **kw)
        audio = run.audio()
        path = os.path.join(out_dir, f"{name}.wav")
        write_wav(path, audio, SR)
        line = (f"{name} ({SOURCES[name]}): {audio.shape[1] / SR:.3f} s, peak "
                f"{np.abs(audio).max():.4g}")
        if name == "live_edit":
            i = run.info
            line += (f", underruns {i['underruns']}, swapped {i['swapped']}, written "
                     f"{i['written_over_wall']:.3f} of real time")
        else:
            line += f", realtime x {run.realtime_x():.4g}"
        if name == "visualize_graph":
            line += f", svg {run.info['svg']}"
        print(f"{line}; wrote {path}", flush=True)


if __name__ == "__main__":
    main()
