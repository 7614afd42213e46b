"""Fused banks as graph nodes and ``VoicePool`` in the port, against the JAX package.

- The generic bank in a graph (per-voice handles, scheduled events, a
  smoothing ramp, superblocked renders, the state carried across renders)
  against the JAX graph with the JAX PallasVoiceBank: a port of
  tests/test_generic_bank.py:226.
- ``VoicePool`` over an envelope bank, after tests/test_voice_pool.py:173:
  the envelope-finished latch releases voices that ran their program out.
  A note-off by ``t_stop`` freezes the voice at its value, so it is not
  idle and ``refresh()`` releases nothing: what the JAX package does today
  (the JAX test's last assert still expects 1, ROADMAP §3 item 3).
- A struck modal voice released by the pool (tests/test_modal.py:176 with
  the fused bank).
- A graph holding a bank renders through the JAX bounce's (program,
  length) sequence: single eventful blocks, superblocks capped at the
  banks' 1024 samples, loops of capped superblocks past that.
- The bank helpers ``_exp_poly`` and ``_sincos_halfturn`` bit-equal to
  ``pallas_bank``'s (jitted at XLA optimization level 0), and
  ``_make_env_multiseg`` within 2.5e-7 (two ulps at its values below 2):
  its linear and step shapes are exact, its sinusoidal and exponential
  ones call cos, exp and log, which XLA and torch evaluate with their own
  kernels.

Tolerance against the JAX graph renders: 1e-6. The JAX graph is jitted at
XLA's default level, where its CPU backend fuses multiply-adds and
simplifies the bodies' constant products, and its cos differs from torch's
by an ulp (the envelope's sinusoidal segment); measured within 3e-8 at
these amplitudes.
"""

import jax
import numpy as np
import torch

import knaster_tpu as jk
import knaster_tpu.graph.processor as jP
from knaster_tpu.parallel import pallas_bank as jpb
from knaster_tpu.ugens.envelopes import Envelope as JEnvelope

import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.processor as tP
from knaster_tpu_torch.kernels import bank_common as bc

SR = 48000
B = 64
TOL = 1e-6
NO_FMA = {"xla_backend_optimization_level": 0}


def _proc(m, outputs=1, **opts):
    kw = {} if m is jk else {"device": "cpu"}
    return m.AudioProcessor.new(0, outputs, m.AudioProcessorOptions(
        block_size=B, sample_rate=SR, **opts), **kw)


def _push_bank(g, bank):
    h = g.edit(lambda gg: gg.push(bank))
    h.to_graph_out()
    g.commit()
    return h


def test_generic_bank_in_graph_matches_jax():
    def run(m):
        g, proc = _proc(m)
        d = {"freq": np.linspace(200, 400, 128).astype(np.float32),
             "amp": np.full(128, 0.05, np.float32)}
        bank = (jk.PallasVoiceBank(jk.FMVoice(), 128, voice_defaults=d, tile_rows=1)
                if m is jk else kt.FusedVoiceBank(kt.FMVoice(), 128, voice_defaults=d))
        h = _push_bank(g, bank)
        h.voice_param("t_restart").trig(3)
        h.voice_param("t_restart").trig(70)
        r1 = np.asarray(proc.render(frames=256))
        h.voice_param("freq").set(3, 555.0)
        h.voice_param("amp").smooth(70, 0.002)
        h.voice_param("amp").set(70, 0.1)
        h.set_voice_active(3, False, m.Time.at(m.Seconds.from_samples(640, SR)))
        return r1, np.asarray(proc.render(frames=1024))

    (a1, a2), (b1, b2) = run(jk), run(kt)
    assert np.abs(b2).max() > 1e-3
    np.testing.assert_allclose(b1, a1, rtol=0, atol=TOL)
    np.testing.assert_allclose(b2, a2, rtol=0, atol=TOL)


ENV4 = [(0.001, 1.0), (0.002, 0.5), (0.002, 0.75, "sinusoidal"), (0.003, 0.0)]


def _envelope_pool(m):
    g, proc = _proc(m, outputs=2)
    env = (JEnvelope if m is jk else kt.Envelope)(0.0, ENV4)
    d = {"freq": np.linspace(100, 900, 256).astype(np.float32),
         "amp": np.full(256, 0.01, np.float32)}
    bank = (jk.PallasVoiceBank(jk.EnvelopeVoice(env), 256, tile_rows=2, event_capacity=512,
                               voice_defaults=d)
            if m is jk else kt.FusedVoiceBank(kt.EnvelopeVoice(env), 256,
                                              event_capacity=512, voice_defaults=d))
    h = _push_bank(g, bank)
    return proc, (jk.VoicePool if m is jk else kt.VoicePool)(proc, h)


def test_pool_over_envelope_voice_bank():
    """The finished latch releases 16 voices whose program ran out; a
    t_stop note-off leaves its voice held (frozen, audible): refresh
    releases 0, in the port as in the JAX package."""
    renders, released = {}, {}
    for m in (jk, kt):
        proc, pool = _envelope_pool(m)
        out = [np.asarray(proc.render(frames=64))]
        voices = [pool.note_on() for _ in range(16)]
        assert all(v is not None for v in voices)
        out.append(np.asarray(proc.render(frames=64 * 2)))
        assert np.abs(out[-1]).max() > 1e-4
        out.append(np.asarray(proc.render(frames=64 * 8)))  # ~10.7 ms > the 8 ms program
        got = [pool.refresh()]
        assert pool.free_count == pool.n_voices
        v = pool.note_on()
        out.append(np.asarray(proc.render(frames=64)))
        pool.note_off(v, trigger="t_stop")
        out.append(np.asarray(proc.render(frames=64 * 2)))
        got.append(pool.refresh())
        assert pool.held_count == 1 and abs(float(out[-1][:, -1].sum())) > 0.0
        renders[m], released[m] = np.concatenate(out, axis=1), got
    assert released[kt] == released[jk] == [16, 0]
    np.testing.assert_allclose(renders[kt], renders[jk], rtol=0, atol=TOL)


def test_pool_over_modal_voice_bank():
    """A struck modal voice rings, goes quiet and is released; the latch
    agrees with the JAX package's over the same render."""
    res = {m: (jk.ModalResonator if m is jk else kt.ModalResonator)(
        freq=880.0, decay=0.02, ratios=(1.0, 2.5), gains=(1.0, 0.5), decays=(1.0, 0.5))
        for m in (jk, kt)}
    outs = {}
    for m in (jk, kt):
        g, proc = _proc(m, outputs=2)
        voice = m.ModalVoice(resonator=res[m], amp=0.5, done_threshold=1e-4)
        bank = (jk.PallasVoiceBank(voice, 128, event_capacity=64, tile_rows=1) if m is jk
                else kt.FusedVoiceBank(voice, 128, event_capacity=64))
        pool = (jk.VoicePool if m is jk else kt.VoicePool)(
            proc, _push_bank(g, bank), note_on_trigger="t_strike")
        assert pool.note_on({"freq": 880.0, "amp": 0.5}) == 0
        outs[m] = np.asarray(proc.render(frames=SR // 8))  # >> strike + 20 ms T60
        assert np.abs(outs[m]).max() > 1e-3
        assert pool.refresh() == 1 and pool.free_count == pool.n_voices
    np.testing.assert_allclose(outs[kt], outs[jk], rtol=0, atol=TOL)


def _spy(monkeypatch, m, proc):
    """Record (program, blocks) for each renderer call of ``proc.render``:
    'full' and 'fast' single blocks, 'super' k-block superblocks, 'scan'
    loops of k-block superblocks over a run."""
    seq = []
    mod = jP if m is jk else tP
    for name, tag in (("get_super_fn", "super"), ("get_super_scan_fn", "scan")):
        real = getattr(mod, name)

        def get(cg, k, *a, real=real, tag=tag, **kw):
            fn = real(cg, k, *a, **kw)
            if fn is None:
                return None

            def logged(*args):
                seq.append((tag, k))
                return fn(*args)

            return logged

        monkeypatch.setattr(mod, name, get)
    proc._ensure_compiled()
    cg = proc.compiled
    fast, full = cg.render_fast, cg.render

    def fast_logged(*args):
        seq.append(("fast", 1))
        return fast(*args)

    def full_logged(*args):
        seq.append(("full", 1))
        return full(*args)

    cg.render_fast, cg.render = fast_logged, full_logged
    return seq


def test_bank_graph_takes_the_jax_partition(monkeypatch):
    """Note-ons at blocks 0, 37 and 100 of a 160-block bounce: the same
    (program, length) sequence in both packages, superblocks capped at
    1024 samples (16 blocks), and the same samples."""
    seqs, outs = {}, {}
    for m in (jk, kt):
        proc, pool = _envelope_pool(m)
        for frame in (0, 37 * B + 5, 100 * B + 63):
            pool.note_on({"freq": 330.0}, at=m.Seconds.from_samples(frame, SR))
        seqs[m] = _spy(monkeypatch, m, proc)
        outs[m] = np.asarray(proc.render(frames=160 * B))
        monkeypatch.undo()
    assert seqs[kt] == seqs[jk]
    assert seqs[kt].count(("full", 1)) == 3 and ("scan", 16) in seqs[kt]
    assert max(k for p, k in seqs[kt] if p == "super") <= 16
    np.testing.assert_allclose(outs[kt], outs[jk], rtol=0, atol=TOL)


def test_bank_helpers_match_pallas_bank():
    rng = np.random.default_rng(3)
    shape = (16, 128)
    # exp arguments over the fit's range, past its underflow clamp, and 0
    x = np.concatenate([-rng.uniform(0, 120, 1021), -rng.uniform(0, 1e-3, 1024),
                        [0.0, -200.0, -1e-30]]).astype(np.float32).reshape(shape)
    a = np.asarray(jax.jit(jpb._exp_poly, compiler_options=NO_FMA)(x))
    b = bc._exp_poly(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))

    th = rng.uniform(0, np.pi, shape).astype(np.float32)
    for u, w in zip(jax.jit(jpb._sincos_halfturn, compiler_options=NO_FMA)(th),
                    bc._sincos_halfturn(torch.from_numpy(th))):
        np.testing.assert_array_equal(w.numpy().view(np.int32), np.asarray(u).view(np.int32))

    segs = np.asarray([[1 / 0.01, 0.01, 1.0], [1 / 0.02, 0.02, 0.4], [1 / 0.01, 0.01, 0.8],
                       [1 / 0.03, 0.03, 0.0]], np.float32)
    shapes = [1, 2, 0, 3]  # exponential, sinusoidal, linear, step
    for looping in (False, True):
        jstep = jpb._make_env_multiseg(segs, looping, 0.1, shapes)
        tstep = bc._make_env_multiseg(segs, looping, 0.1, shapes)
        seg = rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0, 3.0], shape).astype(np.float32)
        t = rng.uniform(0, 0.035, shape).astype(np.float32)
        fv = rng.uniform(-0.5, 1.0, shape).astype(np.float32)
        dt = np.full(shape, 1 / SR, np.float32)
        restart = rng.random(shape) < 0.2
        stop = rng.random(shape) < 0.2
        ja = jax.jit(jstep, compiler_options=NO_FMA)(seg, t, fv, dt, restart, stop)
        ta = tstep(*(torch.from_numpy(v) for v in (seg, t, fv, dt, restart, stop)))
        for u, w in zip(ja, ta):
            np.testing.assert_allclose(w.numpy(), np.asarray(u), rtol=0, atol=2.5e-7)
