"""Golden ``detuned_banks`` (tests/golden_configs.py:85-142) through the port.

BASELINE config #3: a 512-voice ``VoiceBank(FMVoice)`` and a 512-voice
``VoiceBank(AdditiveVoice)`` in one graph, every voice detuned from numpy
seed 42, triggered across the first block, with per-voice smoothing
configs and 128 sample-accurate freq sets landing mid-render; 0.2 s at 64
samples a block.

- The port's render on the CPU meets both fixtures (read with the port's
  codec) at the golden gate 1e-6 + 2^-23 on every sample:
  measured 6.0e-8 at f64 and 1.0068e-6 at f32. The f32 render sits near
  the gate because the FM carrier takes its frequency from the modulator's
  sine every sample, and XLA's f32 sine (the fixture's) and torch's differ
  by an ulp on some table indices: the carrier's u32 increment then
  truncates otherwise and its phase drifts by a few units.
- The bounce takes the JAX package's partition: the same (program,
  length) sequence of single eventful blocks and event-free superblocks,
  compared with the JAX processor's on the same schedule. The JAX
  processor renders a run of 16 or more eventful blocks as one scan of its
  per-block program; the port renders those blocks one by one, which is
  the same partition, so the JAX scan counts as that many single blocks.
- The superblocked render against the per-block one
  (``render_chunk_blocks=1``): the envelopes' event-free closed form sums
  its rates over the whole superblock, so an attack whose sum reaches 1 on
  its last rounding may cross a sample apart. ``CROSSING`` bounds that:
  one attack step of an FM voice and one of an additive voice (amp times
  rate). The JAX package's own per-block render shows the same
  difference: the port's per-block render matches it within ``F64_TOL``
  at f64.

Each render two tests read (the port's superblocked f32 render with its
program sequence, and its superblocked f64 render) is made once, in a
module-scoped fixture.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_voice_pool import _spy

import knaster_tpu as jk
import knaster_tpu.graph.processor as jP
import knaster_tpu_torch as kt
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from knaster_tpu_torch.utils.codec import read_flac

SR = 48000
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_GATE = 1e-6 + 2.0**-23
F64_TOL = 1e-12
AMP = 0.002
CROSSING = AMP * (1.0 / (0.005 * SR) + 1.0 / (0.01 * SR)) + 1e-7
FRAMES = 9600


def detuned_banks(m, dtype, render_chunk_blocks=128):
    """golden_configs.render_detuned_banks with either package: the
    processor with its schedule queued, not yet rendered."""
    rng = np.random.default_rng(42)
    V = 512
    fm_defaults = {
        "freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
        "ratio": rng.choice([1.0, 2.0, 3.0], V).astype(np.float32),
        "index": rng.uniform(0.5, 2.0, V).astype(np.float32),
        "amp": np.full(V, AMP, np.float32),
    }
    wt_defaults = {
        "freq": (330.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
        "amp": np.full(V, AMP, np.float32),
        "pan": rng.uniform(-1, 1, V).astype(np.float32),
    }
    harmonics = np.array([1.0, 0.6, 0.4, 0.25, 0.15, 0.08], np.float32)
    opts = m.AudioProcessorOptions(block_size=64, sample_rate=SR,
                                   render_chunk_blocks=render_chunk_blocks)
    kw = {"device": "cpu"} if m is kt else {}
    g, proc = m.AudioProcessor.new(0, 2, opts, dtype=dtype, **kw)
    hs = {}

    def build(gg):
        fm = gg.push(m.VoiceBank(m.FMVoice(), V, voice_defaults=fm_defaults,
                                 event_capacity=2048))
        wt = gg.push(m.VoiceBank(m.AdditiveVoice(harmonics=harmonics), V,
                                 voice_defaults=wt_defaults, event_capacity=2048))
        fm.out([0, 0]).to_graph_out()
        wt.to_graph_out()
        hs["fm"], hs["wt"] = fm, wt

    g.edit(build)

    def samples(n):
        return m.Seconds.from_samples(n, SR)

    tr_fm, fr_fm = hs["fm"].voice_param("t_restart"), hs["fm"].voice_param("freq")
    tr_wt, fr_wt = hs["wt"].voice_param("t_restart"), hs["wt"].voice_param("freq")
    for v in range(V):
        tr_fm.trig_at(v, samples(v % 64))
        tr_wt.trig_at(v, samples((v * 3) % 64))
    for k in range(64):
        v = int(rng.integers(0, V))
        fr_fm.smooth(v, 0.02)
        fr_fm.set_at(v, float(rng.uniform(150, 700)), samples(1000 + 37 * k))
        w = int(rng.integers(0, V))
        fr_wt.set_at(w, float(rng.uniform(200, 900)), samples(1500 + 53 * k))
    return proc


def _spied_render(m, dtype):
    """One render of ``detuned_banks`` with its (program, length) sequence.
    The JAX processor renders a run of 16 or more eventful blocks as one
    scan of its per-block program: that many single blocks."""
    with pytest.MonkeyPatch.context() as mp:
        proc = detuned_banks(m, dtype)
        seq = _spy(mp, m, proc)
        if m is jk:
            real = jP._get_full_scan_fn

            def full_scan(cg):
                fn = real(cg)

                def logged(state, ev_stack, inputs):
                    seq.extend([("full", 1)] * inputs.shape[0])
                    return fn(state, ev_stack, inputs)

                return logged

            mp.setattr(jP, "_get_full_scan_fn", full_scan)
        return seq, np.asarray(proc.render(frames=FRAMES))


@pytest.fixture(scope="module")
def f32_renders():
    """The port's and the JAX package's f32 renders with their sequences,
    made once for the tests of this module that read them."""
    return {m: _spied_render(m, dtype) for m, dtype in ((jk, np.float32), (kt, torch.float32))}


@pytest.fixture(scope="module")
def port_f64():
    """The port's superblocked f64 render, made once."""
    return detuned_banks(kt, torch.float64).render(frames=FRAMES)


@pytest.mark.parametrize("dtype,name", [(torch.float32, "f32"), (torch.float64, "f64")])
def test_detuned_banks_meets_golden(dtype, name, request):
    audio = (request.getfixturevalue("f32_renders")[kt][1] if name == "f32"
             else request.getfixturevalue("port_f64"))
    ref, sr = read_flac(os.path.join(GOLDEN_DIR, f"detuned_banks_{name}.flac"))
    assert sr == SR and ref.shape == audio.shape
    assert audio.dtype == (np.float32 if name == "f32" else np.float64)
    assert float(np.abs(audio.astype(np.float32) - ref).max()) <= GOLDEN_GATE
    assert np.abs(ref).max() > 0.1


def test_detuned_banks_takes_the_jax_partition(f32_renders):
    """The same (program, length) sequence as the JAX processor: eventful
    blocks one by one, each event-free run as superblocks; and the port's
    render within the gate of the JAX render made here."""
    (jseq, jout), (seq, out) = f32_renders[jk], f32_renders[kt]
    assert seq == jseq
    assert ("full", 1) in seq and any(p in ("super", "scan") for p, _ in seq)
    assert float(np.abs(out - jout).max()) <= GOLDEN_GATE


def test_superblocks_against_per_block(port_f64):
    """At f64: the superblocked render within ``CROSSING`` of the per-block
    one, and the port's per-block render within ``F64_TOL`` of the JAX
    package's per-block render (module docstring)."""
    import jax

    sup = port_f64
    per = detuned_banks(kt, torch.float64, render_chunk_blocks=1).render(frames=FRAMES)
    err = np.abs(sup - per)
    assert float(err.max()) <= CROSSING and float(err.max()) > 0
    with jax.enable_x64(True):
        jper = np.asarray(detuned_banks(jk, np.float64, render_chunk_blocks=1)
                          .render(frames=FRAMES))
    np.testing.assert_allclose(per, jper, rtol=0, atol=F64_TOL)
