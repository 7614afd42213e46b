"""``SamplerVoice`` in the port, against the JAX package.

- Ports of tests/test_voicebank.py:523-600 and 990-1200: the closed-form
  pointer against a per-sample numpy model (mid-block restart, loop wrap,
  fractional rate, one-shot end), a bank at four rates (spectral peaks),
  the tiled and resampling reads against the gather read (bit-equal), the
  tiled bank, the tiled read's validation, and the resampler's edges
  (loops shorter than a block's window, the event-free program, the rate
  clamp at B = 64 and 512).
- ``process`` block by block against the JAX package's own three reads
  (its gather, its tile-and-barrel-roll ``tiled`` read and its windowed
  one-hot ``resample`` read, called op by op as its own tests call them: a
  jitted block contracts the position's multiply-add even at XLA's level
  0), loop and one-shot, the gather at f32 and f64 and the other two at
  f32 (the port computes all three through the gather; the graph test
  holds the resampler at f64): outputs, done rows and carried state
  bit-equal (the output is a copy of buffer samples, interpolated the same
  way).
- The suite's ``sampler_bank`` and ``sampler_resample`` cells
  (benchmarks/suite.py:646-749) at a small size in a graph against the JAX
  graph, within ``GRAPH_TOL`` (the JAX block program is jitted at XLA's
  default level, which contracts the position's multiply-add), and the
  superblocked render against the per-block one within ``PARTITION_TOL``
  (a superblock evaluates ``pos + step * t`` from another block start, an
  ulp of the position apart); the superblock cap the tiled voice declares.
  (``examples/drum_machine.py``: tests/test_torch_drum_machine.py.)
- ``convert.bank_state_from_jax`` carries a bank's nested sampler state
  (``pos_int``, ``pos_frac``, ``playing`` and the envelope) both ways.
"""

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu.core.ugen import AudioCtx as JCtx
from knaster_tpu.models.voices import SamplerVoice as JSamplerVoice
from knaster_tpu_torch.convert import bank_state_from_jax, bank_state_to_numpy

SR = 48000
TDT = {np.float32: torch.float32, np.float64: torch.float64}
GRAPH_TOL = {np.float32: 1e-6, np.float64: 1e-12}
PARTITION_TOL = {np.float32: 1e-6, np.float64: 1e-12}
EXACT = {"xla_backend_optimization_level": 0, "xla_disable_hlo_passes": "algsimp"}


def _params(B, rate, trig=(), release=(), dtype=np.float32, pan=-1.0):
    p = {"rate": np.full(B, rate, dtype), "amp": np.ones(B, dtype),
         "pan": np.full(B, pan, dtype),  # -1: all left, gain 1
         "t_restart": np.zeros(B, bool), "t_release": np.zeros(B, bool)}
    for f in trig:
        p["t_restart"][f] = True
    for f in release:
        p["t_release"][f] = True
    return p


def _run(voice, trig_frames, n_blocks, rate, B=64, no_events=False, dtype=np.float32):
    """The port's voice block by block (restarts at (block, frame)): the
    left channel."""
    ctx = kt.AudioCtx(SR, B, TDT[dtype], no_events=no_events)
    st = voice.init(ctx)
    outs = []
    for b in range(n_blocks):
        trig = [f for bb, f in trig_frames if bb == b and not no_events]
        p = _params(B, rate, trig, dtype=dtype)
        st, out, _ = voice.process(ctx, st, torch.zeros((0, B), dtype=TDT[dtype]),
                                   {k: torch.from_numpy(v) for k, v in p.items()})
        outs.append(out[0].numpy())
    return np.concatenate(outs)


def test_closed_form_against_numpy_model():
    n = 100
    ramp = np.arange(n, dtype=np.float32)  # buffer[i] = i: the output is the position
    got = _run(kt.SamplerVoice(ramp, loop=True, attack=0.0, release=0.01),
               [(0, 5)], 4, 1.7)
    t = np.arange(256)
    pos = np.where(t >= 5, 1.7 * (t - 5), 0.0)
    ip = np.floor(pos)
    fr = (pos - ip).astype(np.float32)
    i0, i1 = ip.astype(int) % n, (ip.astype(int) + 1) % n
    expect = (ramp[i0] + (ramp[i1] - ramp[i0]) * fr) * (t >= 5)
    # attack 0: the envelope reaches 1 one sample after the trigger
    expect = np.where(t >= 6, expect, 0.0)
    got_cmp = np.where(t >= 6, got, 0.0)
    np.testing.assert_allclose(got_cmp, expect, atol=2e-3)
    assert got_cmp[150] > 0  # looped past the end and kept playing
    one = _run(kt.SamplerVoice(ramp, loop=False, attack=0.0, release=0.01), [(0, 0)], 4, 1.0)
    assert np.abs(one[102:]).max() == 0.0
    np.testing.assert_allclose(one[50], 50.0, atol=1e-3)


def _spectral_peaks(a, freqs_hz):
    spec = np.abs(np.fft.rfft(a[0] * np.hanning(a.shape[1])))
    freqs = np.fft.rfftfreq(a.shape[1], 1 / SR)
    floor = spec[freqs > 1200].max()
    for f in freqs_hz:
        band = spec[(freqs > f - 40) & (freqs < f + 40)].max()
        assert band > 5 * floor, (f, band, floor)


def _tone(freq, n=4800):
    return np.sin(2 * np.pi * freq * np.arange(n) / SR).astype(np.float32)


@pytest.mark.parametrize("tiled", [False, True], ids=["gather", "tiled"])
def test_bank_plays_its_rates(tiled):
    """tests/test_voicebank.py:560, 1043: four voices at 0.5, 1, 2 and 1.5
    times a 440 Hz tone (the tiled read at unit rate: 440 Hz only)."""
    g, proc = kt.AudioProcessor.new(0, 2, kt.AudioProcessorOptions(block_size=64),
                                    device="cpu")
    vd = {"amp": np.full(4, 0.1, np.float32)}
    if not tiled:
        vd["rate"] = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
    bank = g.edit(lambda gg: gg.push(kt.VoiceBank(
        kt.SamplerVoice(_tone(440.0), loop=True, attack=0.001, release=0.05, tiled=tiled),
        4, voice_defaults=vd)))
    bank.to_graph_out()
    g.commit()
    for v in range(4):
        bank.voice_param("t_restart").trig(v)
    a = proc.render(frames=4096)
    assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
    _spectral_peaks(a, (440,) if tiled else (220, 440, 660, 880))


@pytest.mark.parametrize("loop", [True, False])
def test_tiled_and_resample_equal_the_gather_read(loop):
    rng = np.random.default_rng(5)
    buf = rng.standard_normal(300).astype(np.float32)
    ref = _run(kt.SamplerVoice(buf, loop=loop, attack=0.0, release=0.01), [(0, 5), (4, 33)],
               8, 1.0)
    til = _run(kt.SamplerVoice(buf, loop=loop, attack=0.0, release=0.01, tiled=True),
               [(0, 5), (4, 33)], 8, 1.0)
    np.testing.assert_array_equal(til, ref)
    for rate in (0.73, 1.31, 1.99):
        ref = _run(kt.SamplerVoice(buf, loop=loop, attack=0.0, release=0.01),
                   [(0, 5), (4, 33)], 8, rate)
        got = _run(kt.SamplerVoice(buf, loop=loop, attack=0.0, release=0.01, resample=True),
                   [(0, 5), (4, 33)], 8, rate)
        np.testing.assert_array_equal(got, ref)


def test_tiled_validation_and_cap():
    ctx = kt.AudioCtx(SR, 64)
    with pytest.raises(ValueError):  # a loop shorter than a block
        kt.SamplerVoice(np.zeros(32, np.float32), tiled=True).init(ctx)

    class FakeBuf:
        data = np.zeros(300, np.float32)
        sample_rate = 44100

    with pytest.raises(ValueError):  # the buffer at another sample rate
        kt.SamplerVoice(FakeBuf(), tiled=True).init(ctx)
    with pytest.raises(ValueError):
        kt.SamplerVoice(np.zeros(300, np.float32), tiled=True, resample=True)
    v = kt.SamplerVoice(np.zeros(300, np.float32), tiled=True)
    bank = kt.VoiceBank(v, 4)
    bank.init(ctx)
    assert v.block_invariant is False and v.superblock_cap == 300
    assert bank.superblock_cap == 300


def test_resample_edges():
    """Loops shorter than the block's window, the event-free program and the
    rate clamp (at B = 64 and at 512)."""
    rng = np.random.default_rng(6)
    for L in (17, 50):
        buf = rng.standard_normal(L).astype(np.float32)
        ref = _run(kt.SamplerVoice(buf, loop=True, attack=0.0, release=0.01), [(0, 3)], 6, 1.99)
        got = _run(kt.SamplerVoice(buf, loop=True, attack=0.0, release=0.01, resample=True),
                   [(0, 3)], 6, 1.99)
        np.testing.assert_array_equal(got, ref)
    buf = rng.standard_normal(300).astype(np.float32)
    v = kt.SamplerVoice(buf, loop=True, attack=0.0, release=0.01, resample=True)
    ref = kt.SamplerVoice(buf, loop=True, attack=0.0, release=0.01)
    for B, n in ((64, 8), (512, 2)):
        np.testing.assert_array_equal(_run(v, [(0, 3)], n, 5.0, B=B),
                                      _run(ref, [(0, 3)], n, 2.0, B=B))
    # the event-free program continues a playing voice as the eventful one
    outs = []
    for no_events in (False, True):
        ctx = kt.AudioCtx(SR, 64)
        st = v.init(ctx)
        p = {k: torch.from_numpy(x) for k, x in _params(64, 1.31, trig=(0,)).items()}
        st, _, _ = v.process(ctx, st, torch.zeros((0, 64)), p)
        run_ctx = kt.AudioCtx(SR, 64, no_events=no_events)
        p["t_restart"] = torch.zeros(64, dtype=torch.bool)
        chunks = []
        for _ in range(5):
            st, o, _ = v.process(run_ctx, st, torch.zeros((0, 64)), p)
            chunks.append(o[0].numpy())
        outs.append(np.concatenate(chunks))
    np.testing.assert_array_equal(outs[1], outs[0])


def _cmp_state(got, want, where):
    for k, v in want.items():
        if isinstance(v, dict):
            _cmp_state(got[k], v, where)
            continue
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=f"{k} {where}")


READS = {"gather": {}, "tiled": {"tiled": True}, "resample": {"resample": True}}


PARITY = [(read, loop, dtype) for read in READS for loop in (True, False)
          for dtype in ((np.float32, np.float64) if read == "gather" else (np.float32,))]


@pytest.mark.parametrize("read,loop,dtype", PARITY, ids=[
    f"{r}-{'loop' if lp else 'oneshot'}-{'f32' if d == np.float32 else 'f64'}"
    for r, lp, d in PARITY])
def test_process_matches_jax(read, loop, dtype):
    """The port's gather read against the JAX package's ``read`` path, op by
    op: restarts mid-block, a release, a rate that changes between blocks
    and one past the resampler's clamp."""
    rng = np.random.default_rng(5)
    buf = rng.standard_normal(300).astype(np.float32)
    rates = (1.0,) if read == "tiled" else (0.73, 1.99, 5.0, 1.31)
    B = 64
    with jax.enable_x64(dtype == np.float64):
        jv = JSamplerVoice(buf, loop=loop, attack=0.0005, release=0.002, **READS[read])
        tv = kt.SamplerVoice(buf, loop=loop, attack=0.0005, release=0.002, **READS[read])
        jctx, tctx = JCtx(SR, B, dtype), kt.AudioCtx(SR, B, TDT[dtype])
        js, ts = jv.init(jctx), tv.init(tctx)
        for b in range(6):
            rate = rates[b % len(rates)]
            p = _params(B, rate, trig={0: (5,), 3: (33,), 5: (63,)}.get(b, ()),
                        release=(10,) if b == 4 else (), dtype=dtype, pan=0.3)
            js, jo, jd = jv.process(jctx, js, np.zeros((0, B), dtype), p)
            ts, to, td = tv.process(tctx, ts, torch.zeros((0, B), dtype=TDT[dtype]),
                                    {k: torch.from_numpy(x) for k, x in p.items()})
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo),
                                          err_msg=f"rate {rate} block {b}")
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            _cmp_state(ts, js, f"rate {rate} block {b}")


def test_bank_state_from_jax_continues_as_jax():
    """A JAX sampler bank's state after a restart block, converted, renders
    in the port as the JAX bank goes on; and converts back."""
    V, B = 4, 64
    tone = _tone(330.0)
    vd = {"amp": np.full(V, 0.1, np.float32),
          "rate": np.array([0.5, 0.99, 1.31, 1.87], np.float32)}
    jb = jk.VoiceBank(JSamplerVoice(tone, loop=True, attack=0.001, release=0.05), V,
                      voice_defaults=vd)
    tb = kt.VoiceBank(kt.SamplerVoice(tone, loop=True, attack=0.001, release=0.05), V,
                      voice_defaults=vd)
    jctx, tctx = JCtx(SR, B, np.float32), kt.AudioCtx(SR, B)
    ev = [(3 * v, v, jb.trig_index("t_restart"), 1, 0.0) for v in range(V)]
    js, _, _ = jax.jit(lambda s, e: jb.process(jctx, s, np.zeros((0, B), np.float32), {},
                                              events=e),
                       compiler_options=EXACT)(jb.init(jctx), jb.node_events_from_lists(ev))
    ts = bank_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert ts["voices"]["pos_int"].shape == (V,) and ts["voices"]["env"]["t"].shape == (V,)
    jrun = jax.jit(lambda s: jb.process(jctx, s, np.zeros((0, B), np.float32), {}, events=None),
                   compiler_options=EXACT)
    for _ in range(3):
        js, jo, _ = jrun(js)
        ts, to, _ = tb.process(tctx, ts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-7)
    back = bank_state_to_numpy(ts, like=jax.tree_util.tree_map(np.asarray, js))
    for k, v in back["voices"].items():
        if not isinstance(v, dict):
            np.testing.assert_array_equal(v, np.asarray(js["voices"][k]), err_msg=k)


# ------------------------------------------------------------ in a graph
def _proc(m, dtype, chunk=None):
    kw = {"device": "cpu", "dtype": TDT[dtype]} if m is kt else {"dtype": dtype}
    opts = m.AudioProcessorOptions(block_size=64, sample_rate=SR,
                                   **({"render_chunk_blocks": chunk} if chunk else {}))
    return m.AudioProcessor.new(0, 2, opts, **kw)


def _sampler(m):
    return kt.SamplerVoice if m is kt else JSamplerVoice


def _sampler_bank(m, dtype, resample=False, chunk=None, V=8):
    """benchmarks/suite.py:646-749 at 8 voices over a 0.1 s 220 Hz tone: a
    note-on block, then an event-free run of 16 blocks; ``resample`` takes
    rates U(0.5, 1.99) from default_rng(11)."""
    g, proc = _proc(m, dtype, chunk)
    vd = {"amp": np.full(V, 0.01, np.float32)}
    if resample:
        vd["rate"] = np.random.default_rng(11).uniform(0.5, 1.99, V).astype(np.float32)
    kw = {"resample": True} if resample else {"tiled": True}
    bank = g.edit(lambda gg: gg.push(m.VoiceBank(_sampler(m)(_tone(220.0), loop=True, **kw),
                                                 V, voice_defaults=vd)))
    bank.to_graph_out()
    g.commit()
    for v in range(V):
        bank.voice_param("t_restart").trig_at(v, m.Seconds.from_samples(5 * v, SR))
    # a note-on block and one 16-block superblock: one superblock program
    return np.asarray(proc.render(frames=17 * 64))


GRAPHS = {"sampler_bank": _sampler_bank,
          "sampler_resample": lambda m, d, chunk=None: _sampler_bank(m, d, True, chunk)}


@pytest.mark.parametrize("name,dtype", [("sampler_bank", np.float32),
                                        ("sampler_resample", np.float64)])
def test_graph_matches_jax_and_partitions(name, dtype):
    port = GRAPHS[name](kt, dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = GRAPHS[name](jk, dtype)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(port, ref, rtol=0, atol=GRAPH_TOL[dtype])
    np.testing.assert_allclose(port, GRAPHS[name](kt, dtype, chunk=1), rtol=0,
                               atol=PARTITION_TOL[dtype])
