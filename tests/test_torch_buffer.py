"""``Buffer`` and ``BufferReader`` in the port, against the JAX package.

- Ports of tests/test_ugens_misc.py:210-284: a reader that ends mid-block
  zero-fills the rest of that block and frees itself off the done frame;
  one that ends on a block edge frees at the next block; looping; a buffer
  at half the engine's rate plays through linear interpolation. And :297,
  the WAV round trip (float32, pcm16, pcm24) through ``Buffer.save_to_disk``.
- ``process`` block by block against the JAX package's at f32 and f64:
  rates that are not whole, a buffer at another sample rate, the
  start/duration/end windows (the f32 end-frame snap of 0.0005 s at 48 kHz
  included), a restart mid-block, the looping flag switched on and off:
  the carried state (int32 pointer, fractional part, ``finished``) and the
  done rows bit-equal, the output bit-equal where it is a copy of buffer
  samples (unit rate from a whole frame) and otherwise within ``OUT_TOL``
  (the JAX reader's ``lax.scan`` body is compiled, and XLA contracts its
  interpolation's multiply-add).
- A reader graph with a done action against the JAX graph.
- ``convert`` carries a reader's state both ways: the JAX state,
  converted, renders in the port as the JAX package goes on, and converts
  back equal.
"""

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu.core.ugen import AudioCtx as JCtx
from knaster_tpu_torch.convert import graph_state_from_jax, graph_state_to_numpy

SR = 48000
TDT = {np.float32: torch.float32, np.float64: torch.float64}
OUT_TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _proc(block_size=16, outputs=1):
    return kt.AudioProcessor.new(0, outputs, kt.AudioProcessorOptions(block_size=block_size),
                                 device="cpu")


def test_mid_block_end_zero_fill_and_free():
    """buffer.rs:148-188: the pointer crosses the end at sample 8 of block 2;
    the rest of that block is zeros and FREE_SELF fires off that frame."""
    data = np.arange(1, 25, dtype=np.float32)[None, :] / 100.0
    g, proc = _proc()

    def build(gg):
        r = gg.push_with_done_action(kt.BufferReader(kt.Buffer(data, SR), rate=1.0),
                                     kt.Done.FREE_SELF)
        r.to_graph_out()
        return r.id()

    rid = g.edit(build)
    proc.run_without_inputs()
    np.testing.assert_array_equal(proc.output_block()[0], data[0, :16])
    proc.run_without_inputs()
    out = proc.output_block()[0]
    np.testing.assert_array_equal(out[:8], data[0, 16:24])
    assert np.all(out[8:] == 0.0), out
    assert rid not in g.nodes
    proc.run_without_inputs()
    assert np.all(proc.output_block() == 0)


def test_plays_and_done_frees():
    data = np.arange(1, 33, dtype=np.float32)[None, :] / 100.0
    g, proc = _proc()

    def build(gg):
        r = gg.push_with_done_action(kt.BufferReader(kt.Buffer(data, SR), rate=1.0),
                                     kt.Done.FREE_SELF)
        r.to_graph_out()
        return r.id()

    rid = g.edit(build)
    for b in range(2):
        proc.run_without_inputs()
        np.testing.assert_array_equal(proc.output_block()[0], data[0, 16 * b:16 * (b + 1)])
    proc.run_without_inputs()  # past the end: done, freed
    assert rid not in g.nodes
    assert np.all(proc.output_block() == 0)


def test_looping_and_rate():
    g, proc = _proc()
    g.edit(lambda gg: gg.push(kt.BufferReader(kt.Buffer(np.arange(8, dtype=np.float32), SR),
                                              rate=1.0, looping=True)).to_graph_out())
    np.testing.assert_array_equal(proc.render(frames=32)[0], np.tile(np.arange(8), 4))


def test_resampling_rate():
    """A buffer at half the engine's rate: step 0.5, linear interpolation."""
    g, proc = _proc()
    g.edit(lambda gg: gg.push(kt.BufferReader(kt.Buffer(np.arange(16, dtype=np.float32),
                                                        SR // 2))).to_graph_out())
    np.testing.assert_allclose(proc.render(frames=16)[0], np.arange(16) * 0.5, atol=1e-5)


def test_wav_roundtrip_through_buffer(tmp_path):
    from knaster_tpu_torch.utils.wav import read_wav

    rng = np.random.default_rng(1)
    data = np.clip(rng.standard_normal((2, 1000)) * 0.5, -0.999, 0.999).astype(np.float32)
    for subtype, atol in (("float32", 0.0), ("pcm16", 1e-4), ("pcm24", 1e-6)):
        p = str(tmp_path / f"t_{subtype}.wav")
        kt.Buffer(data, 48000).save_to_disk(p, subtype)
        back, sr = read_wav(p)
        assert sr == 48000 and back.shape == data.shape
        np.testing.assert_allclose(back, data, atol=atol)
        buf = kt.Buffer.from_sound_file(p)
        assert buf.channels == 2 and buf.frames == 1000 and buf.sample_rate == 48000


def test_device_copy_is_made_once():
    buf = kt.Buffer(np.arange(8, dtype=np.float32), SR)
    a = buf.on("cpu", torch.float32)
    assert buf.on("cpu", torch.float32) is a
    b = buf.on("cpu", torch.float64)
    assert b.dtype == torch.float64 and b.shape == (1, 8)
    assert buf.length_seconds() == 8 / SR and buf.buf_rate_scale(24000) == 2.0


# ----------------------------------------------------- against the JAX package
def _rows(reader, B, b, dtype, start_s=0.0, end_s=-1.0, looping=None, restart=()):
    p = {"rate": np.full(B, reader.pdefaults["rate"], dtype),
         "looping": np.full(B, int(reader.pdefaults["looping"] if looping is None else looping),
                            np.int32),
         "start_s": np.full(B, start_s, dtype),
         "duration_s": np.full(B, reader.pdefaults["duration_s"], dtype),
         "end_s": np.full(B, end_s, dtype),
         "t_restart": np.zeros(B, bool)}
    for f in restart:
        p["t_restart"][f] = True
    return p


CASES = {
    # (buffer rate, reader rate, looping, rows of block b, done frames in all)
    "unit_oneshot": (SR, 1.0, False, lambda b: {}, 1),
    "half_rate_loop": (SR // 2, 1.3, True, lambda b: {"restart": (3,)} if b == 6 else {}, 0),
    # a 0.5 ms start, a 1.5 ms end, a restart, then the loop switched off
    "cd_rate_windows": (44100, 0.77, True, lambda b: {
        "start_s": 0.0005 if b >= 2 else 0.0, "end_s": 0.0015 if b >= 4 else -1.0,
        "restart": (9,) if b == 2 else (), "looping": b < 8}, 1),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_process_matches_jax(case, dtype):
    buf_sr, rate, looping, rows, want_dones = CASES[case]
    data = (np.random.default_rng(2).standard_normal((2, 100)) * 0.3).astype(np.float32)
    B = 16
    with jax.enable_x64(dtype == np.float64):
        jr = jk.BufferReader(jk.Buffer(data, buf_sr), rate=rate, looping=looping)
        tr = kt.BufferReader(kt.Buffer(data, buf_sr), rate=rate, looping=looping)
        jctx, tctx = JCtx(SR, B, dtype), kt.AudioCtx(SR, B, TDT[dtype])
        js, ts = jr.init(jctx), tr.init(tctx)
        jprocess = jax.jit(lambda s, p: jr.process(jctx, s, np.zeros((0, B), dtype), p))
        dones = 0
        for b in range(14):
            p = _rows(jr, B, b, dtype, **rows(b))
            js, jo, jd = jprocess(js, p)
            ts, to, td = tr.process(tctx, ts, torch.zeros((0, B), dtype=TDT[dtype]),
                                    {k: torch.from_numpy(v) for k, v in p.items()})
            tol = 0.0 if case == "unit_oneshot" else OUT_TOL[dtype]
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=tol,
                                       err_msg=f"block {b}")
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            dones += int(td.sum())
            for k, v in graph_state_to_numpy(ts, like=js).items():
                np.testing.assert_array_equal(v, np.asarray(js[k]), err_msg=f"{k} block {b}")
        assert dones == want_dones


def test_state_from_jax_continues_as_jax():
    data = (np.random.default_rng(3).standard_normal((1, 200)) * 0.3).astype(np.float32)
    jr, tr = jk.BufferReader(jk.Buffer(data, 44100), rate=1.1), kt.BufferReader(
        kt.Buffer(data, 44100), rate=1.1)
    B = 16
    jctx, tctx = JCtx(SR, B, np.float32), kt.AudioCtx(SR, B)
    jprocess = jax.jit(lambda s, p: jr.process(jctx, s, np.zeros((0, B), np.float32), p))
    js = jr.init(jctx)
    for b in range(5):
        js, _, _ = jprocess(js, _rows(jr, B, b, np.float32))
    ts = graph_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert ts["ptr_int"].dtype == torch.int32 and ts["finished"].dtype == torch.bool
    for b in range(5, 9):
        p = _rows(jr, B, b, np.float32)
        js, jo, jd = jprocess(js, p)
        ts, to, td = tr.process(tctx, ts, torch.zeros((0, B)),
                                {k: torch.from_numpy(v) for k, v in p.items()})
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=OUT_TOL[np.float32])
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for k, v in graph_state_to_numpy(ts, like=js).items():
        np.testing.assert_array_equal(v, np.asarray(js[k]), err_msg=k)


def _reader_graph(m, dtype):
    """Two readers (one looping at a fractional rate, one one-shot freed by
    its done) with a restart and a start set mid-render."""
    kw = {"device": "cpu", "dtype": TDT[dtype]} if m is kt else {"dtype": dtype}
    g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=64), **kw)
    data = (np.random.default_rng(4).standard_normal(300) * 0.3).astype(np.float32)

    def build(gg):
        a = gg.push(m.BufferReader(m.Buffer(data, 44100), rate=0.9, looping=True))
        b = gg.push_with_done_action(m.BufferReader(m.Buffer(data[::-1].copy(), SR)),
                                     m.Done.FREE_SELF)
        a.to_graph_out()
        b.to_graph_out()
        return a

    a = g.edit(build)
    a.param("start_s").set_at(0.001, m.Seconds.from_samples(20, SR))
    a.param("t_restart").trig_at(m.Seconds.from_samples(40, SR))
    return np.asarray(proc.render(frames=17 * 64))  # block 0, then one superblock


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_graph_matches_jax(dtype):
    port = _reader_graph(kt, dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = _reader_graph(jk, dtype)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(port, ref, rtol=0, atol=OUT_TOL[dtype])
