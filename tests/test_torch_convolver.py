"""``Convolver`` in the port, against a direct convolution and the JAX package.

- Ports of tests/test_convolver.py:44-210: mono, IRs shorter than a block
  and exact multiples of it, a stereo IR on a mono input, per-channel
  convolution, the dry/wet mix, ``BufferReader -> Convolver`` in a graph
  with a sample-accurate dry/wet set, a k-block superblock against k
  blocks, superblock eligibility, and an IR from a sound file: each against
  ``np.convolve`` within the reference's own bound (``DIRECT_TOL``, 2e-4).
- ``process`` against the JAX package's at f32 and f64, carried state
  included, within ``JAX_TOL``: the DFT products sum 2P terms, and the
  spectral multiply-add K partitions, in another order in torch's matmul
  and sum than in XLA's (the reference allows 1e-5 between its own
  superblocked and per-block rounds for the same reason); the spectra
  ``Hr``/``Hi`` come from the same numpy FFT and are equal.
- The suite's ``convolver`` cell (benchmarks/suite.py:1296-1330:
  ``WhiteNoise(seed=5)`` into a stereo IR shaped by exp(-3t) * 0.02) with
  a 25 ms IR in a graph against the JAX graph at f32 (the cell's dtype;
  ``process`` is held at f64 above), and superblocked against per block
  (bit-equal: the same rounds in the same order).
- ``ieee_fp32_matmul`` turns TF32 off inside and restores the caller's
  setting after, whatever it was.
- ``convert`` carries a convolver's state both ways: the JAX state,
  converted, renders in the port as the JAX package goes on, and the
  port's converts back to the JAX layout.
"""

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu.core.ugen import AudioCtx as JCtx
from knaster_tpu_torch.convert import graph_state_from_jax, graph_state_to_numpy
from knaster_tpu_torch.graph.compile import superblock_eligible
from knaster_tpu_torch.ugens.convolver import ieee_fp32_matmul, tf32_off

SR = 48000
TDT = {np.float32: torch.float32, np.float64: torch.float64}
DIRECT_TOL = 2e-4
JAX_TOL = {np.float32: 4e-6, np.float64: 1e-12}
GRAPH_TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _direct(x, h):
    return np.convolve(x, h)[: len(x)]


def _run_node(conv, x_rows, B, dry_wet=1.0):
    """``Convolver.process`` over consecutive blocks."""
    ctx = kt.AudioCtx(SR, B)
    st = conv.init(ctx)
    outs = []
    for b in range(x_rows.shape[1] // B):
        blk = torch.from_numpy(np.ascontiguousarray(x_rows[:, b * B:(b + 1) * B]))
        st, out = conv.process(ctx, st, blk, {"dry_wet": torch.full((B,), dry_wet)})
        outs.append(out.numpy())
    return np.concatenate(outs, axis=1)


def test_mono_exact_vs_direct():
    rng = np.random.default_rng(0)
    h = rng.standard_normal(300).astype(np.float32) * 0.1  # K = 5 partitions
    x = rng.standard_normal(64 * 8).astype(np.float32)
    np.testing.assert_allclose(_run_node(kt.Convolver(h), x[None, :], 64)[0], _direct(x, h),
                               atol=DIRECT_TOL)


@pytest.mark.parametrize("L", [1, 7, 64, 128])
def test_ir_shorter_than_block_and_exact_multiple(L):
    rng = np.random.default_rng(1 + L)
    h = rng.standard_normal(L).astype(np.float32) * 0.2
    x = rng.standard_normal(64 * 5).astype(np.float32)
    np.testing.assert_allclose(_run_node(kt.Convolver(h), x[None, :], 64)[0], _direct(x, h),
                               atol=DIRECT_TOL)


def test_stereo_ir_mono_input():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 150)).astype(np.float32) * 0.1
    x = rng.standard_normal(32 * 6).astype(np.float32)
    out = _run_node(kt.Convolver(h), x[None, :], 32)
    for c in range(2):
        np.testing.assert_allclose(out[c], _direct(x, h[c]), atol=DIRECT_TOL)


def test_per_channel_convolution():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 100)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 32 * 6)).astype(np.float32)
    out = _run_node(kt.Convolver(h, inputs=2), x, 32)
    for c in range(2):
        np.testing.assert_allclose(out[c], _direct(x[c], h[c]), atol=DIRECT_TOL)


def test_dry_wet_mix():
    rng = np.random.default_rng(4)
    h = rng.standard_normal(80).astype(np.float32) * 0.1
    x = rng.standard_normal(64 * 4).astype(np.float32)
    got = _run_node(kt.Convolver(h, dry_wet=0.25), x[None, :], 64, dry_wet=0.25)[0]
    np.testing.assert_allclose(got, 0.25 * _direct(x, h) + 0.75 * x, atol=DIRECT_TOL)


def test_in_graph_render_and_param():
    """BufferReader -> Convolver in a graph; a dry_wet set at an exact
    mid-block frame."""
    rng = np.random.default_rng(5)
    B = 64
    sig = rng.standard_normal(B * 6).astype(np.float32) * 0.3
    h = np.zeros(96, np.float32)
    h[0], h[40], h[90] = 1.0, 0.5, 0.25  # a sparse echo IR
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B),
                                    device="cpu")

    def build(gg):
        rd = gg.push(kt.BufferReader(kt.Buffer(sig[None, :], SR)))
        cv = gg.push(kt.Convolver(h))
        rd.to(cv)
        cv.to_graph_out()
        return cv

    cv = g.edit(build)
    np.testing.assert_allclose(proc.render(frames=B * 6)[0], _direct(sig, h), atol=DIRECT_TOL)
    cv.param("dry_wet").set_after(0.0, kt.Seconds.from_samples(B + 10, SR))
    out2 = proc.render(frames=2 * B)[0]
    # the reader has ended (outputs 0) but the IR's tail rings until the set
    assert np.abs(out2[B + 10:]).max() == 0.0
    assert np.abs(out2[: B + 10]).max() > 0.0


def test_superblock_program_parity():
    """A k-block superblock runs the same rounds as k blocks: equal, and
    each equal to the direct convolution."""
    rng = np.random.default_rng(7)
    B, k = 64, 4
    h = rng.standard_normal(300).astype(np.float32) * 0.1
    x = rng.standard_normal(B * k * 2).astype(np.float32)
    conv = kt.Convolver(h)
    a = _run_node(conv, x[None, :], B)
    ctx, ctx_super = kt.AudioCtx(SR, B), kt.AudioCtx(SR, B * k)
    st = conv.init(ctx)
    outs = []
    for s in range(2):
        blk = torch.from_numpy(x[None, s * B * k:(s + 1) * B * k].copy())
        st, o = conv.process(ctx_super, st, blk, {"dry_wet": torch.ones(B * k)})
        outs.append(o.numpy())
    np.testing.assert_array_equal(a, np.concatenate(outs, axis=1))
    np.testing.assert_allclose(a[0], _direct(x, h), atol=DIRECT_TOL)


def test_superblock_eligibility_in_graph():
    h = np.random.default_rng(8).standard_normal(200).astype(np.float32) * 0.1
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=64),
                                    device="cpu")

    def build(gg):
        n = gg.push(kt.WhiteNoise(seed=3))
        cv = gg.push(kt.Convolver(h))
        n.to(cv)
        cv.to_graph_out()

    g.edit(build)
    proc._ensure_compiled()
    assert superblock_eligible(proc.compiled)


def test_from_sound_file_ir(tmp_path):
    from knaster_tpu_torch.utils.wav import write_wav

    rng = np.random.default_rng(9)
    h = (rng.standard_normal((2, 120)) * 0.1).astype(np.float32)
    path = str(tmp_path / "ir.wav")
    write_wav(path, h, SR)
    conv = kt.Convolver.from_sound_file(path)
    assert conv.outputs == 2 and conv.ir_length == 120 and conv.name() == "Convolver[2ch x 120]"
    x = rng.standard_normal(64 * 4).astype(np.float32)
    out = _run_node(conv, x[None, :], 64)
    for c in range(2):
        np.testing.assert_allclose(out[c], _direct(x, h[c]), atol=DIRECT_TOL)


def test_rejects_bad_irs():
    with pytest.raises(ValueError):
        kt.Convolver(np.zeros((2, 3, 4), np.float32))
    with pytest.raises(ValueError):
        kt.Convolver(np.zeros((2, 10), np.float32), inputs=3)


def test_tf32_is_off_inside_and_restored_after():
    """Whatever the caller set (through either of torch's APIs), the
    convolver's products run with TF32 off, and the caller's setting is
    back after."""
    m = torch.backends.cuda.matmul
    before = torch.get_float32_matmul_precision()
    name = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
    before_m = getattr(m, name)
    try:
        for outside in (True, False):
            m.allow_tf32 = outside
            with ieee_fp32_matmul():
                assert tf32_off()
            assert m.allow_tf32 is outside and tf32_off() is not outside
        torch.set_float32_matmul_precision("high")
        assert not tf32_off()
        with ieee_fp32_matmul():
            assert tf32_off()
        assert not tf32_off()
    finally:
        torch.set_float32_matmul_precision(before)
        setattr(m, name, before_m)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("inputs,B", [(1, 64), (2, 32), (1, 128)], ids=["mono", "stereo", "B128"])
def test_process_matches_jax(inputs, B, dtype):
    """Mono-to-stereo and per-channel IRs; at B = 128 two 64-sample rounds a
    block. A dry/wet ramp; state compared each block."""
    rng = np.random.default_rng(11)
    h = (rng.standard_normal((2, 300)) * 0.1).astype(np.float32)
    with jax.enable_x64(dtype == np.float64):
        jc, tc = jk.Convolver(h, inputs=inputs), kt.Convolver(h, inputs=inputs)
        jctx, tctx = JCtx(SR, B, dtype), kt.AudioCtx(SR, B, TDT[dtype])
        js, ts = jc.init(jctx), tc.init(tctx)
        jprocess = jax.jit(lambda s, x, p: jc.process(jctx, s, x, p))
        for b in range(6):
            x = rng.standard_normal((inputs, B)).astype(dtype)
            dw = np.linspace(0.2, 0.9, B).astype(dtype)
            js, jo = jprocess(js, x, {"dry_wet": dw})
            ts, to = tc.process(tctx, ts, torch.from_numpy(x), {"dry_wet": torch.from_numpy(dw)})
            assert to.dtype == TDT[dtype]
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=JAX_TOL[dtype],
                                       err_msg=f"block {b}")
            for k, v in js.items():
                v = np.asarray(v)
                scale = max(float(np.abs(v).max()), 1.0)
                np.testing.assert_allclose(ts[k].numpy(), v, rtol=0,
                                           atol=JAX_TOL[dtype] * scale, err_msg=f"{k} block {b}")
            np.testing.assert_array_equal(ts["Hr"].numpy(), np.asarray(js["Hr"]))


def test_state_from_jax_continues_as_jax():
    rng = np.random.default_rng(12)
    h = (rng.standard_normal(200) * 0.1).astype(np.float32)
    jc, tc = jk.Convolver(h), kt.Convolver(h)
    B = 64
    jctx, tctx = JCtx(SR, B, np.float32), kt.AudioCtx(SR, B)
    jprocess = jax.jit(lambda s, x, p: jc.process(jctx, s, x, p))
    dw = {"dry_wet": np.ones(B, np.float32)}
    js = jc.init(jctx)
    for _ in range(3):
        js, _ = jprocess(js, rng.standard_normal((1, B)).astype(np.float32), dw)
    ts = graph_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    for _ in range(3):
        x = rng.standard_normal((1, B)).astype(np.float32)
        js, jo = jprocess(js, x, dw)
        ts, to = tc.process(tctx, ts, torch.from_numpy(x), {"dry_wet": torch.ones(B)})
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=JAX_TOL[np.float32])
    back = graph_state_to_numpy(ts, like=js)
    for k, v in js.items():
        v = np.asarray(v)
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_allclose(back[k], v, rtol=0,
                                   atol=JAX_TOL[np.float32] * max(float(np.abs(v).max()), 1.0))


def _convolver_graph(m, dtype, chunk=None, L=1200, frames=33 * 64):
    """benchmarks/suite.py:1296-1330 with a 25 ms IR: WhiteNoise(seed=5)
    into a stereo IR from default_rng(0) shaped by exp(-3t) * 0.02, and a
    dry/wet set mid-block in block 16 (two 16-block superblocks around it:
    one superblock program)."""
    kw = {"device": "cpu", "dtype": TDT[dtype]} if m is kt else {"dtype": dtype}
    opts = m.AudioProcessorOptions(block_size=64, sample_rate=SR,
                                   **({"render_chunk_blocks": chunk} if chunk else {}))
    g, proc = m.AudioProcessor.new(0, 2, opts, **kw)
    t = np.arange(L, dtype=np.float32) / SR
    ir = (np.random.default_rng(0).standard_normal((2, L)).astype(np.float32)
          * np.exp(-3.0 * t)[None, :] * 0.02)

    def build(gg):
        n = gg.push(m.WhiteNoise(seed=5))
        cv = gg.push(m.Convolver(ir))
        n.to(cv)
        cv.to_graph_out()
        return cv

    cv = g.edit(build)
    cv.param("dry_wet").set_at(0.5, m.Seconds.from_samples(16 * 64 + 23, SR))
    return np.asarray(proc.render(frames=frames))


@pytest.mark.parametrize("dtype", [np.float32], ids=["f32"])
def test_graph_matches_jax_and_partitions(dtype):
    port = _convolver_graph(kt, dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = _convolver_graph(jk, dtype)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(port, ref, rtol=0, atol=GRAPH_TOL[dtype])
    np.testing.assert_array_equal(port, _convolver_graph(kt, dtype, chunk=1))
