"""Galactic in the port against the JAX package: the blockwise and the
per-sample path, the vectorised vibrato/xorshift chain, and the
``galactic_chain`` graph (benchmarks/suite.py:475-498).

- The xorshift dither stream is integer-exact: the GF(2) columns, every
  fpd value and the carried fpd equal the JAX package's.
- ``_vib_fpd_vectorized`` against ``_vib_fpd_scan`` in the port itself,
  across a 2 pi vibrato reset (tests/test_galactic.py:75): u32 words
  exact; the vibrato phase within 2e-5 as there, and the read offsets
  (127 (sin + 1), in [0, 254]) within ``OFFSET_TOL`` = 4 ulp there, 2^-14:
  the phase is one sum per sample against a prefix sum, and 127 times its
  ulp-level difference is one or two ulp of the offset (measured 3.05e-5,
  the JAX package's own test holds 2e-5 with XLA's fused multiply-adds).
- Both paths of ``process`` against the JAX one over 24 blocks of 64 with
  ``bigness`` 0.1 (the shortest path through the three banks, ~920
  samples, reaches the output), the JAX side in its f32 configuration (x64
  off, as the f32 fixtures were rendered) and without fused
  multiply-adds: outputs within ``TOL`` = 1e-6 (measured 4.8e-8 blockwise,
  6.9e-8 per sample), the line contents and filter state within
  ``STATE_TOL`` = 1e-5 (measured 3.5e-6 on lines of peak 0.22). What
  differs is float rounding: torch's CPU sin against XLA's in the vibrato
  offsets, whose ulp moves the detune read's interpolation fraction by up
  to 254 ulp of the fraction, and the lowpasses' scan association.
- ``galactic_chain`` (0.1 s, B = 64) through both packages' renderers:
  the same (program, length) sequence (loops of 8-block superblocks under
  Galactic's 740-sample cap) and samples within ``TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.compile as jC
import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.compile as tC
from knaster_tpu.airwindows import Galactic as JGalactic
from knaster_tpu_torch.convert import graph_state_to_numpy
from knaster_tpu_torch.kernels.bank_common import i32_of
from tests.test_torch_superblock import spy_programs

SR = 48000
TOL = 1e-6
STATE_TOL = 1e-5
OFFSET_TOL = 2.0**-14
NO_FMA = {"xla_backend_optimization_level": 0}
PARAMS = dict(replace=0.3, detune=0.9, brightness=0.6, bigness=0.1, wet=0.5)


@pytest.fixture(autouse=True)
def _fresh():
    jC.clear_program_cache()
    tC.clear_program_cache()
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


def test_xorshift_columns_and_init_match_jax():
    for n in (1, 64, 740):
        np.testing.assert_array_equal(
            kt.Galactic._xorshift_columns(n).astype(np.uint32), JGalactic._xorshift_columns(n))
    for seed in (0, 9, 2**31):
        js = JGalactic(seed=seed).init(jk.AudioCtx(SR, 64, np.float32))
        tu = kt.Galactic(seed=seed)
        ts = tu.init(kt.AudioCtx(SR, 64, torch.float32))
        back = graph_state_to_numpy(ts, like=jax.tree_util.tree_map(np.asarray, js))
        for k, v in js.items():
            np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        assert tu.superblock_cap == 740 and not tu.block_invariant
    assert kt.Galactic(blockwise=False).block_invariant


def test_vectorized_vib_matches_scan():
    """The port's vectorised vibrato/xorshift chain against its per-sample
    one, from a phase that resets in the first block, over 12 blocks."""
    ctx = kt.AudioCtx(SR, 64, torch.float32)
    g = kt.Galactic(seed=5)
    st = g.init(ctx)
    st["vib_m"] = torch.tensor(6.28)
    drift = torch.full((64,), 0.0007)
    resets = 0
    for blk in range(12):
        a = g._vib_fpd_scan(ctx, st, drift)
        b = g._vib_fpd_vectorized(ctx, st, drift)
        for i, (x, y) in enumerate(zip(a, b)):
            if x.dtype == torch.int64:
                assert torch.equal(x, y), (blk, i)
            else:
                tol = OFFSET_TOL if i == 0 else 2e-5
                torch.testing.assert_close(x, y, rtol=0, atol=tol, msg=f"blk{blk} out{i}")
        resets += int(a[4] != st["oldfpd"])
        st = {**st, "vib_m": a[3], "oldfpd": a[4], "fpd": i32_of(a[5])}
    assert resets >= 1


@pytest.mark.parametrize("blockwise", [True, False], ids=["blockwise", "per_sample"])
def test_galactic_process_matches_jax(blockwise):
    B, blocks = 64, 24
    ju, tu = JGalactic(seed=9, blockwise=blockwise), kt.Galactic(seed=9, blockwise=blockwise)
    jctx, tctx = jk.AudioCtx(SR, B, np.float32), kt.AudioCtx(SR, B, torch.float32)
    rng = np.random.default_rng(0)
    params = {k: np.full(B, v, np.float32) for k, v in PARAMS.items()}
    with jax.enable_x64(False):
        js = ju.init(jctx)
        ts = tu.init(tctx)
        fn = jax.jit(lambda s, x: ju.process(jctx, s, x, {k: jnp.asarray(v) for k, v in
                                                         params.items()})[:2],
                     compiler_options=NO_FMA)
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        worst = 0.0
        for blk in range(blocks):
            x = rng.normal(0.0, 0.3, (2, B)).astype(np.float32)
            js, jo = fn(js, jnp.asarray(x))
            ts, to = tu.process(tctx, ts, torch.from_numpy(x), tp)
            worst = max(worst, float(np.abs(to.numpy() - np.asarray(jo)).max()))
            back = graph_state_to_numpy(ts, like=jax.tree_util.tree_map(np.asarray, js))
            for k in ("fpd", "dpos", "vib_pos"):
                np.testing.assert_array_equal(back[k], np.asarray(js[k]), err_msg=k)
            for k in ("dbuf", "feedback", "iir_a", "iir_b", "vib_m", "oldfpd"):
                np.testing.assert_allclose(back[k], np.asarray(js[k]), rtol=0,
                                           atol=STATE_TOL, err_msg=f"{k} block {blk}")
    assert worst <= TOL, worst
    assert np.abs(np.asarray(jo)).max() > 0.05


def galactic_chain(m, gg):
    """benchmarks/suite.py:475-498."""
    src = gg.push(m.PinkNoise(seed=4))
    echo = gg.push(m.AllpassFeedbackDelay(0.25, feedback=0.5, long=True, min_delay_time=0.25))
    verb = gg.push((m.Galactic if m is kt else JGalactic)(wet=0.5, seed=6))
    src.to(echo)
    echo.out([0, 0]).to(verb)
    verb.to_graph_out()


def test_galactic_chain_matches_jax(monkeypatch):
    """The graph through both renderers (the JAX one at x64 off): the
    same program sequence, the samples within TOL."""
    seqs, audio = {}, {}
    with jax.enable_x64(False):
        for m in (jk, kt):
            kw = {} if m is jk else {"device": "cpu"}
            g, proc = m.AudioProcessor.new(0, 2, m.AudioProcessorOptions(block_size=64), **kw)
            g.edit(lambda gg: galactic_chain(m, gg))
            seqs[m] = spy_programs(monkeypatch, m, proc)
            audio[m] = np.asarray(proc.render(frames=4800))
            if m is kt:
                assert proc.compiled.superblock_max == 740
    assert seqs[kt] == seqs[jk]
    assert any(p == "super" for p, _ in seqs[kt])
    np.testing.assert_allclose(audio[kt], audio[jk], rtol=0, atol=TOL)
    assert np.abs(audio[kt]).max() > 1e-2
