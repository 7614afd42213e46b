"""Golden ``fdn_galactic`` (tests/golden_configs.py:172-184) through the
port, and a JAX render's state carried into the port mid-render.

- The examples/fdn_reverb.py wiring, rebuilt with the port's graph API (a
  WhiteNoise(seed=17) burst under an EnvAr, four long AllpassDelays at
  prime loop lengths, OnePoleLpf damping, a Hadamard feedback mix over
  feedback edges, Galactic on the stereo taps), rendered 1 s at f32 and
  f64 on the CPU and held to the golden gate 1e-6 + 2^-23 against the
  fixtures (read with the port's codec). Measured 6.7e-8 (f32) and
  6.0e-8 (f64): the allpass interpolators' and Galactic's affine scans in
  the port's Hillis-Steele association stay far inside the gate, so no
  second association is needed. Galactic takes its seed from the global
  counter, reset first, as golden_configs.render does.
- ``convert.graph_state_from_jax`` takes the JAX package's state of the
  same graph after 40 blocks (u32 noise seeds and frames and Galactic's
  fpd, int32 write positions, f32 rings, the feedback buffers) leaf for
  leaf; the port then continues the render within ``TOL`` = 1e-6 of the
  JAX render (f32, XLA's default CPU options: measured 7.5e-9).
"""

import os

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.compile as jC
import knaster_tpu_torch as kt
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from knaster_tpu_torch.utils.codec import read_flac
from knaster_tpu_torch.convert import graph_state_from_jax, graph_state_to_numpy

SR = 48000
TOL = 1e-6
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_GATE = 1e-6 + 2.0**-23
PRIMES = (1031, 1327, 1523, 1871)
HADAMARD = ((1, 1, 1, 1), (1, -1, 1, -1), (1, 1, -1, -1), (1, -1, -1, 1))


def build_fdn(m, g, block_size):
    """examples/fdn_reverb.py:37-85 with either package's UGens; returns
    the burst's restart trigger."""
    galactic = kt.Galactic if m is kt else jk.Galactic
    env = g.push(m.EnvAr(0.004, 0.05))
    burst = g.push(m.WhiteNoise(seed=17)) * env * 0.8
    delays, damped = [], []
    for n in PRIMES:
        d = g.push(m.AllpassDelay(
            m.Seconds.from_samples(2 * n, SR), long=True,
            min_delay_time=m.Seconds.from_samples(min(PRIMES) - block_size, SR)))
        d.param("delay_time").set(m.Seconds.from_samples(n - block_size, SR).to_secs_f64())
        burst.to(d)
        lp = g.push(m.OnePoleLpf(5200.0))
        d.to(lp)
        delays.append(d)
        damped.append(lp)
    for i in range(4):
        mix = None
        for j in range(4):
            term = damped[j] * (0.85 * 0.5 * HADAMARD[i][j])
            mix = term if mix is None else mix + term
        mix.to_feedback(delays[i])
    gal = g.push(galactic(replace=0.25, brightness=0.6, bigness=0.7, wet=0.35))
    ((damped[0] + damped[2]) * 0.35 | (damped[1] + damped[3]) * 0.35).to(gal)
    gal.to_graph_out()
    return env.param("t_restart")


def fdn_processor(m, dtype):
    """golden_configs.render_fdn_galactic's processor, the burst fired,
    the seed counter reset first."""
    opts = m.AudioProcessorOptions(block_size=64, sample_rate=SR)
    if m is kt:
        kt.reset_randomness_seeds()
        g, proc = kt.AudioProcessor.new(0, 2, opts, dtype=dtype, device="cpu")
    else:
        from knaster_tpu.ugens.noise import reset_randomness_seeds

        reset_randomness_seeds()
        jC.clear_program_cache()
        g, proc = jk.AudioProcessor.new(0, 2, opts, dtype=dtype)
    g.edit(lambda gg: build_fdn(m, gg, 64)).trig()
    return proc


@pytest.mark.parametrize("dtype,name", [(torch.float32, "f32"), (torch.float64, "f64")])
def test_fdn_galactic_meets_golden(dtype, name):
    proc = fdn_processor(kt, dtype)
    audio = proc.render(seconds=1.0)
    ref, sr = read_flac(os.path.join(GOLDEN_DIR, f"fdn_galactic_{name}.flac"))
    assert sr == SR and ref.shape == audio.shape
    assert audio.dtype == (np.float32 if name == "f32" else np.float64)
    assert float(np.abs(audio.astype(np.float32) - ref).max()) <= GOLDEN_GATE
    assert np.abs(ref).max() > 0.05
    cg = proc.compiled
    assert cg.fb_sources and not kt.graph.compile.superblock_eligible(cg)
    assert not any(kind == "chain" for kind, _ in cg.plan)


def test_fdn_state_carries_from_jax():
    """40 blocks in the JAX package, the state carried across, 40 more
    blocks in both."""
    with jax.enable_x64(False):
        pj = fdn_processor(jk, np.float32)
        pj.render(frames=40 * 64)
        jax_state = jax.tree_util.tree_map(np.asarray, pj.state)
        pt = fdn_processor(kt, torch.float32)
        pt._ensure_compiled()
        assert [k for k, _ in pt.compiled.plan] == [k for k, _ in pj.compiled.plan]
        pt.state = graph_state_from_jax(jax_state, "cpu")
        pt.graph.clock.frames = pj.graph.clock.frames
        pt.graph.event_queue.clear()  # the trigger and sets were spent in JAX
        back = graph_state_to_numpy(pt.state, like=jax_state)
        flat_a = jax.tree_util.tree_leaves(jax_state)
        flat_b = jax.tree_util.tree_leaves(back)
        assert len(flat_a) == len(flat_b)
        assert {x.dtype for x in flat_a} >= {np.dtype(np.uint32), np.dtype(np.int32),
                                             np.dtype(np.float32)}
        for x, y in zip(flat_a, flat_b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(y, x)
        a = np.asarray(pj.render(frames=40 * 64))
    b = pt.render(frames=40 * 64)
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    assert np.abs(b).max() > 1e-3
