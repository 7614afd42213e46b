"""The port's ``core/dsp.py`` against the JAX package's ``core/dsp.py``.

The port keeps one association of the affine scans, the JAX package's
Hillis-Steele "lanes" doubling, so against those variants (jitted at
``xla_backend_optimization_level`` 0: no fused multiply-add) the scans are
bit-equal; against a sequential f64 recurrence they are within 1e-5 on
contracting maps. The polynomial sine and tan are bit-equal at f32; tan at
f64 is ``torch.tan`` against ``jnp.tan`` (1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knaster_tpu.core import dsp as jdsp
from knaster_tpu_torch.core import dsp

NO_FMA = {"xla_backend_optimization_level": 0}


def _rows(seed, B, lo, hi, n=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, (1, B)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("B", [1, 7, 64, 1000])
def test_affine_scan_1d_matches_jax_lanes_and_loop(B):
    a, b = _rows(B, B, 0.5, 0.999, 1)[0], _rows(B + 1, B, -1.0, 1.0, 1)[0]
    s0 = np.float32(0.3)
    jp, jf = jax.jit(jdsp.affine_scan_1d_lanes, compiler_options=NO_FMA)(
        a, b, jnp.full((1, 1), s0))
    tp, tf = dsp.affine_scan_1d(torch.from_numpy(a), torch.from_numpy(b),
                                torch.tensor([s0]))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf)[:, 0])
    s, ref = np.float64(s0), []
    for t in range(B):
        ref.append(s)
        s = a[0, t] * s + b[0, t]
    np.testing.assert_allclose(tp.numpy()[0], ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.numpy()[0], s, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B", [1, 5, 64, 1024])
def test_affine_scan_2x2_matches_jax_lanes_and_loop(B):
    """The SVF's shape: a rotation-like contracting map plus a drive."""
    rng = np.random.default_rng(B)
    th = rng.uniform(0.0, 0.3, (1, B)).astype(np.float32)
    r = rng.uniform(0.9, 0.99, (1, B)).astype(np.float32)
    m = [r * np.cos(th), -r * np.sin(th), r * np.sin(th), r * np.cos(th)]
    c = [rng.uniform(-0.1, 0.1, (1, B)).astype(np.float32) for _ in range(2)]
    m = [x.astype(np.float32) for x in m]
    s0 = (np.float32(0.2), np.float32(-0.4))
    j = jax.jit(jdsp.affine_scan_2x2_rows_lanes, compiler_options=NO_FMA)(
        *m, *c, jnp.full((1, 1), s0[0]), jnp.full((1, 1), s0[1]))
    t = dsp.affine_scan_2x2_rows(*(torch.from_numpy(x) for x in m + c),
                                 torch.tensor([s0[0]]), torch.tensor([s0[1]]))
    for k in range(2):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        np.testing.assert_array_equal(t[2 + k].numpy(), np.asarray(j[2 + k])[:, 0])
    # the packed form computes the same
    M = torch.from_numpy(np.stack([np.stack(m[:2], -1), np.stack(m[2:], -1)], -2)[0])
    pre, fin = dsp.affine_scan_2d(M, torch.from_numpy(np.stack(c, -1)[0]),
                                  torch.tensor(s0))
    np.testing.assert_array_equal(pre[:, 0].numpy(), t[0].numpy()[0])
    np.testing.assert_array_equal(fin.numpy(), [t[2].item(), t[3].item()])
    s = np.array(s0, np.float64)
    for i in range(B):
        mm = np.array([[m[0][0, i], m[1][0, i]], [m[2][0, i], m[3][0, i]]], np.float64)
        s = mm @ s + np.array([c[0][0, i], c[1][0, i]])
    np.testing.assert_allclose(fin.numpy(), s, rtol=0, atol=1e-5)


def test_cumsum_matches_jax_lanes():
    from knaster_tpu.ugens.envelopes import _csum_lanes

    x = _rows(3, 64, 0.0, 0.05)[0]
    j = jax.jit(lambda v: _csum_lanes(v, 64), compiler_options=NO_FMA)(x)
    np.testing.assert_array_equal(dsp.cumsum(torch.from_numpy(x)).numpy(), np.asarray(j))
    np.testing.assert_array_equal(dsp.shift1(torch.from_numpy(x)).numpy()[0, 1:], x[0, :-1])


def test_sine_and_tan_polynomials_match_jax():
    u = np.linspace(-np.pi / 2, np.pi / 2, 4097, dtype=np.float32)
    x = np.linspace(0.0, 1.5707, 4097, dtype=np.float32)
    js = jax.jit(jdsp.sin_poly_quadrant, compiler_options=NO_FMA)(u)
    jt = jax.jit(jdsp.tan_first_quadrant, compiler_options=NO_FMA)(x)
    np.testing.assert_array_equal(dsp.sin_poly_quadrant(torch.from_numpy(u)).numpy(),
                                  np.asarray(js))
    np.testing.assert_array_equal(dsp.tan_first_quadrant(torch.from_numpy(x)).numpy(),
                                  np.asarray(jt))
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(dsp.tan_first_quadrant(torch.from_numpy(x64)).numpy(),
                               np.tan(x64), rtol=1e-12)
