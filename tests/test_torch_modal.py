"""The port's ``ModalResonator`` against a numpy closed form and the JAX package.

Ports of tests/test_modal.py:54-135: a single mode equals the closed form
``r^n sin(n theta)``, several modes are the sum of single ones, a mode
above Nyquist is silent, the render is continuous across block sizes, the
T60 lands at -60 dB, every preset rings (one parametrised test), and an
audio-rate freq ramp stays finite and continuous. The impulse enters
through a graph input (the JAX tests read it with a BufferReader, which the
port does not have yet); each render is also held against the JAX
package's render of the same graph.

Tolerances: the JAX tests' bounds against the closed form (2e-5 single,
1e-4 several modes) and between partitions (2e-5). Against the JAX render,
the peak times (1e-6 + n * DRIFT) over n samples: the port scans the modes
with its one Hillis-Steele association (``core/dsp.affine_scan_2x2_rows``),
the JAX package with ``lax.associative_scan``'s tree, XLA's fused
multiply-adds and its folding of ``(2pi/sr) * (freq * ratio)`` into ``freq
* (2pi/sr * ratio)``, and its f32 exp/cos/sin are XLA's where the port
rounds float64 ones, so the two rings drift apart in phase by a few ulps a
sample: measured at most 2.1e-8 of the peak per sample (a single mode over
1024 samples), the bound takes more than twice that. The JAX package bounds its own
two executors' drift from an f64 truth by 1e-5 + n * 3e-7
(tests/test_generic_bank.py:459).
"""

import numpy as np
import pytest

import knaster_tpu as jk
from knaster_tpu.ugens.modal import ModalResonator as JModal

import knaster_tpu_torch as kt

SR = 48000
DRIFT = 5e-8  # of the peak, per sample


def _np_impulse_response(n, freq, decay, ratios, gains, decays, x0=1.0, sr=SR):
    """y[n] = x0 * sum_m g_m r_m^n sin(n theta_m); modes above Nyquist are
    silent."""
    t = np.arange(n, dtype=np.float64)
    y = np.zeros(n, np.float64)
    for rat, g, rel in zip(ratios, gains, decays):
        theta = 2.0 * np.pi * freq * rat / sr
        if theta >= np.pi:
            continue
        r = 10.0 ** (-3.0 / max(decay * rel * sr, 1e-4))
        y += g * (r ** t) * np.sin(t * theta)
    return (x0 * y).astype(np.float32)


def _render(m, make, n, block=64, schedule=None):
    """An impulse through graph input 0 into ``make(m)``'s resonator."""
    kw = {} if m is jk else {"device": "cpu"}
    g, proc = m.AudioProcessor.new(1, 1, m.AudioProcessorOptions(block_size=block,
                                                                 sample_rate=SR), **kw)
    x = np.zeros((1, max(n, block)), np.float32)
    x[0, 0] = 1.0

    def build(gg):
        r = gg.push(make(m))
        gg.from_inputs(0).to(r)
        r.to_graph_out()
        return r

    h = g.edit(build)
    if schedule is not None:
        schedule(h)
    return np.asarray(proc.render(frames=n, inputs=x))[0]


def _cls(m):
    return JModal if m is jk else kt.ModalResonator


def _port_and_jax(make, n, block=64, schedule=None):
    a = _render(jk, make, n, block, schedule)
    b = _render(kt, make, n, block, schedule)
    bound = np.abs(a).max() * (1e-6 + n * DRIFT)
    np.testing.assert_allclose(b, a, rtol=0, atol=bound)
    return b


def test_single_mode_matches_closed_form():
    got = _port_and_jax(lambda m: _cls(m)(freq=440.0, decay=0.5, ratios=(1.0,)), 1024)
    want = _np_impulse_response(1024, 440.0, 0.5, (1.0,), (1.0,), (1.0,))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_multi_mode_is_sum_of_single_modes():
    ratios, gains, decays = (1.0, 2.7, 5.4), (1.0, 0.5, 0.25), (1.0, 0.6, 0.3)
    got = _port_and_jax(lambda m: _cls(m)(freq=220.0, decay=0.4, ratios=ratios,
                                          gains=gains, decays=decays), 768)
    want = _np_impulse_response(768, 220.0, 0.4, ratios, gains, decays)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_mode_above_nyquist_is_silent():
    got = _port_and_jax(lambda m: _cls(m)(freq=200.0, decay=0.3, ratios=(1.0, 150.0)), 512)
    want = _render(kt, lambda m: _cls(m)(freq=200.0, decay=0.3, ratios=(1.0,)), 512)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_block_partition_continuity():
    a = _port_and_jax(lambda m: _cls(m).bell(330.0, decay=1.0), 512, block=32)
    b = _render(kt, lambda m: _cls(m).bell(330.0, decay=1.0), 512, block=128)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_t60_calibration():
    """After ``decay`` seconds a single mode is down 60 dB."""
    decay = 0.25
    n60 = int(decay * SR)
    y = _render(kt, lambda m: _cls(m)(freq=100.0, decay=decay, ratios=(1.0,)), n60 + 512)
    early = np.abs(y[:512]).max()
    late = np.abs(y[n60:n60 + 512]).max()
    assert early > 0.5
    np.testing.assert_allclose(late / early, 1e-3, rtol=0.25)


@pytest.mark.parametrize("preset", ["bell", "bar", "string", "membrane"])
def test_presets_ring(preset):
    y = _port_and_jax(lambda m: getattr(_cls(m), preset)(220.0), 2048)
    assert np.isfinite(y).all()
    assert np.abs(y).max() > 1e-3
    assert np.abs(y[1024:]).max() > 1e-4  # it rings well past the strike


def test_audio_rate_freq_is_finite_and_continuous():
    """A freq ramp across blocks: per-sample coefficients, state carried
    through the ramp."""
    def ramp(h):
        h.param("freq").smooth(0.02)
        h.param("freq").set(900.0)

    y = _port_and_jax(lambda m: _cls(m)(freq=300.0, decay=1.0, ratios=(1.0,)), 4096,
                      schedule=ramp)
    assert np.isfinite(y).all()
    assert np.abs(np.diff(y)).max() < 0.5


def test_ring_energy_and_batched_process():
    """``ring_energy`` is the gain-weighted RMS of the state; ``process``
    takes leading batch axes, each row as its own resonator."""
    import torch

    res = kt.ModalResonator.bell(330.0)
    ctx = kt.AudioCtx(SR, 64)
    st = {"s0": torch.full((3, res.n_modes), 0.1), "s1": torch.full((3, res.n_modes), -0.2)}
    g = torch.from_numpy(res.gains)
    want = torch.sqrt(torch.sum((g * 0.1) ** 2 + (g * 0.2) ** 2))
    assert torch.allclose(res.ring_energy(st), want.expand(3))
    x = torch.zeros((3, 1, 64))
    x[:, 0, 0] = torch.tensor([1.0, 0.5, 0.0])
    params = {"freq": torch.full((3, 64), 330.0), "decay": torch.full((3, 64), 4.0)}
    zero = {"s0": torch.zeros((3, res.n_modes)), "s1": torch.zeros((3, res.n_modes))}
    _, y = res.process(ctx, zero, x, params)
    one = res.process(ctx, {k: v[0] for k, v in zero.items()}, x[0],
                      {k: v[0] for k, v in params.items()})[1]
    assert y.shape == (3, 1, 64)
    torch.testing.assert_close(y[0], one, rtol=0, atol=0)
    torch.testing.assert_close(y[1], 0.5 * one, rtol=0, atol=1e-7)
    assert float(y[2].abs().max()) == 0.0
