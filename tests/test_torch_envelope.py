"""The port's multi-segment ``Envelope`` in a graph against the JAX package's.

Ports of tests/test_ugens_env_filters.py:117 (segments, then the final
value held), :136 (every shape: sinusoidal, exponential, step), :171 (a
repeated jump to the same segment re-jumps: the retrigger int's set mask),
plus t_stop freezing a curved segment mid-flight, a looping program, a
per-sample ``time_scale`` ramp and the value-change fallback without a set
mask. Each renders the same graph through both packages on the CPU, block
by block (B = 16) and bounced, and holds the port to the JAX render and to
the JAX tests' expected values.

Tolerance: 1e-6 against the JAX render. The linear and step shapes are
exact; the sinusoidal and exponential shapes call cos, and exp/log through
pow, which XLA's CPU backend and torch evaluate with their own kernels (an
ulp or two apart at these magnitudes).
"""

import numpy as np
import pytest
import torch

import knaster_tpu as jk
from knaster_tpu.ugens.envelopes import Envelope as JEnvelope

import knaster_tpu_torch as kt
from knaster_tpu_torch.graph.compile import superblock_eligible

SR = 48000
B = 16
TOL = 1e-6


def _samples(m, n):
    return m.Seconds.from_samples(n, SR)


def _graph(m, start, segments, looping=False):
    kw = {} if m is jk else {"device": "cpu"}
    g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=B, sample_rate=SR),
                                   **kw)
    env_cls = JEnvelope if m is jk else kt.Envelope

    def build(gg):
        e = gg.push(env_cls(start, segments, looping=looping))
        e.to_graph_out()
        return e

    return g, proc, g.edit(build)


def _both(start, segments, schedule, blocks, looping=False, bounce=False):
    """Render both packages' graphs after ``schedule(m, handle)``: block by
    block with ``run`` (or ``render`` when ``bounce``); returns (jax, port)
    [blocks * B] outputs."""
    outs = []
    for m in (jk, kt):
        _, proc, h = _graph(m, start, segments, looping)
        schedule(m, h)
        if bounce:
            outs.append(np.asarray(proc.render(frames=blocks * B))[0])
            continue
        got = []
        for _ in range(blocks):
            proc.run_without_inputs()
            got.append(np.asarray(proc.output_block())[0])
        outs.append(np.concatenate(got))
    a, b = outs
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    return a, b


def _restart(m, h):
    h.param("t_restart").trig()


def test_envelope_segments_and_loop():
    _, out = _both(0.0, [(4 / SR, 1.0), (4 / SR, 0.5)], _restart, 2)
    np.testing.assert_allclose(out[:4], [0, 0.25, 0.5, 0.75], atol=1e-6)
    np.testing.assert_allclose(out[4:8], [1.0, 0.875, 0.75, 0.625], atol=1e-6)
    np.testing.assert_allclose(out[9:], 0.5, atol=1e-6)


def test_envelope_shapes():
    segs = [(4 / SR, 1.0, "sinusoidal"), (4 / SR, 0.5, "exponential"),
            (4 / SR, 0.25, "step")]
    _, out = _both(0.0, segs, _restart, 1)
    np.testing.assert_allclose(out[:4], [(1 - np.cos(np.pi * f / 4)) / 2 for f in range(4)],
                               atol=1e-6)
    assert out[4] == pytest.approx(1.0)
    np.testing.assert_allclose(out[5:8], [0.5 ** (f / 4) for f in (1, 2, 3)], rtol=1e-6)
    assert out[8] == pytest.approx(0.5)
    np.testing.assert_allclose(out[9:], 0.25, atol=1e-6)


def test_envelope_repeat_jump_reapplies():
    def jumps(m, h):
        jump = h.param("jump_to_segment")
        jump.set_at(0, _samples(m, 0))  # the default value: only the mask sees it
        jump.set_at(0, _samples(m, 4))  # a repeated set re-jumps

    _, out = _both(0.0, [(8 / SR, 1.0)], jumps, 1)
    np.testing.assert_allclose(out[:4], [0, 0.125, 0.25, 0.375], atol=1e-6)
    np.testing.assert_allclose(out[4:12], np.arange(8) / 8, atol=1e-6)
    assert out[12] == pytest.approx(1.0)
    np.testing.assert_allclose(out[13:], 1.0, atol=1e-6)


def test_envelope_t_stop_freezes_a_curved_segment():
    """t_stop mid-way through a sinusoidal segment holds the value it had
    there; a later restart runs the program again."""
    def stop(m, h):
        h.param("t_restart").trig()
        h.param("t_stop").trig_at(_samples(m, 5))
        h.param("t_restart").trig_at(_samples(m, 40))

    segs = [(8 / SR, 1.0, "sinusoidal"), (8 / SR, 0.2, "exponential")]
    _, out = _both(0.1, segs, stop, 4)
    frozen = 0.1 + 0.9 * (1 - np.cos(np.pi * 5 / 8)) / 2
    np.testing.assert_allclose(out[5:40], frozen, atol=1e-6)
    assert out[40] == pytest.approx(0.1)
    assert out[48] == pytest.approx(1.0)


@pytest.mark.parametrize("bounce", [False, True])
def test_envelope_looping_with_time_scale_ramp(bounce):
    """A looping program under a time_scale ramp, block by block and as a
    bounce (a looping envelope sets no done, so the bounce takes
    superblocks)."""
    def sched(m, h):
        h.param("t_restart").trig()
        ts = h.param("time_scale")
        ts.smooth(m.Smoothing.linear(0.004))
        ts.set_at(2.5, _samples(m, 20))

    segs = [(10 / SR, 1.0), (6 / SR, -0.5, "sinusoidal"), (7 / SR, 0.25, "step"),
            (9 / SR, 0.0)]
    a, b = _both(0.0, segs, sched, 24, looping=True, bounce=bounce)
    assert np.abs(b).max() > 0.9
    # the loop keeps cycling to the end
    assert np.ptp(b[-64:]) > 0.5


def test_envelope_value_change_fallback_without_a_set_mask():
    """Without ``jump_to_segment_set`` (a host with no set mask) a change
    of value jumps, as in the JAX package."""
    segs = [(4 / SR, 1.0), (4 / SR, 0.5), (4 / SR, -1.0)]
    jump = np.array([0] * 6 + [2] * 10, np.int32)
    restart = np.zeros(B, bool)
    restart[0] = True
    outs = []
    for m, env in ((jk, JEnvelope(0.0, segs)), (kt, kt.Envelope(0.0, segs))):
        ctx = m.AudioCtx(SR, B, np.float32 if m is jk else torch.float32)
        conv = np.asarray if m is jk else torch.from_numpy
        params = {"time_scale": conv(np.ones(B, np.float32)), "jump_to_segment": conv(jump),
                  "t_restart": conv(restart), "t_stop": conv(np.zeros(B, bool))}
        st = env.init(ctx)
        st, out, done = env.process(ctx, st, conv(np.zeros((0, B), np.float32)), params)
        outs.append((np.asarray(out)[0], np.asarray(done), int(st["seg"])))
    (a, da, sa), (b, db, sb) = outs
    np.testing.assert_allclose(b, a, atol=TOL)
    np.testing.assert_array_equal(db, da)
    assert sb == sa
    # the jump to segment 2 at sample 6 ramps from the value held there
    np.testing.assert_allclose(b[6:10], [1.0, 0.5, 0.0, -0.5], atol=1e-6)


def test_envelope_graph_takes_superblocks():
    """A non-looping envelope may set done; with no done action the graph
    still takes superblocks (the envelope is block-length invariant)."""
    _, proc, _ = _graph(kt, 0.0, [(4 / SR, 1.0)])
    proc._ensure_compiled()
    assert superblock_eligible(proc.compiled)
