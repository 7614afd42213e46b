"""The port's graph (edit, compile, render) against the JAX package on the same graphs.

Each scenario is written once over a module (``knaster_tpu`` or
``knaster_tpu_torch``) and run through both; the outputs are compared:

- the exact-value cases of tests/test_graph_basic.py (routing, additive
  inputs, multichannel math and a live re-edit, feedback, disconnection,
  operator sugar), a subgraph, ``set_at`` at an exact sample, triggers and
  integer params: equal;
- linear smoothing (audio and block rate), checked to land exactly on its
  target: within 1e-6 mid-ramp, where XLA's CPU backend contracts the
  param engine's ``anchor + step * progress`` into one fused multiply-add
  that the port rounds twice, and equal once the ramp has landed;
- sines, which take ``sin`` from XLA's CPU library in one and torch's in
  the other (they differ by an ulp at some table indices): within 1e-6.

``readme_sine`` at f32 and f64 meets its golden fixtures (read with the
JAX package's codec) at the golden gate, 1e-6 + 2^-23. ``convert`` carries a
JAX compiled graph's state (batched groups and chain stacks included) into
the port, which then renders on exactly as the JAX graph does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu.utils.codec import read_flac
from knaster_tpu_torch.convert import graph_state_from_jax, graph_state_to_numpy
from tests.utils import TestInPlusParamUGen as JaxInPlusParam
from tests.utils import TestNumUGen as JaxNum

SR = 48000
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_GATE = 1e-6 + 2.0**-23


class PortNum(kt.UGen):
    """tests/utils.py TestNumUGen in the port: a static number every frame."""

    __test__ = False
    inputs, outputs, params = 0, 1, ()

    def __init__(self, n: float):
        self.n = float(n)

    def process(self, ctx, state, inputs, params):
        return state, torch.full((1, ctx.block_size), self.n, dtype=ctx.dtype)


class PortInPlusParam(kt.UGen):
    """tests/utils.py TestInPlusParamUGen in the port: input + param."""

    __test__ = False
    inputs, outputs = 1, 1
    params = (kt.pfloat("number", 0.0),)

    def process(self, ctx, state, inputs, params):
        return state, (inputs[0] + params["number"])[None, :]


class JaxProbe(jk.UGen):
    """Its trigger and integer params as two output rows."""

    __test__ = False
    inputs, outputs = 0, 2
    params = (jk.ptrigger("t"), jk.pinteger("sel", 0))

    def process(self, ctx, state, inputs, params):
        return state, jnp.stack([params["t"].astype(ctx.dtype),
                                 params["sel"].astype(ctx.dtype)])


class PortProbe(kt.UGen):
    """JaxProbe in the port."""

    __test__ = False
    inputs, outputs = 0, 2
    params = (kt.ptrigger("t"), kt.pinteger("sel", 0))

    def process(self, ctx, state, inputs, params):
        return state, torch.stack([params["t"].to(ctx.dtype),
                                   params["sel"].to(ctx.dtype)])


SIDES = {
    "jax": (jk, JaxNum, JaxInPlusParam),
    "port": (kt, PortNum, PortInPlusParam),
}
PROBES = {jk: JaxProbe, kt: PortProbe}


def _proc(m, ins, outs, block_size=16, dtype=None):
    return m.AudioProcessor.new(ins, outs, m.AudioProcessorOptions(
        block_size=block_size, sample_rate=SR), dtype=dtype)


def _blocks(proc, n, inputs=None):
    out = []
    for _ in range(n):
        proc.run(inputs)
        out.append(np.asarray(proc.output_block()).copy())
    return np.concatenate(out, axis=1)


# --------------------------------------------------------------------------
# scenarios: each takes (module, Num, InPlusParam) and returns samples
# --------------------------------------------------------------------------

def routing(m, Num, Plus):
    """test_graph_basic: inputs to outputs, through nodes, additively."""
    g, proc = _proc(m, 3, 3)

    def build(g):
        g.from_inputs([0, 0]).to_graph_out_channels([1, 2])
        g0, g1 = g.push(Plus()), g.push(Plus())
        g0.param("number").set(0.75)
        g1.param("number").set(0.5)
        g0.to_graph_out_channels(2)
        g.from_inputs(2).to(g1).to_graph_out_channels(0)

    g.edit(build)
    return _blocks(proc, 2, np.full((3, 16), 2.0, np.float32))


def multichannel_reedit(m, Num, Plus):
    """test_graph_basic: stacked 2-channel math, then a live re-edit."""
    g, proc = _proc(m, 3, 2)

    def build(g):
        v = [g.push(Num(x)) for x in (0.125, 1.0, 0.5, 4.125)]
        mm = g.push(m.MathUGen("add", 2))
        (v[0] | v[1] | v[2] | v[3]).to(mm).to_graph_out()
        return v[0].id(), v[2].id(), mm.id()

    v00, v10, mid = g.edit(build)
    a = _blocks(proc, 1, np.ones((3, 16), np.float32))

    def reedit(g):
        m2, m3 = g.push(m.MathUGen("mul", 1)), g.push(m.MathUGen("mul", 1))
        (g.handle(mid).out([0]) | g.handle(v10)).to(m2)
        (g.handle(mid).out([1]) | g.handle(v00)).to(m3)
        (m2 | m3).to_graph_out_replace()

    g.edit(reedit)
    return np.concatenate([a, _blocks(proc, 1, np.ones((3, 16), np.float32))], axis=1)


def feedback(m, Num, Plus):
    """test_graph_basic feedback_nodes and feedback_nodes2: one-block delay."""
    g, proc = _proc(m, 0, 2)

    def build(g):
        n0, n1 = g.push(Plus()), g.push(Plus())
        n0.param(0).set(1.25)
        n1.param(0).set(0.125)
        n0.to(n1).to_feedback(n0)
        n1.to_graph_out_channels(0)
        n2, n3 = g.push(Plus()), g.push(Plus())
        n2.param(0).set(1.25)
        n3.param(0).set(0.125)
        n2.to_feedback(n3).to_graph_out_channels(1)

    g.edit(build)
    return _blocks(proc, 3)


def disconnect(m, Num, Plus):
    """test_graph_basic test_disconnect."""
    g, proc = _proc(m, 0, 1)

    def build(g):
        ns = [g.push(Plus()) for _ in range(3)]
        for n, v in zip(ns, (0.5, 1.25, 0.125)):
            n.param(0).set(v)
        ns[0].to(ns[1])
        ns[1].to(ns[2])
        ns[2].to_graph_out()
        return ns[0], ns[2]

    n1, n3 = g.edit(build)
    out = [_blocks(proc, 1)]
    g.disconnect_output_from_source(n1, 0)
    g.commit()
    out.append(_blocks(proc, 1))
    g.disconnect_input_to_sink(0, n3)
    g.commit()
    out.append(_blocks(proc, 1))
    return np.concatenate(out, axis=1)


def sugar(m, Num, Plus):
    """test_graph_basic operator sugar: n * 0.5 + 1.0 and (a * b) - 1.0,
    plus the reversed and division forms."""
    g, proc = _proc(m, 0, 4)

    def build(g):
        n = g.push(Num(2.5))
        (n * 0.5 + 1.0).to_graph_out_channels(0)
        a, b = g.push(Num(3.0)), g.push(Num(2.0))
        ((a * b) - 1.0).to_graph_out_channels(1)
        (1.0 - a / b).to_graph_out_channels(2)
        (3.0 / b).to_graph_out_channels(3)

    g.edit(build)
    return _blocks(proc, 1)


def subgraph(m, Num, Plus):
    """tests/test_subgraph.py: a child graph with an input, nested twice."""
    g, proc = _proc(m, 0, 2)

    def build(g):
        child, ch = g.subgraph(inputs=1, outputs=1, name="inner")
        n = child.push(Plus())
        n.param(0).set(0.5)
        child.from_inputs(0).to(n)
        n.to_graph_out()
        src = g.push(Num(2.0))
        src.to(ch)
        ch.to_graph_out_channels(0)
        mid, mh = g.subgraph(inputs=0, outputs=1, name="mid")
        deep, dh = mid.subgraph(inputs=0, outputs=1, name="deep")
        deep.push(Num(0.25)).to_graph_out()
        scale = mid.push(Plus())
        scale.param(0).set(1.0)
        dh.to(scale)
        scale.to_graph_out()
        mh.to_graph_out_channels(1)

    g.edit(build)
    return _blocks(proc, 1)


def set_at(m, Num, Plus):
    """tests/test_scheduling.py sample_accurate_parameters: sets at exact
    frames, one of them in the third block."""
    g, proc = _proc(m, 0, 1)

    def build(g):
        n = g.push(Plus())
        n.to_graph_out()
        return n.param(0)

    p = g.edit(build)
    for frame, val in ((5, 5.0), (6, 6.0), (8, 8.0), (9, 9.0), (10, 10.0), (37, -1.5)):
        p.set_at(val, m.Seconds.from_samples(frame, SR))
    return _blocks(proc, 3)


def triggers_and_ints(m, Num, Plus):
    """tests/test_scheduling.py trigger and integer cases: triggers at
    exact frames, an int param stepping mid-block and persisting, an event
    already in the past applying at the next block's start."""
    g, proc = _proc(m, 0, 2)

    def build(g):
        n = g.push(PROBES[m]())
        n.to_graph_out()
        return n.param("t"), n.param("sel")

    t, sel = g.edit(build)
    for f in (7, 11, 40):
        t.trig_at(m.Seconds.from_samples(f, SR))
    sel.set_at(3, m.Seconds.from_samples(5, SR))
    sel.set_at(9, m.Seconds.from_samples(30, SR))
    out = [_blocks(proc, 3)]
    sel.set_at(4, m.Seconds.from_samples(3, SR))  # in the past: applies asap
    out.append(_blocks(proc, 1))
    return np.concatenate(out, axis=1)


EXACT = [routing, multichannel_reedit, feedback, disconnect, sugar, subgraph, set_at,
         triggers_and_ints]


@pytest.mark.parametrize("scenario", EXACT, ids=lambda f: f.__name__)
def test_exact_values_match_jax(scenario):
    a = scenario(*SIDES["jax"])
    b = scenario(*SIDES["port"])
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_array_equal(b, a)


def test_exact_values_spot_checks():
    """The reference's expected samples hold in the port on its own."""
    out = routing(*SIDES["port"])
    assert (out[0, 0], out[1, 0], out[2, 0]) == (2.5, 2.0, 2.75)
    fb = feedback(*SIDES["port"])
    assert [fb[0, 16 * k] for k in range(3)] == [1.375, 2.75, 4.125]
    assert [fb[1, 16 * k] for k in range(3)] == [0.125, 1.375, 1.375]
    sa = set_at(*SIDES["port"])[0]
    assert list(sa[:16]) == [0, 0, 0, 0, 0, 5, 6, 6, 8, 9, 10, 10, 10, 10, 10, 10]
    assert sa[36] == 10.0 and sa[37] == -1.5
    tr, sel = triggers_and_ints(*SIDES["port"])
    assert list(np.flatnonzero(tr)) == [7, 11, 40]
    assert (sel[:5] == 0).all() and (sel[5:30] == 3).all() and (sel[30:48] == 9).all()
    assert (sel[48:] == 4).all()


def test_cycles_and_freed_nodes_raise():
    g = kt.Graph(0, 1, SR, 16)
    a, b = g.push(PortInPlusParam()), g.push(PortInPlusParam())
    a.to(b)
    with pytest.raises(kt.CircularConnection):
        b.to(a)
    b.to_feedback(a)  # feedback is allowed
    g.free_node(a)
    with pytest.raises(kt.NodeFreed):
        a.param(0).set(1.0)


def smoothing(m, Num, Plus, rate):
    """A linear ramp 0 -> 1 over 50 samples from frame 7, then one back to
    0.25 over 40 samples set mid-ramp (frame 30), at audio or block rate."""
    g, proc = _proc(m, 0, 1)

    def build(g):
        n = g.push(Plus())
        n.to_graph_out()
        return n.param(0)

    p = g.edit(build)
    p.smooth(m.Smoothing.linear(50.0 / SR, rate))
    p.set_at(1.0, m.Seconds.from_samples(7, SR))
    p.smooth_at(m.Smoothing.linear(40.0 / SR, rate), m.Seconds.from_samples(30, SR))
    p.set_at(0.25, m.Seconds.from_samples(30, SR))
    return _blocks(proc, 8)


@pytest.mark.parametrize("rate", ["audio", "block"])
def test_linear_smoothing_lands_exactly(rate):
    a = smoothing(*SIDES["jax"], rate)
    b = smoothing(*SIDES["port"], rate)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert b[0, 0] == 0.0 and b[0, -1] == np.float32(0.25)
    np.testing.assert_array_equal(b[:, 80:], a[:, 80:])  # landed: exact
    assert len(np.unique(b[0, 30:70])) > 2  # it ramped


def sines(m, Num, Plus):
    """A sine through phase resets, a param set, a smoothed freq change and
    a structural re-edit that must keep its phase (tests/test_graph_basic.py
    test_state_survives_reedit), beside 12 auto-batched sines, one of which
    resets its phase too."""
    g, proc = _proc(m, 0, 2, block_size=64)

    def build(g):
        s = g.push(m.SinWt(440.0))
        s.to_graph_out_channels(0)
        rng = np.random.default_rng(1)
        batch = [g.push(m.SinWt(float(rng.uniform(100, 1000)))) for _ in range(12)]
        for b in batch:
            (b * 0.05).to_graph_out_channels(1)
        return s, batch[5]

    s, member = g.edit(build)
    s.param("reset_phase").trig_at(m.Seconds.from_samples(37, SR))
    member.param("reset_phase").trig_at(m.Seconds.from_samples(70, SR))
    a = proc.render(frames=100)
    s.param("freq").set_at(660.0, m.Seconds.from_samples(130, SR))
    s.param("freq").smooth_at(m.Smoothing.linear(0.002), m.Seconds.from_samples(200, SR))
    s.param("freq").set_at(220.0, m.Seconds.from_samples(201, SR))
    b = proc.render(frames=156)
    g.edit(lambda g: g.push(Num(0.0)).to_graph_out_channels(1))
    c = proc.render(frames=256)
    return np.concatenate([a, b, c], axis=1)


def test_sines_with_events_and_reedit_match_jax():
    a = np.asarray(sines(*SIDES["jax"]))
    b = sines(*SIDES["port"])
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    # the re-edit kept the phase: the sine continues, it does not restart
    assert abs(b[0, 256]) > 1e-3


@pytest.mark.parametrize("name, dtype", [("f32", torch.float32), ("f64", torch.float64)])
def test_readme_sine_meets_golden(name, dtype):
    """tests/golden_configs.py render_readme_sine through the port."""
    g, proc = _proc(kt, 0, 2, block_size=64, dtype=dtype)

    def build(gg):
        sine = gg.push(kt.SinWt(440.0))
        amp = gg.push(kt.Constant(0.2))
        (sine * amp).out([0, 0]).to_graph_out()

    g.edit(build)
    audio = proc.render(seconds=0.5)
    assert audio.dtype == (np.float32 if name == "f32" else np.float64)
    ref, sr = read_flac(os.path.join(GOLDEN_DIR, f"readme_sine_{name}.flac"))
    assert sr == SR and ref.shape == audio.shape
    assert float(np.abs(audio.astype(np.float32) - ref).max()) <= GOLDEN_GATE
    assert np.abs(ref).max() > 0.19


def convert_graph(m):
    """12 auto-batched sines (a batch group) and a 10-stage FM cascade (a
    chain stack), B = 16."""
    g, proc = _proc(m, 0, 1)

    def build(gg):
        rng = np.random.default_rng(2)
        for _ in range(12):
            (gg.push(m.SinWt(float(rng.uniform(100, 1000)))) * 0.01).to_graph_out()
        prev = None
        for i in range(10):
            s = gg.push(m.SinWt(100.0 + i))
            if prev is not None:
                mod = (prev * 100.0) + 200.0
                gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
            prev = s
        (prev * 0.1).to_graph_out()

    g.edit(build)
    return proc


def test_convert_carries_compiled_graph_state():
    pj, pt = convert_graph(jk), convert_graph(kt)
    pj.render(frames=160)
    pt._ensure_compiled()
    plan = [k for k, _ in pt.compiled.plan]
    assert "batch" in plan and "chain" in plan
    assert plan == [k for k, _ in pj.compiled.plan]
    jax_state = jax.tree_util.tree_map(np.asarray, pj.state)
    pt.state = graph_state_from_jax(jax_state, "cpu")
    pt.graph.clock.frames = pj.graph.clock.frames
    back = graph_state_to_numpy(pt.state, like=jax_state)
    flat_a = jax.tree_util.tree_leaves(jax_state)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(y, x)
    a = np.asarray(pj.render(frames=160))
    b = pt.render(frames=160)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert np.abs(b).max() > 1e-3
