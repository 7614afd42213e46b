"""Inspection, dot export, probes, log rings and checkpoints in the port.

Ports of tests/test_inspection_logging.py (``inspect``, ``to_dot``,
``probe_log``, ``rt_log``, the ArLog ring semantics, ``node_handles``,
``collect_probes`` in one device-to-host copy) and of
tests/test_decorator_checkpoint.py::test_checkpoint_resume, each against
the JAX package where both produce data: the same inspection and dot text
for the same graph, probe captures within 1e-6, a resumed render within
1e-6 of the JAX package's (at f32; the port's own resume bit-equal).
"""

import numpy as np
import torch

import knaster_tpu as jk
from knaster_tpu.graph.inspection import inspect as j_inspect
from knaster_tpu.graph.inspection import to_dot as j_to_dot

import knaster_tpu_torch as kt
from knaster_tpu_torch.graph.inspection import show_dot_svg

SR = 48000


def _proc(m, outputs=2, block_size=16):
    kw = {} if m is jk else {"device": "cpu"}
    return m.AudioProcessor.new(0, outputs, m.AudioProcessorOptions(
        block_size=block_size, sample_rate=SR), **kw)


def _patch(m):
    g, proc = _proc(m)

    def build(gg):
        s = gg.push(m.SinWt(440.0), name="sine")
        a = gg.push(m.Constant(0.5), name="amp")
        sig = s * a
        sig.out([0, 0]).to_graph_out()
        probe = gg.push(m.LogProbe("mix", samples_between_logs=8), name="probe")
        sig.to(probe)

    g.edit(build)
    return g, proc


def test_inspect_structure_matches_jax():
    g, _ = _patch(kt)
    gi = kt.inspect(g)
    names = {n.name for n in gi.nodes}
    assert {"sine", "amp", "probe"} <= names
    assert any(n.auto for n in gi.nodes)  # operator sugar made a Math node
    kinds = {e.kind for e in gi.edges}
    assert "graph_out" in kinds and "node" in kinds
    assert gi.frame_clock == 0
    sine = next(n for n in gi.nodes if n.name == "sine")
    assert ("freq", "float") in [(n, t) for n, t, _ in sine.params]
    jg, _ = _patch(jk)
    ji = j_inspect(jg)

    def shape(x):
        return ([(n.nid - x.nodes[0].nid, n.name, n.type_name, n.inputs, n.outputs,
                  [(p, t) for p, t, _ in n.params], n.done_action, n.mortal, n.auto)
                 for n in x.nodes],
                sorted((e.kind, e.src_ch, e.dst_ch) for e in x.edges))

    assert shape(gi) == shape(ji)


def test_dot_export_matches_jax():
    g, _ = _patch(kt)
    dot = kt.to_dot(g)
    assert dot.startswith("digraph")
    assert "sine" in dot and "gout" in dot
    jg, _ = _patch(jk)
    assert len(dot.splitlines()) == len(j_to_dot(jg).splitlines())

    def fb(m):
        def build(gg):
            a = gg.push(m.OnePoleLpf(500.0))
            b = gg.push(m.OnePoleLpf(900.0))
            a.to(b)
            b.to_feedback(a)
            b.to_graph_out()
        return build

    g.edit(fb(kt))
    assert "color=red" in kt.to_dot(g)


def test_show_dot_svg(tmp_path, monkeypatch):
    """Without Graphviz's ``dot`` both packages return None and write
    nothing (examples/visualize_graph.py tests the result with ``if svg``)."""
    import shutil

    from knaster_tpu.graph.inspection import show_dot_svg as j_show_dot_svg

    monkeypatch.setattr(shutil, "which", lambda name: None)
    for m, show in ((jk, j_show_dot_svg), (kt, show_dot_svg)):
        g, _ = _patch(m)
        path = tmp_path / f"{m.__name__}.svg"
        assert show(g, str(path)) is None
        assert not path.exists()


def test_probe_log_drain_matches_jax():
    caps = {}
    for m in (jk, kt):
        g, proc = _patch(m)
        proc.run_without_inputs()
        first = proc.probe_log()
        proc.render(frames=16 * 7 + 3)
        caps[m] = first + proc.probe_log()
    for c in caps.values():
        assert [p.name for p in c] == ["mix", "mix"] and all(p.fired for p in c)
        assert all(np.isfinite(p.value) for p in c)
    for a, b in zip(caps[jk], caps[kt]):
        assert abs(a.value - b.value) <= 1e-6 and a.fired == b.fired


def test_rt_log_prints(capfd):
    from knaster_tpu_torch.core.log import rt_log

    rt_log("peak {p}", p=torch.tensor([1.0, -3.0]).abs().max())
    out = capfd.readouterr()
    assert "peak 3.0" in out.out


def test_arlog_ring_semantics():
    """Typed chains, capacity backpressure (a full ring DROPS the chain),
    complete-chain-only delivery, tensor parts read at the drain
    (log.rs:118-271); the same chains and drops as the JAX package's."""
    results = []
    for m in (jk, kt):
        rec = m.ArLogReceiver()
        logger = rec.sender(capacity=8)
        assert rec.channels() == 1
        got = []
        m.rt_log(logger, "peak ", 0.5, 3)
        assert rec.recv(got.append) == 1
        for _ in range(10):
            m.rt_log(logger, "x", 1.0)  # 3 slots each with END; 2 fit in 8
        drained = rec.recv(got.append)
        logger.send("partial")
        assert rec.recv(got.append) == 0
        m.rt_log(logger)  # a bare End terminates the partial chain
        assert rec.recv(got.append) == 1
        results.append((got, logger.dropped, drained))
    assert results[0] == results[1]
    assert results[1][1] == 8 and results[1][2] == 2

    rec = kt.ArLogReceiver()
    logger = rec.sender(capacity=8)
    x = torch.tensor([1.0, -3.0])
    kt.rt_log(logger, "peak ", x.abs().max(), x)
    x.zero_()  # the chain holds its own copy
    got = []
    rec.recv(got.append)
    assert got[0][0] == "peak " and got[0][1] == 3.0
    np.testing.assert_array_equal(got[0][2], [1.0, -3.0])


def test_node_handles_from_inspection():
    """inspection.rs:49: live handles rebuilt from an inspection; auto
    sugar nodes are left out."""
    g, proc = _proc(kt, outputs=1)

    def build(gg):
        s = gg.push(kt.SinWt(440.0))
        (s * 0.1).to_graph_out()
        return s

    s = g.edit(build)
    gi = kt.inspect(g)
    hs = kt.node_handles(g, gi)
    assert s.node_id in hs
    assert all(nid not in hs for nid in (n.nid for n in gi.nodes if n.auto))
    hs[s.node_id].param("freq").set(220.0)
    proc.render(frames=64)
    zc = proc.render(frames=48000)[0]
    assert abs(np.sum((zc[:-1] < 0) & (zc[1:] >= 0)) - 220.0) < 4


def test_collect_probes_single_fetch(monkeypatch):
    """Five probes come back in ONE device-to-host copy."""
    g, proc = _proc(kt, outputs=1)

    def build(gg):
        for i in range(5):
            s = gg.push(kt.SinWt(100.0 * (i + 1)))
            s.to(gg.push(kt.LogProbe(f"p{i}")))
            (s * 0.01).to_graph_out()

    g.edit(build)
    proc.render(frames=64)
    calls = []
    orig = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (calls.append(1), orig(self, *a, **k))[1])
    probes = proc.probe_log()
    assert [p.name for p in probes] == [f"p{i}" for i in range(5)]
    assert len(calls) == 1


def _resume(m, path, dtype=None):
    def make():
        kw = {} if m is jk else {"device": "cpu", "dtype": dtype}
        g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(
            block_size=16, sample_rate=SR), **kw)
        s = g.edit(lambda gg: gg.push(m.SinWt(997.0)))
        s.to_graph_out()
        g.commit()
        return s, proc

    s1, p1 = make()
    s1.param("freq").smooth(m.Smoothing.linear(0.003))
    a = p1.render(frames=481)  # not block-aligned: the remainder is saved too
    s1.param("freq").set(300.0)  # a ramp in flight at the checkpoint
    p1.render(frames=20)
    p1.save_state(path)
    continued = p1.render(frames=480)
    _, p2 = make()
    p2.load_state(path)
    restored = p2.render(frames=480)
    return np.asarray(a), np.asarray(continued), np.asarray(restored), p2


def test_checkpoint_resume_matches_jax(tmp_path):
    _, jc, jr, _ = _resume(jk, str(tmp_path / "j.pkl"))
    np.testing.assert_array_equal(jc, jr)
    for dtype in (torch.float32, torch.float64):
        _, c, r, p2 = _resume(kt, str(tmp_path / "t.pkl"), dtype)
        np.testing.assert_array_equal(c, r)
        assert p2.graph.clock.frames >= 480
        assert all(t.dtype == p2.compiled.ctx.dtype
                   for t in (p2.state["pe"]["value"],))
        if dtype == torch.float32:
            np.testing.assert_allclose(c, jc, rtol=0, atol=1e-6)


def test_checkpoint_best_effort_on_changed_structure(tmp_path):
    """A checkpoint of another topology restores its tree as saved."""
    g, proc = _proc(kt, outputs=1)
    g.edit(lambda gg: gg.push(kt.SinWt(440.0)).to_graph_out())
    proc.render(frames=64)
    proc.save_state(str(tmp_path / "a.pkl"))
    g2, p2 = _proc(kt, outputs=1)
    g2.edit(lambda gg: [gg.push(kt.SinWt(440.0)).to_graph_out() for _ in range(2)])
    p2.load_state(str(tmp_path / "a.pkl"))
    assert set(p2.state["nodes"]) == set(proc.state["nodes"])
    assert p2.graph.clock.frames == 64
