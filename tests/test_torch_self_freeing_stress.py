"""Port of tests/test_self_freeing_stress.py: the self-freeing voice stress.

A control loop keeps pushing enveloped subgraph voices whose EnvAsr carries
Done.FREE_PARENT and triggers the previous voice's release each cycle
(knaster_graph/examples/self_freeing_stress_test.rs:25-105). The audio
stays finite through every cycle, the graph returns to its baseline node
count once every envelope has released, and the program cache serves the
recurring topologies instead of growing an entry per cycle. The same
script with both caches cleared before every compile renders the same
samples bit for bit.
"""

import numpy as np

import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.compile as C
import knaster_tpu_torch.graph.processor as P


def stress(fresh, monkeypatch):
    """The stress script; returns (audio, processor, graph, baseline)."""
    C.clear_program_cache()
    if fresh:
        compile_graph = P.compile_graph
        monkeypatch.setattr(P, "compile_graph", lambda *a, **k: (
            C.clear_program_cache(), compile_graph(*a, **k))[1])
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                    device="cpu")
    baseline = len(g.nodes)
    state = {"release": None}
    outs = []
    for i in range(10):

        def build(gg, i=i):
            if state["release"] is not None:
                state["release"].trig()
            child, ch = gg.subgraph(inputs=0, outputs=1, name=f"voice{i}")
            osc = child.push(kt.SinNumeric(50.0 * (i + 1)))
            asr = child.push_with_done_action(kt.EnvAsr(0.001, 0.002), kt.Done.FREE_PARENT)
            asr.param("t_restart").trig()
            (osc * asr * 0.05).to_graph_out()
            ch.to_graph_out()
            state["release"] = asr.param("t_release")

        g.edit(build)
        out = np.asarray(proc.render(frames=64))
        assert np.all(np.isfinite(out)), f"non-finite audio in cycle {i}"
        outs.append(out)
    # release the last voice and drain: release = 0.002 s = 96 samples
    state["release"].trig()
    outs.append(np.asarray(proc.render(frames=960)))
    assert np.all(np.isfinite(outs[-1]))
    for _ in range(8):  # frees apply at block boundaries after done flags
        if len(g.nodes) == baseline:
            break
        outs.append(np.asarray(proc.render(frames=64)))
    return np.concatenate(outs, axis=1), proc, g, baseline


def test_self_freeing_voice_stress(monkeypatch):
    audio, proc, g, baseline = stress(False, monkeypatch)
    assert len(g.nodes) == baseline, (
        f"{len(g.nodes) - baseline} nodes leaked after all voices released")
    # the push/free cycle revisits a bounded set of topologies: the cache
    # must not have one entry per cycle
    assert len(C._PROGRAM_CACHE) < 10
    assert any(c["hit"] for c in proc.compiles)
    tail = np.asarray(proc.render(frames=64))
    assert np.all(np.isfinite(tail)) and np.abs(tail).max() == 0.0
    fresh, *_ = stress(True, monkeypatch)
    np.testing.assert_array_equal(audio, fresh)
