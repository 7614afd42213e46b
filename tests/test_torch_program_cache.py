"""The port's program and plan caches against the JAX package's.

Every case of tests/test_program_cache.py and tests/test_convolver.py's
IR-swap case, ported: each runs one script of graph edits three times,
through the JAX package, through the port, and through the port with both
caches cleared before every compile (``fresh``). Each run records whether
each compile was a program-cache hit. Asserted for every case:

* the port's hit/miss sequence equals the JAX package's (the fresh run's
  compiles are all misses);
* every render and carried node state of the port is bit-equal to the fresh
  run's: a hit renders what a compile from nothing renders;
* and within 1e-6 of the JAX package's (f32, absolute; integer and u32
  state exactly).

Then each case's own assertions from the JAX test, on the port, and the
async path on the CPU: a hit taken in the compile worker renders as a
synchronous fresh compile does.
"""

import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.compile as jC
import knaster_tpu.graph.processor as jP
import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.compile as tC
import knaster_tpu_torch.graph.processor as tP
from knaster_tpu.core.ugen import UGen as JUGen
from knaster_tpu_torch.core.ugen import UGen as TUGen

SR = 48000
TOL = 1e-6  # f32 renders and float state, port against the JAX package


@pytest.fixture(autouse=True)
def _fresh_caches():
    jC.clear_program_cache()
    tC.clear_program_cache()
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


def _C(m):
    return jC if m is jk else tC


def _new(m, outputs=1, block_size=16, **opts):
    kw = {} if m is jk else {"device": "cpu"}
    return m.AudioProcessor.new(0, outputs, m.AudioProcessorOptions(
        block_size=block_size, sample_rate=SR, **opts), **kw)


class JCounting(JUGen):
    """A constant that counts how many times its process is traced."""

    inputs, outputs, params = 0, 1, ()

    def __init__(self, value=1.0):
        self.value = float(value)

    def init(self, ctx):
        import jax.numpy as jnp

        return {"z": jnp.zeros((), ctx.dtype)}

    def process(self, ctx, state, inputs, params):
        import jax.numpy as jnp

        return state, jnp.full((1, ctx.block_size), self.value, ctx.dtype)


class TCounting(TUGen):
    """The port's counterpart: a constant with one state leaf."""

    inputs, outputs, params = 0, 1, ()

    def __init__(self, value=1.0):
        self.value = float(value)

    def init(self, ctx, device="cpu"):
        return {"z": torch.zeros((), dtype=ctx.dtype, device=device)}

    def process(self, ctx, state, inputs, params):
        return state, torch.full((1, ctx.block_size), self.value, dtype=ctx.dtype)


def _states(proc, handles):
    """{index: {leaf: array}} of the handles' node states."""
    out = {}
    for i, h in enumerate(handles):
        st = proc.compiled._extract_node_state(proc.state, h.node_id)
        out[i] = {k: np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                  for k, v in st.items()}
    return out


def _flat(res, prefix=""):
    if isinstance(res, dict):
        return {k2: v2 for k, v in res.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.array(res)}


def _close(port, ref, tol):
    """Port against the JAX package: u32 state (int32 bit patterns in the
    port) and integers exactly, floats within ``tol``."""
    if ref.dtype == np.uint32 and port.dtype == np.int32:
        port = port.view(np.uint32)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(port.astype(np.int64), ref.astype(np.int64))
    else:
        np.testing.assert_allclose(port, ref, rtol=0, atol=tol)


def three_ways(monkeypatch, script, tol=TOL):
    """Run ``script(m) -> (results, extra)`` through the JAX package, the
    port and the port with fresh compiles; assert the module docstring's
    three claims. Returns {side: (results, hit log, extra)}."""
    runs = {}
    for side in ("jax", "port", "fresh"):
        m = jk if side == "jax" else kt
        P, C = (jP, jC) if m is jk else (tP, tC)
        log = []

        def spy(*a, _orig=P.compile_graph, _log=log, _fresh=side == "fresh", _C=C, **k):
            if _fresh:
                _C.clear_program_cache()
            cg = _orig(*a, **k)
            _log.append(bool(cg.cache_hit))
            return cg

        C.clear_program_cache()
        with monkeypatch.context() as mp:
            mp.setattr(P, "compile_graph", spy)
            res, extra = script(m)
        runs[side] = (_flat(res), log, extra)
    (jres, jlog, _), (pres, plog, _), (fres, flog, _) = (runs[s] for s in ("jax", "port",
                                                                            "fresh"))
    assert plog == jlog, (plog, jlog)
    assert len(flog) == len(plog) and not any(flog)
    assert set(pres) == set(fres) == set(jres)
    for k in pres:
        np.testing.assert_array_equal(pres[k], fres[k], err_msg=k)  # bit-equal
        _close(pres[k], jres[k], tol)
    return runs


# --------------------------------------------------- tests/test_program_cache.py
def _push_voice(m, g):
    s = g.push(m.SinWt(440.0))
    e = g.push(m.EnvAsr(0.01, 0.05))
    mu = g.push(m.MathUGen("mul", 1))
    c = g.push((JCounting if m is jk else TCounting)(0.5))
    g.connect(s, 0, 0, mu)
    g.connect(e, 0, 1, mu)
    g.connect(mu, 0, 0, "graph")
    g.connect(c, 0, 0, "graph")
    return [s, e, mu, c]


def test_push_free_push_identical_does_not_retrace(monkeypatch):
    """tests/test_program_cache.py:55. The re-pushed voice is a hit that
    takes the first compile's renderers without building any, and its fresh
    nodes start from fresh state."""
    builds = []
    build_render = tC._build_render
    monkeypatch.setattr(tC, "_build_render",
                        lambda *a, **k: (builds.append(1), build_render(*a, **k))[1])

    def script(m):
        g, proc = _new(m)
        nodes = g.edit(lambda gg: _push_voice(m, gg))
        nodes[1].param("t_restart").trig()  # an eventful block: the full renderer
        proc.run_without_inputs()
        proc.run_without_inputs()  # event-free: the fast one
        b0 = proc.output_block().copy()
        cg1, n_builds = proc.compiled, len(builds)

        def cycle(gg):
            for h in nodes:
                gg.free_node(h)
            return _push_voice(m, gg)

        nodes[:] = g.edit(cycle)
        nodes[1].param("t_restart").trig()  # both renderers after the commit
        proc.run_without_inputs()
        a1 = proc.output_block().copy()
        proc.run_without_inputs()
        a2 = proc.output_block().copy()
        return ({"b0": b0, "a1": a1, "a2": a2, "state": _states(proc, nodes)},
                (cg1, proc.compiled, len(builds) - n_builds))

    runs = three_ways(monkeypatch, script)
    cg1, cg2, new_builds = runs["port"][2]
    assert cg2.cache_hit
    assert cg2.render is cg1.render and cg2.render_fast is cg1.render_fast
    assert new_builds == 0  # no renderer built across the structural commit
    res = runs["port"][0]
    np.testing.assert_allclose(res["/a2"], res["/b0"], atol=1e-7)


def test_cache_miss_on_different_config(monkeypatch):
    """tests/test_program_cache.py:88: another trace config misses."""
    def script(m):
        g, proc = _new(m)
        s = g.edit(lambda gg: gg.push(m.SinWt(440.0)))
        g.edit(lambda gg: gg.connect(s, 0, 0, "graph"))
        proc.run_without_inputs()
        cg1 = proc.compiled

        def edit(gg):
            gg.free_node(s)
            s2 = gg.push(m.SinWt(440.0, lookup=True))
            gg.connect(s2, 0, 0, "graph")

        g.edit(edit)
        proc.run_without_inputs()
        return {"out": proc.output_block().copy()}, (cg1, proc.compiled)

    runs = three_ways(monkeypatch, script)
    cg1, cg2 = runs["port"][2]
    assert not cg2.cache_hit and cg2.render is not cg1.render


def _keep_tmp(m, gg):
    keep = gg.push(m.SinWt(330.0))
    tmp = gg.push(m.SinWt(440.0))
    gg.connect(keep, 0, 0, "graph")
    gg.connect(tmp, 0, 0, "graph")
    return keep, tmp


def test_surviving_node_state_carries_across_cache_hit(monkeypatch):
    """tests/test_program_cache.py:110: after a hit the surviving sine
    continues its phase and the re-pushed one restarts."""
    def script(m):
        g, proc = _new(m)
        keep, tmp = g.edit(lambda gg: _keep_tmp(m, gg))
        proc.run_without_inputs()
        proc.run_without_inputs()

        def cycle(gg):
            gg.free_node(tmp)
            t = gg.push(m.SinWt(440.0))
            gg.connect(t, 0, 0, "graph")
            return t

        t = g.edit(cycle)
        proc.run_without_inputs()
        out = proc.output_block()[0].copy()
        hit = proc.compiled.cache_hit
        # the reference: each sine alone, 3 blocks of the kept, 1 of the new
        ref = np.zeros_like(out)
        for freq, n in ((330.0, 3), (440.0, 1)):
            g2, p2 = _new(m)
            g2.edit(lambda gg: gg.connect(gg.push(m.SinWt(freq)), 0, 0, "graph"))
            for _ in range(n):
                p2.run_without_inputs()
            ref = ref + p2.output_block()[0]
        return {"out": out, "state": _states(proc, [keep, t])}, (hit, ref)

    runs = three_ways(monkeypatch, script)
    for side in ("jax", "port"):
        hit, ref = runs[side][2]
        assert hit, side
        np.testing.assert_allclose(runs[side][0]["/out"], ref, atol=1e-6)


def test_two_processors_share_programs(monkeypatch):
    """tests/test_program_cache.py:181: a second processor of the same
    graph takes the first one's renderers and renders the same samples."""
    def script(m):
        g1, p1 = _new(m)
        g2, p2 = _new(m)
        for g in (g1, g2):
            g.edit(lambda gg: gg.connect(gg.push(m.SinWt(220.0)), 0, 0, "graph"))
        p1.run_without_inputs()
        p2.run_without_inputs()
        return ({"a": p1.output_block().copy(), "b": p2.output_block().copy()},
                (p1.compiled, p2.compiled))

    runs = three_ways(monkeypatch, script)
    c1, c2 = runs["port"][2]
    assert c2.render is c1.render
    np.testing.assert_array_equal(runs["port"][0]["/a"], runs["port"][0]["/b"])


def test_carry_keyed_by_correspondence_not_just_prev_signature(monkeypatch):
    """tests/test_program_cache.py:197: two same-signature commits that pair
    surviving node ids with different positions carry each node's own state
    (the fresh run is the JAX test's uncached run)."""
    def script(m):
        g, proc = _new(m)

        def one(gg):
            h = gg.push(m.SinWt(440.0))
            h.to_graph_out()
            return h

        hs = g.edit(lambda gg: [one(gg) for _ in range(2)])
        hs[0].param("freq").set(100.0)
        hs[1].param("freq").set(900.0)
        a = proc.render(frames=256)
        g.edit(lambda gg: hs[1].free())  # free B, push C
        hC = g.edit(one)
        hC.param("freq").set(500.0)
        b = proc.render(frames=256)
        g.edit(lambda gg: hs[0].free())  # same signatures, another correspondence
        hD = g.edit(one)
        c = proc.render(frames=512)
        return {"a": a, "b": b, "c": c, "state": _states(proc, [hC, hD])}, None

    three_ways(monkeypatch, script)


def test_carry_from_single_slot_into_batch(monkeypatch):
    """tests/test_program_cache.py:233: a node that moves from a 'single'
    plan slot into a batch keeps its state."""
    def script(m):
        g, proc = _new(m)

        def build(gg):
            src = gg.push(m.SinWt(220.0))
            f1 = gg.push(m.OnePoleLpf(500.0))
            f2 = gg.push(m.OnePoleLpf(500.0))
            f3 = gg.push(m.OnePoleLpf(500.0))
            src.to(f1)
            src.to(f2)
            f1.to(f3)  # depth 2: planned as a 'single'
            f3.to_graph_out()
            f2.to_graph_out()
            return src, f1, f3

        src, f1, f3 = g.edit(build)
        a = proc.render(frames=512)
        before = _states(proc, [f3])
        g.edit(lambda gg: src.to_replace(f3))  # f3 joins the depth-1 batch
        proc._ensure_compiled()
        after = _states(proc, [f3])
        b = proc.render(frames=64)
        return {"a": a, "b": b, "before": before, "after": after}, None

    runs = three_ways(monkeypatch, script)
    for side in ("jax", "port"):
        res = runs[side][0]
        assert abs(float(res["/before/0/last"])) > 1e-6
        for k in res:
            if k.startswith("/before"):
                np.testing.assert_array_equal(res[k], res[k.replace("before", "after")])


def _zc(audio, n):
    ch = np.asarray(audio)[0][-n:]
    return int(np.sum((ch[:-1] < 0) & (ch[1:] >= 0)))


def test_cache_hit_uses_new_push_defaults(monkeypatch):
    """tests/test_program_cache.py:265: a re-push at a new default freq is a
    hit and plays the new default."""
    def script(m):
        C = _C(m)
        g, proc = _new(m)

        def push(freq):
            def build(gg):
                s = gg.push(m.SinWt(freq))
                (s * 0.1).to_graph_out()
                return s
            return g.edit(build)

        h = push(440.0)
        a = proc.render(seconds=0.2)
        n1 = len(C._PROGRAM_CACHE)
        g.edit(lambda gg: gg.free_node(h))
        proc.render(frames=32)
        push(523.25)
        b = proc.render(seconds=0.2)
        return {"a": a, "b": b}, (n1, len(C._PROGRAM_CACHE))

    runs = three_ways(monkeypatch, script)
    for side in ("jax", "port"):
        res, _, (n1, n2) = runs[side]
        assert abs(_zc(res["/a"], 9600) - 88) <= 2
        assert abs(_zc(res["/b"], 4800) - 52) <= 3, side
        assert n2 == n1 + 1, side  # the interim topology only


def test_cache_hit_uses_new_bank_voice_defaults(monkeypatch):
    """tests/test_program_cache.py:304: a bank re-pushed with another
    voice_defaults table is a hit and plays the new table."""
    def script(m):
        C = _C(m)
        g, proc = _new(m, outputs=2)

        def push(freq):
            def build(gg):
                b = gg.push(m.VoiceBank(m.SineVoice(amp=0.1, attack=0.0), 4,
                                        voice_defaults={"freq": np.full(4, freq, np.float32)}))
                b.to_graph_out()
                return b
            return g.edit(build)

        b = push(440.0)
        b.voice_param("t_restart").trig(0)
        a = proc.render(seconds=0.2)
        n1 = len(C._PROGRAM_CACHE)
        g.edit(lambda gg: gg.free_node(b))
        proc.render(frames=32)
        b2 = push(660.0)
        b2.voice_param("t_restart").trig(0)
        c = proc.render(seconds=0.2)
        return {"a": a, "c": c}, (n1, len(C._PROGRAM_CACHE))

    runs = three_ways(monkeypatch, script)
    for side in ("jax", "port"):
        res, _, (n1, n2) = runs[side]
        assert abs(_zc(res["/a"], 4800) / 0.1 - 440) < 15
        assert abs(_zc(res["/c"], 4800) / 0.1 - 660) < 20, side
        assert n2 == n1 + 1, side


def test_cache_hit_on_different_wavetable_content(monkeypatch):
    """tests/test_program_cache.py:344: OscWt re-pushed with another table
    is a hit and the new table renders."""
    def script(m):
        C = _C(m)
        g, proc = _new(m)

        def push(wt):
            def build(gg):
                o = gg.push(m.OscWt(wt, 440.0))
                (o * 0.5).to_graph_out()
                return o
            return g.edit(build)

        h = push(m.Wavetable.sine())
        a = proc.render(seconds=0.05)
        n1 = len(C._PROGRAM_CACHE)
        g.edit(lambda gg: gg.free_node(h))
        proc.render(frames=32)
        push(m.Wavetable.saw())
        b = proc.render(seconds=0.05)
        return {"a": a, "b": b}, (n1, len(C._PROGRAM_CACHE))

    runs = three_ways(monkeypatch, script)
    res, _, (n1, n2) = runs["port"]
    assert n2 == n1 + 1
    t = np.arange(res["/a"].shape[1]) / SR

    def sine_resid(x):
        ph = 2 * np.pi * 440.0 * t
        basis = np.stack([np.sin(ph), np.cos(ph)])
        coef, *_ = np.linalg.lstsq(basis.T, x, rcond=None)
        return float(np.sqrt(np.mean((x - basis.T @ coef) ** 2)))

    assert sine_resid(res["/a"][0]) < 0.01
    assert sine_resid(res["/b"][0]) > 0.05, "re-push still playing the old table"


# ------------------------------------------------------- tests/test_convolver.py
def test_live_ir_swap_is_cache_hit(monkeypatch):
    """tests/test_convolver.py:212: two Convolvers with different IRs of one
    length share a signature; the second compile is a hit and renders its
    own IR."""
    rng = np.random.default_rng(6)
    h1 = rng.standard_normal(200).astype(np.float32) * 0.1
    h2 = rng.standard_normal(200).astype(np.float32) * 0.1

    def script(m):
        sigs, res = [], {}
        for name, h in (("h1", h1), ("h2", h2)):
            g, proc = _new(m, block_size=64)

            def b(gg, h=h):
                n = gg.push(m.WhiteNoise(seed=9))
                cv = gg.push(m.Convolver(h))
                n.to(cv)
                cv.to_graph_out()

            g.edit(b)
            proc._ensure_compiled()
            sigs.append(proc.compiled.signature)
            res[name] = proc.render(frames=64 * 6)
        return res, sigs

    runs = three_ways(monkeypatch, script)
    for side in ("jax", "port"):
        s1, s2 = runs[side][2]
        assert s1 is not None and s1 == s2, side
    assert runs["port"][1] == [False, True]


# ----------------------------------------------------------------- the port
def test_async_hit_renders_as_a_sync_compile(monkeypatch):
    """An edit that returns the graph to an earlier topology is a hit in
    the compile worker; the renderer it swaps in renders what a synchronous
    compile from nothing renders."""
    from tests.test_torch_live_programs import warm

    outs, hits = [], []
    for async_ in (True, False):
        tC.clear_program_cache()
        g, proc = _new(kt, render_chunk_blocks=4)
        hs = g.edit(lambda gg: [gg.push(kt.SinWt(220.0 + 30 * i)) for i in range(2)])
        g.edit(lambda gg: [(h * 0.2).to_graph_out() for h in hs])
        warm(proc)
        first = proc.render(frames=3 * 16)
        for step in ("push", "free"):
            if step == "push":
                extra = g.edit(lambda gg: gg.push(kt.SinWt(440.0)))
                g.edit(lambda gg: (extra * 0.2).to_graph_out())
            else:
                g.edit(lambda gg: gg.free_node(extra))
            if async_:
                proc.enable_async_recompile()
                proc._kick_async_compile()
                proc._compile_thread.join(timeout=60)
                proc._kick_async_compile()  # the swap
            else:
                tC.clear_program_cache()
                proc._ensure_compiled()
                warm(proc)
            first = np.concatenate([first, proc.render(frames=8 * 16)], axis=1)
        outs.append(first)
        hits.append([c["hit"] for c in proc.compiles])
    assert hits[0][-1] and not any(hits[1])  # the free returns to the first shape
    np.testing.assert_array_equal(outs[0], outs[1])


def test_uncacheable_graph_compiles_fresh():
    """A UGen holding a tensor freezes to None: its graph has no signature
    and every compile builds its renderers anew."""
    g, proc = _new(kt)
    c = kt.Constant(0.5)
    c.table = torch.zeros(4)
    h = g.edit(lambda gg: gg.push(c))
    g.edit(lambda gg: h.to_graph_out())
    proc.render(frames=32)
    first = proc.compiled
    g.edit(lambda gg: gg.push(kt.Constant(0.1)).to_graph_out())
    proc.render(frames=32)
    assert first.signature is None and proc.compiled.signature is None
    assert not proc.compiled.cache_hit and proc.compiled.cache_entry is None
    assert not tC._PROGRAM_CACHE and not tC._PLAN_CACHE


def test_clear_and_cap():
    """``clear_program_cache`` empties both caches; the program cache keeps
    its 64 most recent entries, the plan cache its 256."""
    g, proc = _new(kt)
    hs = []
    for i in range(tC._PROGRAM_CACHE_CAP + 3):
        hs.append(g.edit(lambda gg: gg.push(kt.Constant(0.01))))
        g.edit(lambda gg: hs[-1].to_graph_out())
        proc._ensure_compiled()
    assert len(tC._PROGRAM_CACHE) == tC._PROGRAM_CACHE_CAP
    assert len(tC._PLAN_CACHE) == tC._PROGRAM_CACHE_CAP + 3
    tC.clear_program_cache()
    assert not tC._PROGRAM_CACHE and not tC._PLAN_CACHE
