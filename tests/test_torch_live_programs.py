"""The live path's programs in the port against the JAX package.

A stream warms programs that an offline bounce then takes
(``existing_only``): the eventful chunk (events in block 0 only), the
eventful superblock (events anywhere in a chunk), the loop of eventful
k-superblocks (a graph capped below the chunk), the float-event programs
(collapsed chains stay on the chain kernel while a batch holds no trigger)
and the whole-chunk full scan (a graph with feedback edges). Each case
warms the JAX processor and the port's the same way (``_warm_programs`` at
the same chunk, as ``StreamBackend`` does), renders one script of events,
records which program each side took (each side's ``get_*_fn`` wrapped at
run time) and compares the two renders. Tolerance: f32 within 1e-6 x
max(1, peak), f64 within 1e-9 x max(1, peak); the JAX graph is jitted at
XLA's default level (its CPU backend fuses multiply-adds; the bank test
holds the same bound as tests/test_torch_voice_pool.py).

Then the port alone: the eventful superblock equals m sequential full
blocks bit for bit (the JAX docstring's claim, at f32 and f64), and async
recompile: the published program is warmed, the swap carries state as the
synchronous path does, and a warm failure raises on the thread that swaps.
"""

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.chain_kernel as jck
import knaster_tpu.graph.compile as jC
import knaster_tpu.graph.processor as jP
import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.compile as tC
import knaster_tpu_torch.graph.chain_kernel as tck
import knaster_tpu_torch.graph.processor as tP
from knaster_tpu_torch.graph.compile import get_full_super_fn

SR = 48000
B = 16
CHUNK = 4


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    tC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    monkeypatch.setattr(jck, "_MODE", None)
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


def _proc(m, outputs=1, dtype=None, chunk=CHUNK):
    kw = {} if m is jk else {"device": "cpu"}
    return m.AudioProcessor.new(0, outputs, m.AudioProcessorOptions(
        block_size=B, sample_rate=SR, render_chunk_blocks=chunk), dtype=dtype, **kw)


def warm(proc, chunk=CHUNK):
    """What StreamBackend.start_processing warms, without the threads."""
    proc._ensure_compiled()
    lengths, sub = [], 2
    while sub <= chunk:
        lengths.append(sub)
        sub *= 2
    proc._warm_scan_lengths = tuple(lengths)
    proc._warm_chunk_len = chunk
    proc._warm_programs(proc.compiled, proc.state)


def record(monkeypatch, m, log):
    """Wrap each side's program getters: a program that is called appends
    its name to ``log``."""
    if m is jk:
        sites = [(jP, "get_evchunk_fn", "evchunk"), (jC, "get_float_evchunk_fn", "float_evchunk"),
                 (jC, "get_float_fn", "float"), (jP, "get_full_super_fn", "full_super"),
                 (jP, "get_full_super_scan_fn", "full_super_scan"),
                 (jP, "_get_full_scan_fn", "full_scan")]
    else:
        sites = [(tP, "get_evchunk_fn", "evchunk"), (tP, "get_float_evchunk_fn", "float_evchunk"),
                 (tP, "get_float_fn", "float"), (tP, "get_full_super_fn", "full_super"),
                 (tP, "get_full_super_scan_fn", "full_super_scan"),
                 (tP, "get_full_scan_fn", "full_scan")]
    for mod, attr, name in sites:
        orig = getattr(mod, attr)

        def getter(*a, _orig=orig, _name=name, **k):
            fn = _orig(*a, **k)
            if fn is None:
                return None

            def call(*x, **y):
                log.append(_name)
                return fn(*x, **y)

            return call

        monkeypatch.setattr(mod, attr, getter)


def _at(m, n):
    return m.Seconds.from_samples(n, SR)


def run_both(monkeypatch, scenario, dtype=None, chunk=CHUNK, outputs=1):
    """Render ``scenario`` on both sides, warmed alike; returns (JAX audio,
    port audio, JAX programs, port programs)."""
    out = {}
    f64 = dtype == torch.float64
    for m in (jk, kt):
        with jax.enable_x64(f64 and m is jk), monkeypatch.context() as mp:
            g, proc = _proc(m, outputs, dtype=dtype if m is kt else (
                np.float64 if f64 else None), chunk=chunk)
            script = scenario(m, g)
            warm(proc, chunk)
            log = []
            record(mp, m, log)
            audio = np.concatenate([np.asarray(step(proc)) for step in script], axis=1)
        out[m] = (audio, log)
    (a, la), (b, lb) = out[jk], out[kt]
    return a, b, la, lb


def assert_close(a, b, f64=False):
    peak = max(1.0, float(np.abs(a).max()))
    tol = (1e-9 if f64 else 1e-6) * peak
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def sines(m, g):
    def build(gg):
        hs = [gg.push(m.SinWt(220.0 + 30 * i)) for i in range(3)]
        for h in hs:
            (h * 0.2).to_graph_out()
        return hs

    return g.edit(build)


def block0_events(m, g):
    """asap batches: every event in block 0 of the chunk after it."""
    hs = sines(m, g)

    def step(events):
        def go(proc):
            events()
            return proc.render(frames=CHUNK * B)
        return go

    return [
        step(lambda: (hs[0].param("reset_phase").trig(), hs[1].param("freq").set(330.0))),
        step(lambda: None),
        step(lambda: hs[2].param("freq").set(97.0)),
    ]


def mid_chunk_events(m, g):
    """Sets and a trigger scheduled inside chunks."""
    hs = sines(m, g)
    hs[0].param("freq").smooth(m.Smoothing.linear(0.001))

    def go(proc):
        hs[0].param("freq").set_at(555.0, _at(m, 2 * B + 5))
        hs[1].param("reset_phase").trig_at(_at(m, 3 * B + 1))
        hs[2].param("freq").set_at(123.0, _at(m, 6 * B + 9))
        return proc.render(frames=3 * CHUNK * B)

    return [go]


def test_eventful_chunk_matches_jax(monkeypatch):
    a, b, la, lb = run_both(monkeypatch, block0_events)
    assert la == lb == ["evchunk", "evchunk"]
    assert_close(a, b)


def test_eventful_superblock_matches_jax(monkeypatch):
    a, b, la, lb = run_both(monkeypatch, mid_chunk_events)
    assert la == lb == ["full_super", "full_super"]
    assert_close(a, b)


def test_eventful_superblock_matches_jax_f64(monkeypatch):
    a, b, la, lb = run_both(monkeypatch, mid_chunk_events, dtype=torch.float64)
    assert la == lb == ["full_super", "full_super"]
    assert_close(a, b, f64=True)


def capped_bank(m, g):
    """A fused sine bank capped at 4 blocks (64 samples) under a chunk of 8:
    eventful chunks loop over eventful 4-block superblocks."""
    V = 128
    rng = np.random.default_rng(5)
    d = {"freq": rng.uniform(100, 2000, V).astype(np.float32),
         "amp": np.full(V, 0.01, np.float32),
         "pan": rng.uniform(-1, 1, V).astype(np.float32)}
    bank = (jk.PallasSineVoiceBank(V, voice_defaults=d, event_capacity=256, tile_rows=1)
            if m is jk else kt.FusedSineVoiceBank(V, voice_defaults=d, event_capacity=256))
    bank.superblock_cap = 4 * B
    h = g.edit(lambda gg: gg.push(bank))
    h.to_graph_out()
    g.commit()
    trig, freq = h.voice_param("t_restart"), h.voice_param("freq")

    def go(proc):
        for v in range(0, V, 3):
            trig.trig_at(v, _at(m, 5 + (v % 7) * 9))
        freq.set_at(4, 880.0, _at(m, 5 * B + 3))
        trig.trig_at(9, _at(m, 9 * B + 2))
        return proc.render(frames=16 * B)

    return [go]


def test_capped_superblock_scan_matches_jax(monkeypatch):
    a, b, la, lb = run_both(monkeypatch, capped_bank, chunk=8, outputs=2)
    assert la == lb == ["full_super_scan", "full_super_scan"]
    assert_close(a, b)


def capped_bank_block0(m, g):
    """``capped_bank``'s bank (the port's) under asap batches, each in
    block 0 of the chunk after it."""
    V = 128
    rng = np.random.default_rng(5)
    d = {"freq": rng.uniform(100, 2000, V).astype(np.float32),
         "amp": np.full(V, 0.01, np.float32),
         "pan": rng.uniform(-1, 1, V).astype(np.float32)}
    bank = m.FusedSineVoiceBank(V, voice_defaults=d, event_capacity=256)
    bank.superblock_cap = 4 * B
    h = g.edit(lambda gg: gg.push(bank))
    h.to_graph_out()
    g.commit()
    trig, freq = h.voice_param("t_restart"), h.voice_param("freq")

    def step(events):
        def go(proc):
            events()
            return proc.render(frames=8 * B)
        return go

    return [step(lambda: [trig.trig(v) for v in range(0, V, 3)]),
            step(lambda: freq.set(4, 880.0)),
            step(lambda: trig.trig(9))]


def test_capped_exact_bank_chunk_rest_in_superblocks(monkeypatch):
    """The eventful chunk of a capped graph of partition-exact nodes (a
    fused bank capped at 4 blocks, a chunk of 8): block 0, then the
    event-free rest as superblocks of the cap (4 and 3 blocks), where the
    JAX package scans the rest block by block; the render equals the port's
    per-block render bit for bit. (The per-block render is held against
    the JAX package's by test_capped_superblock_scan_matches_jax's kind of
    graph and tests/test_torch_voice_pool.py.)"""
    g, proc = _proc(kt, 2, chunk=8)
    script = capped_bank_block0(kt, g)
    warm(proc, 8)
    log, sizes = [], []
    record(monkeypatch, kt, log)
    process = kt.FusedSineVoiceBank.process

    def spy(self, ctx, *x, **y):
        sizes.append(ctx.block_size)
        return process(self, ctx, *x, **y)

    monkeypatch.setattr(kt.FusedSineVoiceBank, "process", spy)
    got = np.concatenate([step(proc) for step in script], axis=1)
    assert log == ["evchunk"] * 3
    assert sizes == [B, 4 * B, 3 * B] * 3
    g, per_block = _proc(kt, 2, chunk=1)
    want = np.concatenate([step(per_block) for step in capped_bank_block0(kt, g)], axis=1)
    assert np.abs(want).max() > 1e-3
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def cascade(m, g, n=10):
    """The realtime soak's cascade, cut to n SinWt: each modulates the next's
    freq (collapsed into one chain)."""
    def build(gg):
        prev, sines = None, []
        for i in range(n):
            s = gg.push(m.SinWt(100.0 + i))
            sines.append(s)
            if prev is not None:
                mod = (prev * 100.0) + 200.0
                gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
            prev = s
        (prev * 0.1).to_graph_out()
        return sines

    return g.edit(build)


def float_event_script(m, g):
    sines_ = cascade(m, g)

    def chunk(events):
        def go(proc):
            events()
            return proc.render(frames=CHUNK * B)
        return go

    def blocks(proc):
        sines_[0].param("freq").set(140.0)
        proc.run()
        return proc.output_block()

    return [
        chunk(lambda: sines_[0].param("freq").set(120.0)),  # float batch
        chunk(lambda: (sines_[0].param("freq").set(90.0),
                       sines_[4].param("reset_phase").trig())),  # a trigger
        chunk(lambda: sines_[0].param("freq").set_at(150.0, _at(m, 9 * B + 3))),
        blocks,  # run(): one float-event block
    ]


def test_float_event_programs_match_jax(monkeypatch):
    monkeypatch.setattr(jck, "_MODE", "1")  # the JAX chain kernel, interpreted
    monkeypatch.setattr(tck, "_MODE", "1")  # the port's, its plain version
    a, b, la, lb = run_both(monkeypatch, float_event_script)
    assert la == lb == ["float_evchunk", "evchunk", "full_super", "float"]
    assert_close(a, b)


def feedback_graph(m, g):
    def build(gg):
        src = gg.push(m.SinWt(330.0))
        a = gg.push(m.OnePoleLpf(900.0))
        b = gg.push(m.OnePoleLpf(2500.0))
        src.to(a)
        a.to(b)
        b.to_feedback(a)
        (b * 0.5).to_graph_out()
        return a

    a = g.edit(build)

    def go(proc):
        a.param("cutoff_freq").set_at(400.0, _at(m, B + 7))
        a.param("cutoff_freq").set_at(1200.0, _at(m, 6 * B + 2))
        return proc.render(frames=3 * CHUNK * B)

    return [go]


def test_full_scan_matches_jax(monkeypatch):
    a, b, la, lb = run_both(monkeypatch, feedback_graph)
    assert la == lb == ["full_scan", "full_scan"]
    assert_close(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_eventful_superblock_equals_sequential_blocks(dtype):
    """get_full_super_fn at m blocks == m blocks of ``render`` (u32 phases,
    ramps staired at the native blocks, events at superblock frames)."""
    g, proc = _proc(kt, dtype=dtype)
    hs = sines(kt, g)
    hs[1].param("freq").smooth(kt.Smoothing.linear(0.0007))
    amp = g.edit(lambda gg: gg.push(kt.Constant(0.5)))
    (hs[0] * amp).to_graph_out()
    g.commit()
    amp.param("value").smooth(kt.Smoothing.linear(0.002), rate="block")
    proc.render(frames=2 * B)
    hs[1].param("freq").set_at(1234.0, _at(kt, 2 * B + 3))
    amp.param("value").set_at(0.9, _at(kt, 3 * B + 11))
    hs[2].param("reset_phase").trig_at(_at(kt, 4 * B + 6))
    hs[0].param("freq").set_at(50.0, _at(kt, 5 * B - 1))
    per_block = proc._collect_due_events(CHUNK)
    assert all(any(pb) for pb in per_block[:3])
    cg = proc.compiled
    merged = proc._merged_events_lists(per_block)
    zeros = proc._zero_inputs(CHUNK * B)
    st_a, out_a, _ = get_full_super_fn(cg, CHUNK)(
        tP.copy_state(proc.state), proc._events(merged), zeros)
    st_b, outs = tP.copy_state(proc.state), []
    for lists in per_block:
        st_b, out, _ = cg.render(st_b, proc._events(lists), proc._zero_inputs(B))
        outs.append(out)
    assert torch.equal(out_a, torch.cat(outs, dim=1))
    for (pa, a), (pb, b) in zip(tP._flatten(st_a), tP._flatten(st_b)):
        assert pa == pb and torch.equal(a, b), pa


def _constants(g, values):
    return g.edit(lambda gg: [gg.push(kt.Constant(v)).to_graph_out() for v in values])


def test_async_recompile_publishes_a_warmed_program():
    g, proc = _proc(kt)
    sines(kt, g)
    warm(proc)
    proc.enable_async_recompile()
    proc.render(frames=B)
    g.edit(lambda gg: (gg.push(kt.SinWt(440.0)) * 0.1).to_graph_out())
    before = proc.compiled
    proc._kick_async_compile()  # what the next render's first block does
    assert proc.compiled is before
    proc._compile_thread.join(timeout=60)
    ready = proc._compiled_next
    assert ready is not None and ready.revision == g.revision
    # every program the runner may take at the stream's chunk is built
    assert set(ready.super_fns) >= {2, 3, 4, ("full", 4)}
    assert set(ready.evchunk_fns) == {CHUNK}
    proc.render(frames=B)
    assert proc.compiled is ready and proc.swaps[-1] == (g.revision, B)


def test_async_swap_carries_state_as_the_sync_path():
    outs = []
    for async_ in (True, False):
        g, proc = _proc(kt)
        hs = sines(kt, g)
        warm(proc)
        first = proc.render(frames=3 * B)
        hs[0].param("freq").set(777.0)
        g.edit(lambda gg: (gg.push(kt.SinWt(440.0)) * 0.1).to_graph_out())
        if async_:
            proc.enable_async_recompile()
            proc._kick_async_compile()
            proc._compile_thread.join(timeout=60)
        else:
            proc._ensure_compiled()
            warm(proc)
        outs.append(np.concatenate([first, proc.render(frames=3 * CHUNK * B)], axis=1))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_async_warm_failure_raises_where_the_swap_would_be():
    g, proc = _proc(kt)
    _constants(g, [0.25])
    warm(proc)
    proc.enable_async_recompile()

    def broken(cg, state):
        raise ValueError("warm failed")

    proc._warm_programs = broken
    _constants(g, [0.5])
    proc._kick_async_compile()
    proc._compile_thread.join(timeout=60)
    with pytest.raises(RuntimeError, match="async recompile failed") as info:
        proc.render(frames=B)
    assert isinstance(info.value.__cause__, ValueError)


@pytest.mark.parametrize("stages", [(0,), (1,), (4,), (9,), (2, 3, 7)], ids=str)
def test_triggered_stages_split_the_chain_exactly(monkeypatch, stages):
    """An eventful block whose triggers touch some stages of a collapsed
    chain: those run on the scan executor, the runs between them on the
    chain kernel (its plain version here), bit-equal to the scan executor
    over the whole chain; the float batch's block too. The root oscillator
    (0) is outside the chain: its trigger leaves the whole chain on the
    kernel."""
    outs = {}
    for mode in ("1", "0"):
        monkeypatch.setattr(tck, "_MODE", mode)
        g, proc = _proc(kt)
        sines_ = cascade(kt, g)
        proc.render(frames=2 * B)
        for k in stages:
            sines_[k].param("reset_phase").trig_at(_at(kt, 2 * B + 3 + k))
        sines_[0].param("freq").set_at(130.0, _at(kt, 3 * B + 5))
        calls = []
        with monkeypatch.context() as mp:
            mp.setattr(tck.kck, "chain_kernel",
                       lambda *a, _f=tck.kck.chain_kernel, **k: (calls.append(1), _f(*a, **k))[1])
            a = proc.render(frames=4 * B)
        outs[mode] = (a, tP._flatten(proc.state))
        if mode == "1":
            # the trigger block launches once a run of untouched stages, the
            # float block none (the scan executor), the event-free pair once
            cp = next(item for kind, item in proc.compiled.plan if kind == "chain")
            ids = {sines_[i].node_id for i in stages}
            touched = {k for k, st in enumerate(cp.stages) if ids & set(st)}
            runs = sum(1 for k in range(len(cp.stages)) if k not in touched
                       and (k == 0 or k - 1 in touched))
            assert len(calls) == runs + 1, (len(calls), runs)
    (a, sa), (b, sb) = outs["1"], outs["0"]
    np.testing.assert_array_equal(a, b)
    for (pa, x), (pb, y) in zip(sa, sb):
        assert pa == pb and torch.equal(x, y), pa
