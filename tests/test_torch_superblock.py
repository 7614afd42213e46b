"""Superblocks in the port: event-free runs render as one m*B block
(compile.get_super_fn), split as the JAX package's bounce splits them.

Ports of tests/test_superblock.py:39, :62, :82, :127 (the superblocked
render equals the per-block one with ramps and events, block-rate stairs
at native blocks, a feedback graph falls back, an envelope's done inside a
superblock) and tests/test_partition_invariance.py:81 (the param engine's
carried state bit-identical over four partitions of one render), each
against the port's own per-block render and, where it renders, the JAX
package's. Tolerances are the JAX tests': the superblock's longer scans
reassociate the SVF's float sums (2e-5), ramps are exact in one rounding
but compared at 1e-5 and 1e-6 as there. Then: the port's render takes the
JAX render's sequence of (program, length) for golden ``param_sweep``'s
schedule, a chain keeps that partition on the kernel path (its rows in a
global workspace where shared memory is too small), and a done-action free in mid-chunk leaves the chunk's
event slots as they were resolved (a repaired fault).
"""

import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.compile as jC
import knaster_tpu.graph.processor as jP
import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.compile as tC
import knaster_tpu_torch.graph.chain_kernel as tck
import knaster_tpu_torch.graph.processor as tP
from knaster_tpu_torch.graph.compile import get_super_fn, superblock_eligible
from knaster_tpu_torch.kernels import chain_kernel as kck
from tests.test_torch_param_sweep import param_sweep, phasor_cascade

SR = 48000
OPTS = dict(block_size=16, sample_rate=SR)


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    tC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


def _samples(m, n):
    return m.Seconds.from_samples(n, SR)


def _pair(m, build, outputs=1):
    """Two processors of the same graph: (handles, processor) each."""
    kw = {} if m is jk else {"device": "cpu"}
    out = []
    for _ in range(2):
        g, p = m.AudioProcessor.new(0, outputs, m.AudioProcessorOptions(**OPTS), **kw)
        out.append((g.edit(build), p))
    return out


def ramps_and_events(m):
    def build(gg):
        sines = [gg.push(m.SinWt(200.0 + 7 * i)) for i in range(8)]
        f = gg.push(m.SvfFilter(cutoff_freq=3000.0))
        for s in sines:
            s.to(f)
        f.to_graph_out()
        return sines[0], f

    (h1, p1), (h2, p2) = _pair(m, build)
    for (s, f) in (h1, h2):
        # an audio-rate smoothing ramp over many blocks and a
        # sample-accurate set landing mid-run
        f.param("cutoff_freq").smooth(m.Smoothing.linear(0.02))
        f.param("cutoff_freq").set(800.0)
        s.param("freq").set_at(432.0, _samples(m, 1000))
    a = np.asarray(p1.render(frames=4096))  # superblocked event-free runs
    b = np.asarray(p2.render(frames=4096, check_done_every=1))  # per block
    return a, b, p1


def test_superblock_matches_per_block_with_ramps_and_events():
    a, b, p = ramps_and_events(kt)
    assert max(p.compiled.super_fns) >= 64, "superblock path did not engage"
    assert np.abs(b).max() > 1e-3
    np.testing.assert_allclose(a, b, atol=2e-5)
    ja, _, _ = ramps_and_events(jk)
    np.testing.assert_allclose(a, ja, atol=2e-5)


def block_stairs(m):
    def build(gg):
        c = gg.push(m.Constant(0.0))
        c.to_graph_out()
        return c

    (c1, p1), (c2, p2) = _pair(m, build)
    for c in (c1, c2):
        c.param("value").smooth(m.Smoothing.linear(64 / SR, rate="block"))
        c.param("value").set(64.0)
    a = np.asarray(p1.render(frames=512))[0]
    b = np.asarray(p2.render(frames=512, check_done_every=1))[0]
    return a, b


def test_superblock_block_rate_smoothing_stairs_at_native_blocks():
    a, b = block_stairs(kt)
    np.testing.assert_allclose(a, b, atol=1e-5)
    steps = np.unique(np.round(a, 4))
    assert len(steps) >= 4  # a real staircase, not one big jump
    for j in range(0, 512, 16):
        assert np.all(a[j:j + 16] == a[j])  # flat within native blocks
    np.testing.assert_array_equal(a, block_stairs(jk)[0])


def test_feedback_graph_falls_back_and_matches():
    def build(gg):
        src = gg.push(kt.Constant(0.25))
        f = gg.push(kt.SvfFilter(cutoff_freq=20000.0))
        src.to(f)
        f.to_feedback(f)  # one-block-delay loop: a semantic boundary
        f.to_graph_out()
        return f

    (_, p1), (_, p2) = _pair(kt, build)
    p1._ensure_compiled()
    assert not superblock_eligible(p1.compiled)
    assert get_super_fn(p1.compiled, 16) is None
    a = p1.render(frames=512)
    b = p2.render(frames=512, check_done_every=1)
    assert np.abs(b).max() > 1e-3
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert not p1.compiled.super_fns


def envelope_done(m):
    def build(gg):
        s = gg.push(m.SinWt(440.0))
        e = gg.push_with_done_action(m.EnvAsr(0.001, 0.002), m.Done.FREE_SELF)
        (s * e).to_graph_out()
        return e

    (e1, p1), (e2, p2) = _pair(m, build)
    for e in (e1, e2):
        e.param("t_restart").trig()
        e.param("t_release").trig_at(_samples(m, 300))
    a = np.asarray(p1.render(frames=2048))
    b = np.asarray(p2.render(frames=2048, check_done_every=1))
    return a, b, p1


def test_envelope_done_inside_superblock():
    """The done vector of a superblock is its blocks' OR, applied after it;
    the freed envelope is gone from the graph at the next chunk."""
    a, b, p = envelope_done(kt)
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert p.compiled.super_fns  # the release ended inside a superblock
    assert not any(isinstance(e.ugen, kt.EnvAsr) for e in p.graph.nodes.values())
    assert np.abs(a[:, :300]).max() > 0.1 and np.abs(a[:, 500:]).max() == 0.0
    np.testing.assert_allclose(a, envelope_done(jk)[0], atol=1e-6)


def free_mid_chunk(m):
    """An envelope that frees itself in the chunk's third block, and a set
    on another node later in the same chunk."""
    kw = {} if m is jk else {"device": "cpu"}
    g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=64), **kw)

    def build(gg):
        e = gg.push_with_done_action(m.EnvAsr(0.001, 0.001), m.Done.FREE_SELF)
        (gg.push(m.SinWt(300.0)) * e).to_graph_out()
        c = gg.push(m.Constant(0.25))
        c.to_graph_out()
        return e, c

    e, c = g.edit(build)
    e.param("t_restart").trig()
    e.param("t_release").trig_at(_samples(m, 100))
    c.param("value").set_at(0.75, _samples(m, 600))
    return np.asarray(proc.render(frames=1024)), g


def test_free_mid_chunk_keeps_the_chunk_event_slots():
    """Repaired: a done-action free recompiles the graph at the next chunk,
    not at the next block. The chunk's events were resolved to the slots
    of the graph it started with; recompiling under them raised an
    IndexError (or moved a set to another param)."""
    a, g = free_mid_chunk(kt)
    assert not any(isinstance(e.ugen, kt.EnvAsr) for e in g.nodes.values())
    np.testing.assert_array_equal(a[0, 700:], np.float32(0.75))
    np.testing.assert_allclose(a, free_mid_chunk(jk)[0], rtol=0, atol=1e-6)


PARTITIONS = [[1536], [32] * 48, [7, 13, 100, 204, 512, 700], [480, 480, 576]]


def render_engine(parts):
    g, proc = kt.AudioProcessor.new(
        0, 1, kt.AudioProcessorOptions(block_size=32, sample_rate=SR), device="cpu")

    def build(gg):
        s = gg.push(kt.SinWt(440.0))
        c = gg.push(kt.Constant(0.5))
        (s * c).to_graph_out()
        return s.param("freq"), c.param("value")

    freq, amp = g.edit(build)
    # ramps and re-anchoring sets at assorted mid-block frames, queued up
    # front at absolute times so every partition sees one schedule
    freq.smooth(kt.Smoothing.linear(0.005))
    freq.set_at(880.0, _samples(kt, 37))
    freq.set_at(550.0, _samples(kt, 411))  # re-set mid-ramp
    amp.smooth(kt.Smoothing.linear(0.01))
    amp.set_at(0.9, _samples(kt, 700))
    out = np.concatenate([proc.render(frames=n) for n in parts], axis=-1)
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        else:
            leaves.append(x.numpy())

    walk(proc.state)
    return out, leaves


@pytest.mark.parametrize("parts", PARTITIONS[1:], ids=["blocks", "ragged", "thirds"])
def test_engine_ramp_state_partition_invariant(parts):
    ref_out, ref_state = render_engine(PARTITIONS[0])
    out, state = render_engine(parts)
    assert len(state) == len(ref_state)
    for i, (x, y) in enumerate(zip(state, ref_state)):
        np.testing.assert_array_equal(x, y, err_msg=f"state leaf {i}")
    np.testing.assert_allclose(out, ref_out, atol=1e-6)


# --------------------------------------------------------------------------
# the run split against the JAX package's
# --------------------------------------------------------------------------

def spy_programs(monkeypatch, m, proc):
    """Record (program, blocks) for every renderer call of ``proc.render``:
    'super' (a superblock), 'fast' (an event-free block), 'full' (an
    eventful block). Wraps the processor module's ``get_super_fn`` and the
    compiled graph's two block renderers."""
    seq = []
    mod = jP if m is jk else tP
    real = mod.get_super_fn

    def get(cg, k, *a, **kw):
        fn = real(cg, k, *a, **kw)
        if fn is None:
            return None

        def logged(*args):
            seq.append(("super", k))
            return fn(*args)

        return logged

    monkeypatch.setattr(mod, "get_super_fn", get)
    proc._ensure_compiled()
    cg = proc.compiled
    fast, full = cg.render_fast, cg.render

    def fast_logged(*args):
        seq.append(("fast", 1))
        return fast(*args)

    def full_logged(*args):
        seq.append(("full", 1))
        return full(*args)

    cg.render_fast, cg.render = fast_logged, full_logged
    return seq


def test_render_takes_the_jax_partition(monkeypatch):
    """Golden param_sweep's schedule (events in blocks 0, 15, 39 and 109 of
    225) renders through the same (program, length) sequence in both
    packages: single eventful blocks, superblocks of 64 down to 2 blocks,
    single event-free blocks."""
    seqs = {}
    for m, dtype in ((jk, np.float32), (kt, torch.float32)):
        proc = param_sweep(m, dtype)
        seqs[m] = spy_programs(monkeypatch, m, proc)
        proc.render(frames=14400)
    assert seqs[kt] == seqs[jk]
    assert sum(k for p, k in seqs[kt]) == 225
    assert ("super", 64) in seqs[kt] and ("fast", 1) in seqs[kt]
    assert seqs[kt].count(("full", 1)) == 4


def test_chain_superblocks_stay_on_the_kernel(monkeypatch):
    """The kernel path takes the JAX bounce's partition: a chain no longer
    caps the graph's superblocks, so the Phasor cascade renders its 128
    event-free blocks as one superblock of 8192 samples, on the kernel,
    whose 9 rows (5 slots, a carry and 3 scan rows) then outgrow one CTA's
    shared memory and spread over a cluster of 16 CTAs, 512 samples each.
    Off the kernel path the partition is the same."""
    calls = {"B": [], "ok": []}
    real = tck.run

    def spy(cp, reps, ctx, *a, **k):
        r = real(cp, reps, ctx, *a, **k)
        calls["B"].append(ctx.block_size)
        calls["ok"].append(r is not None)
        return r

    monkeypatch.setattr(tck, "run", spy)
    _, proc = _render_cascade(monkeypatch, "1", 64, 128)
    assert proc.compiled.superblock_max == float("inf")
    assert calls["B"] == [128 * 64] and all(calls["ok"])
    cp = _chain_of(proc)[0]
    program = cp.lowered["cpu"][0]
    assert kck.row_floats(program, 128 * 64) == 9 * 128 * 64
    assert kck.launch_plan(program, 64, 11).layout == "shared"
    plan = kck.launch_plan(program, 128 * 64, 11)
    assert (plan.layout, plan.cluster, plan.chunk) == ("cluster", 16, 512)
    calls["B"].clear()
    _, proc = _render_cascade(monkeypatch, "0", 64, 128)
    assert proc.compiled.superblock_max == float("inf")
    assert sorted(proc.compiled.super_fns) == [128] and not calls["B"]


def test_forced_row_limit_keeps_the_jax_partition(monkeypatch):
    """With the shared-row limit forced down to 64 bytes, every launch of
    the cascade would take the global workspace: the render still takes
    the JAX bounce's (program, length) sequence and the same samples as
    with the limit as it is, and as the JAX render's within its chain
    tolerance."""
    seqs, audio, full = {}, {}, kck.SMEM_LIMIT
    get_super_fn = tP.get_super_fn
    for limit in (full, 64):
        monkeypatch.setattr(tP, "get_super_fn", get_super_fn)  # one spy at a time
        monkeypatch.setattr(kck, "SMEM_LIMIT", limit)
        monkeypatch.setattr(tck, "_MODE", "1")
        # the row limit is read where the chain is lowered, and a lowered
        # program is cached by the graph's signature, which the limit is not
        # part of
        tC.clear_program_cache()
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                        device="cpu")
        g.edit(lambda gg: phasor_cascade(kt, gg))
        seqs[limit] = spy_programs(monkeypatch, kt, proc)
        audio[limit] = proc.render(frames=16 * 200)
        program = _chain_of(proc)[0].lowered["cpu"][0]
        assert kck.rows_in_shared(program, 16) == (limit == full)
    monkeypatch.setattr(tck, "_MODE", None)
    jC.clear_program_cache()
    g, jproc = jk.AudioProcessor.new(0, 1, jk.AudioProcessorOptions(block_size=16))
    g.edit(lambda gg: phasor_cascade(jk, gg))
    jseq = spy_programs(monkeypatch, jk, jproc)
    j = np.asarray(jproc.render(frames=16 * 200))
    (a, b) = audio.values()
    assert seqs[64] == seqs[full] == jseq
    assert ("super", 128) in jseq
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, j, rtol=0, atol=2e-6)


def _render_cascade(monkeypatch, mode, bs, n_blocks):
    monkeypatch.setattr(tck, "_MODE", mode)
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=bs),
                                    device="cpu")
    g.edit(lambda gg: phasor_cascade(kt, gg))
    return proc.render(frames=n_blocks * bs), proc


def _chain_of(proc):
    cp = next(item for kind, item in proc.compiled.plan if kind == "chain")
    reps = [proc.compiled.entries[cp.stages[0][j]].ugen for j in range(cp.period)]
    return cp, reps, proc.compiled.ctx
