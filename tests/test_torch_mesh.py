"""Voice banks sharded over devices in one process: the port's ``parallel/mesh.py`` against the JAX package.

The JAX side shards over its 8 virtual CPU devices (``jax.make_mesh``,
``shard_map``), as its own mesh tests do; the port's mesh is
``make_mesh(["cpu"] * 8)``: eight local banks in this process, their mixes
summed in shard order. Ports of tests/test_voicebank.py:138, 229, 486, 760,
800, 838 and 869, tests/test_generic_bank.py:494, tests/test_voice_pool.py:70
and tests/test_mesh_runtime.py:66, 89 and 119. Each holds the port's
sharded bank against its own unsharded bank (the JAX tests' own check);
the banks, the superblock cap, the live events, the converter and the
cluster graph also against the JAX package's mesh. The other graph tests
(the filter-bus and Pallas graphs, the render continuity, the pool, the
checkpoint, the stream) are held against the port's unsharded bank or
graph: a JAX mesh graph with events compiles ~5 s a program on the CPU.
Each of their docstrings names the test that holds the same graph, sharded
or not, against the JAX package. Besides:

- a mesh of one shard is bit-equal to the unsharded bank, every bank;
- a ``MeshVoiceBank`` over a fused bank carries the bank's superblock cap:
  an event-free render past 1024 samples never hands its local bank a
  block past ``MAX_BLOCK``, and its audio equals the JAX package's (whose
  mesh bank carries no cap and renders longer superblocks);
- a re-pushed ``MeshVoiceBank`` misses the program cache in both packages
  (its structural signature is None in both);
- ``convert.sharded_state_from_jax``: one JAX state steps both packages;
- tools/mesh_voice_cluster.py against examples/mesh_voice_cluster.py's
  graph built over the JAX package, two chords long.

For the fused banks the JAX side stays small (128 voices a device,
``tile_rows=1``); the port's sharded bank is also held against its own
unsharded bank at the JAX tests' sizes.

Tolerances are the JAX tests' own: 1e-5 for a mix (2e-5 for the graphs with
the filter bus and the live events), 1e-6 for state continuity. Sharding
changes only the order in which the voices' terms are summed.
"""

import time

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.compile as jC

import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.compile as tC
from knaster_tpu_torch.convert import sharded_state_from_jax, sharded_state_to_numpy
from knaster_tpu_torch.kernels.bank_common import MAX_BLOCK

SR = 48000
B = 64
N_DEV = 8
OPTS = {"block_size": B, "sample_rate": SR}
EVENT_FREE = MAX_BLOCK + B  # the superblock-cap test's event-free render
CLUSTER_SPACING = 0.02  # seconds between the mesh_voice_cluster test's chords


@pytest.fixture(autouse=True)
def _isolated_caches():
    jC.clear_program_cache()
    tC.clear_program_cache()
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


def _jmesh():
    assert len(jax.devices()) == N_DEV
    return jax.make_mesh((N_DEV,), ("voices",))


def _tmesh(n=N_DEV):
    return kt.make_mesh(["cpu"] * n)


def _mesh(m, n=N_DEV):
    return _jmesh() if m is jk else _tmesh(n)


def _ctx(m):
    return jk.AudioCtx(SR, B, np.float32) if m is jk else kt.AudioCtx(SR, B, torch.float32)


def _proc(m, outputs=2, **opts):
    kw = {} if m is jk else {"device": "cpu"}
    return m.AudioProcessor.new(0, outputs, m.AudioProcessorOptions(**OPTS, **opts), **kw)


def _synchronous(jproc):
    """The JAX processor's block functions, each waited for before the next
    is dispatched. Block by block, XLA:CPU dispatches the next shard_map
    program while the last one runs; under a loaded host the two programs'
    all-reduce participants can starve each other of the 8 device threads
    until XLA aborts the process (its 40 s rendezvous timeout)."""
    jproc._ensure_compiled()
    cg = jproc.compiled
    for name in ("render", "render_fast"):
        setattr(cg, name, lambda *a, fn=getattr(cg, name): jax.block_until_ready(fn(*a)))
    return jproc


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _samples(m, n):
    return m.Seconds.from_samples(n, SR)


# --------------------------------------------------------------------------
# the banks
# --------------------------------------------------------------------------

def _sine_defaults(V, seed):
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(100, 2000, V).astype(np.float32),
            "amp": np.full(V, 0.01, np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32)}


def _fm_defaults(V, seed):  # tests/test_generic_bank.py's
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(100, 800, V).astype(np.float32),
            "ratio": rng.choice([1.0, 2.0], V).astype(np.float32),
            "index": rng.uniform(0.5, 2.0, V).astype(np.float32),
            "amp": np.full(V, 0.01, np.float32)}


def _saw(m):
    nb = m.NonAaWavetable()
    nb.add_saw(1, 10, 1.0)
    return nb.buffer


def fused_bank(m, kind, V, capacity=512):
    """The bank of ``kind`` in ``m``: the JAX package's Pallas bank
    (``tile_rows=1``) or the port's fused bank, with the JAX mesh tests'
    defaults."""
    jax_side = m is jk
    tiles = {"tile_rows": 1} if jax_side else {}
    kw = dict(event_capacity=capacity, **tiles)
    if kind == "sine":  # tests/test_voicebank.py:229
        cls = jk.PallasSineVoiceBank if jax_side else kt.FusedSineVoiceBank
        return cls(V, voice_defaults=_sine_defaults(V, 5), **kw)
    if kind == "wt":  # tests/test_voicebank.py:486
        cls = jk.PallasWavetableVoiceBank if jax_side else kt.FusedWavetableVoiceBank
        return cls(V, table=_saw(m), n_harmonics=8, voice_defaults=_sine_defaults(V, 6), **kw)
    if kind == "generic-fm":  # tests/test_generic_bank.py:494
        cls = jk.PallasVoiceBank if jax_side else kt.FusedVoiceBank
        return cls(m.FMVoice(), V, voice_defaults=_fm_defaults(V, 21), **kw)
    if kind == "fm":
        cls = jk.PallasFMVoiceBank if jax_side else kt.FusedFMVoiceBank
        return cls(V, voice_defaults=_fm_defaults(V, 22), **kw)
    if kind == "sub":
        cls = jk.PallasSubtractiveVoiceBank if jax_side else kt.FusedSubtractiveVoiceBank
        return cls(V, voice_defaults=_sine_defaults(V, 23), **kw)
    if kind == "envelope":
        cls = jk.PallasVoiceBank if jax_side else kt.FusedVoiceBank
        return cls(m.EnvelopeVoice(), V, voice_defaults=_sine_defaults(V, 24), **kw)
    raise AssertionError(kind)


def vmap_bank(m, V=16, **kw):
    freqs = 220.0 * (1 + np.arange(V, dtype=np.float32) / V)
    return m.VoiceBank(m.SineVoice(amp=0.05), V, voice_defaults={"freq": freqs}, **kw)


def restarts(bank, V, step=17):
    return [(0, v, bank.trig_index("t_restart"), 1, 0.0) for v in range(0, V, step)]


def step_sharded(sb, events, n_blocks=2):
    """``n_blocks`` steps of a sharded bank (either package): ``events`` in
    the first, empty event tensors after; the mixes concatenated."""
    st = sb.init_state()
    outs = []
    for i in range(n_blocks):
        st, o = sb.step(st, sb.events_from_lists(events) if i == 0 else sb.empty_events())
        outs.append(_np(o))
    return np.concatenate(outs, axis=1)


def step_unsharded(m, bank, events, n_blocks=2):
    """The same blocks through the unsharded bank's ``process``."""
    ctx = _ctx(m)
    st = bank.init(ctx) if m is jk else bank.init(ctx, "cpu")
    no_in = np.zeros((0, B), np.float32) if m is jk else None
    outs = []
    for i in range(n_blocks):
        ev = bank.node_events_from_lists(events) if i == 0 else bank.empty_node_events()
        r = bank.process(ctx, st, no_in, {}, events=ev)
        st = r[0]
        outs.append(_np(r[1]))
    return np.concatenate(outs, axis=1)


# --------------------------------------------------------------------------
# ShardedVoiceBank
# --------------------------------------------------------------------------

def test_mesh_and_errors():
    mesh = kt.make_mesh(["cpu", torch.device("cpu")])
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.shape == {"voices": 2}
    with pytest.raises(ValueError, match="at least one device"):
        kt.make_mesh([])
    with pytest.raises(ValueError, match="one axis"):
        kt.make_mesh(["cpu"], ("a", "b"))
    with pytest.raises(ValueError, match="mix='sum'"):
        kt.MeshVoiceBank(kt.VoiceBank(kt.SineVoice(), 8, mix="stack"), mesh)
    with pytest.raises(ValueError, match="must divide"):
        kt.ShardedVoiceBank(kt.VoiceBank(kt.SineVoice(), 9), mesh, _ctx(kt))


def test_sharded_voicebank_matches_single_device():
    """tests/test_voicebank.py:138: the vmap bank over 8 shards equals the
    JAX package's shard_map and the port's unsharded bank; render() with
    stacked events equals the steps."""
    events = [(0, v, 0, 1, 0.0) for v in range(13)] + [(10, 13, 0, 1, 0.0)]
    want = step_sharded(jk.ShardedVoiceBank(vmap_bank(jk), _jmesh(), _ctx(jk)), events)
    bank = vmap_bank(kt)
    sb = kt.ShardedVoiceBank(bank, _tmesh(), _ctx(kt))
    got = step_sharded(sb, events)
    unsharded = step_unsharded(kt, bank, events)
    assert np.abs(unsharded).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, unsharded, rtol=0, atol=1e-5)
    ev_stack = {k: np.stack([a, b]) for (k, a), b in zip(
        sb.events_from_lists(events).items(), sb.empty_events().values())}
    scanned = sb.render(2, events_per_block=ev_stack)
    np.testing.assert_allclose(scanned.numpy(), unsharded, rtol=0, atol=1e-5)


_JAX_SHARDED = {}


def jax_sharded(kind, V=128 * N_DEV):
    """The JAX package's ShardedVoiceBank over its Pallas bank of ``kind``,
    built once (its shard_map program compiles at the first step)."""
    if kind not in _JAX_SHARDED:
        _JAX_SHARDED[kind] = jk.ShardedVoiceBank(fused_bank(jk, kind, V), _jmesh(), _ctx(jk))
    return _JAX_SHARDED[kind]


@pytest.mark.parametrize("kind", ["sine", "wt", "generic-fm"])
def test_sharded_fused_bank_matches_jax(kind):
    """tests/test_voicebank.py:229 and :486, tests/test_generic_bank.py:494,
    at 128 voices a device: the port's fused bank over 8 shards against the
    JAX package's Pallas bank under shard_map."""
    V = 128 * N_DEV
    jsb = jax_sharded(kind)
    want = step_sharded(jsb, restarts(jsb.bank, V))
    tb = fused_bank(kt, kind, V)
    got = step_sharded(kt.ShardedVoiceBank(tb, _tmesh(), _ctx(kt)), restarts(tb, V))
    assert np.abs(want).max() > 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,V", [("sine", 8 * 1024), ("wt", 8 * 1024),
                                    ("generic-fm", 128 * N_DEV * 2), ("fm", 1024),
                                    ("sub", 1024)])
def test_sharded_fused_bank_matches_unsharded(kind, V):
    """The JAX tests' own check at their sizes (the FM and subtractive hand
    banks at 1024 voices): the port's fused bank over 8 shards equals it
    unsharded."""
    bank = fused_bank(kt, kind, V)
    events = restarts(bank, V, 17 if kind in ("sine", "wt") else 7)
    got = step_sharded(kt.ShardedVoiceBank(bank, _tmesh(), _ctx(kt)), events)
    want = step_unsharded(kt, bank, events)
    assert np.abs(want).max() > 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["vmap", "sine", "fm", "sub", "wt", "generic-fm", "envelope"])
def test_one_shard_is_bit_equal_to_the_unsharded_bank(kind):
    """A mesh of one shard runs the same bank code over the same voices: its
    mix and its state are bit-equal to the unsharded bank's."""
    V = 256
    bank = vmap_bank(kt, V) if kind == "vmap" else fused_bank(kt, kind, V)
    events = restarts(bank, V, 3)
    ctx = _ctx(kt)
    sb = kt.ShardedVoiceBank(bank, _tmesh(1), ctx)
    st, ust = sb.init_state(), bank.init(ctx, "cpu")
    for i in range(3):
        ev = bank.node_events_from_lists(events) if i == 0 else None
        st, out = sb.step(st, ev)
        r = bank.process(ctx, ust, None, {}, events=ev)
        ust = r[0]
        assert torch.equal(out, r[1]), f"block {i}"
    joined = sb.node.join(ctx, st)
    flat = lambda t: (t if not isinstance(t, dict)  # noqa: E731
                      else [x for k in sorted(t) for x in flat(t[k])])
    assert all(torch.equal(a, b) for a, b in zip(flat(joined), flat(ust)))


def test_sharded_bank_spec_inference_nonleading_axis():
    """tests/test_voicebank.py:760: each leaf's voice axis is inferred from
    the full and the local bank's shapes, wherever it sits, as the JAX
    package infers its PartitionSpecs; an ambiguous leaf is refused."""
    from jax.sharding import PartitionSpec as P

    def weird(m):
        class WeirdBank(m.VoiceBank):
            def make_local(self, n_local):
                return WeirdBank(self.voice, n_local, event_capacity=self.event_capacity)

            def init(self, ctx, device="cpu"):
                if m is jk:
                    base = super().init(ctx)
                    z = lambda s: jax.numpy.zeros(s, ctx.dtype)  # noqa: E731
                else:
                    base = super().init(ctx, device)
                    z = lambda s: torch.zeros(s, dtype=ctx.dtype, device=device)  # noqa: E731
                base["weird"] = z((2, self.n_voices, 3))
                base["shared"] = z((5,))
                return base

            def process(self, ctx, state, inputs, params, events=None):
                state = dict(state)
                extra = {"weird": state.pop("weird"), "shared": state.pop("shared")}
                new_state, out, done = super().process(ctx, state, inputs, params,
                                                       events=events)
                new_state.update(extra)
                return new_state, out, done

        return WeirdBank(m.SineVoice(amp=0.05), 16)

    jsb = jk.ShardedVoiceBank(weird(jk), _jmesh(), _ctx(jk))
    sb = kt.ShardedVoiceBank(weird(kt), _tmesh(), _ctx(kt))
    for key, axis in (("weird", 1), ("shared", None), ("fvals", 1), ("active", 0)):
        assert sb._specs[key] == axis
        assert jsb._specs[key] == (P() if axis is None else P(*([None] * axis + ["voices"])))
    st = sb.init_state()
    assert st["shard3"]["weird"].shape == (2, 2, 3) and st["shard3"]["shared"].shape == (5,)
    st, out = sb.step(st, sb.empty_events())
    assert out.shape == (2, 64)

    class Ambiguous(kt.VoiceBank):
        def make_local(self, n_local):
            return Ambiguous(self.voice, n_local)

        def init(self, ctx, device="cpu"):
            base = super().init(ctx, device)
            base["square"] = torch.zeros((self.n_voices, self.n_voices))
            return base

    with pytest.raises(ValueError, match="cannot infer the voice axis"):
        kt.ShardedVoiceBank(Ambiguous(kt.SineVoice(), 16), _tmesh(), _ctx(kt))


def test_sharded_render_is_state_continuous():
    """tests/test_voicebank.py:869: two 4-block renders equal one 8-block
    render from the same state, which render() leaves unchanged; the
    8-block render equals the unsharded bank's blocks. (This bank over 8
    shards is held against the JAX package's shard_map by
    test_sharded_voicebank_matches_single_device.)"""
    bank = vmap_bank(kt)
    ctx = _ctx(kt)
    sb = kt.ShardedVoiceBank(bank, _tmesh(), ctx)
    events = [(0, v, 0, 1, 0.0) for v in range(16)]
    st, _ = sb.step(sb.init_state(), sb.events_from_lists(events))
    whole = sb.render(8, state=st).numpy()
    a, st2 = sb.render(4, state=st, return_state=True)
    b = sb.render(4, state=st2).numpy()
    np.testing.assert_allclose(np.concatenate([a.numpy(), b], axis=1), whole, rtol=0,
                               atol=1e-6)
    ust = bank.process(ctx, bank.init(ctx), None, {},
                       events=bank.node_events_from_lists(events))[0]
    want = []
    for _ in range(8):
        ust, out, _ = bank.process(ctx, ust, None, {})
        want.append(out.numpy())
    np.testing.assert_allclose(whole, np.concatenate(want, axis=1), rtol=0, atol=1e-5)


def test_sharded_state_from_jax_steps_both_packages():
    """One JAX sharded state, converted by ``sharded_state_from_jax``,
    drives both packages for 4 blocks (a restart block, then event-free):
    the mixes within 1e-6, and the port's state back in the JAX layout
    (``sharded_state_to_numpy``) equal to the JAX state."""
    V = 128 * N_DEV
    jsb = jax_sharded("sine")
    jb = jsb.bank
    sb = kt.ShardedVoiceBank(fused_bank(kt, "sine", V), _tmesh(), _ctx(kt))
    sj = jsb.init_state()
    sj, _ = jsb.step(sj, jsb.events_from_lists(restarts(jb, V, 3)))
    st = sharded_state_from_jax(jax.tree_util.tree_map(np.asarray, sj), sb)
    assert [s["phase"].shape for s in sb.node.shards(st)] == [(128,)] * N_DEV
    for blk in range(4):
        ev = restarts(jb, V, 5) if blk == 0 else []
        sj, oj = jsb.step(sj, jsb.events_from_lists(ev))
        st, ot = sb.step(st, sb.events_from_lists(ev))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6,
                                   err_msg=f"block {blk}")
    back = sharded_state_to_numpy(st, sb)
    for k, v in jax.tree_util.tree_map(np.asarray, sj).items():
        np.testing.assert_allclose(back[k], v, rtol=0, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# MeshVoiceBank in a graph
# --------------------------------------------------------------------------

def _graph_bank(m, node):
    """tests/test_voicebank.py:800's graph: the bank, its left channel
    through an SvfFilter bus, its right straight out; restarts on every
    voice, a mid-block restart and a float set."""
    g, proc = _proc(m)

    def build(gg):
        h = gg.push(node)
        f = gg.push(m.SvfFilter(cutoff_freq=4000.0))
        h.out([0]).to(f)
        f.to_graph_out()
        h.out([1]).to_graph_out_channels([1])
        return h

    h = g.edit(build)
    for v in range(node.n_voices):
        h.voice_param("t_restart").trig(v)
    h.voice_param("t_restart").trig_at(1, _samples(m, 100))
    h.voice_param("freq").set_at(2, 990.0, _samples(m, 200))
    return proc


def test_mesh_voicebank_inside_graph_matches_unsharded():
    """tests/test_voicebank.py:800: a MeshVoiceBank is a graph node; with a
    filter bus and per-voice events it equals the port's graph with the
    unsharded bank. (The unsharded vmap bank in a graph is held against
    the JAX package by tests/test_torch_voicebank_graph.py::
    test_voice_bank_in_graph_matches_jax, and a mesh bank through the same
    filter bus against the JAX mesh graph by
    test_mesh_voice_cluster_matches_the_jax_example.)"""
    V = 4 * N_DEV
    got = _graph_bank(kt, kt.MeshVoiceBank(vmap_bank(kt, V), _tmesh())).render(frames=1024)
    plain = _graph_bank(kt, vmap_bank(kt, V)).render(frames=1024)
    assert np.abs(plain).max() > 1e-3
    np.testing.assert_allclose(got, plain, rtol=0, atol=2e-5)


def _pallas_graph(m, shard, V, frames):
    g, proc = _proc(m)
    bank = fused_bank(m, "sine", V)
    node = m.MeshVoiceBank(bank, _mesh(m)) if shard else bank
    h = g.edit(lambda gg: gg.push(node))
    h.to_graph_out()
    g.commit()
    for v in range(0, V, 3):
        h.voice_param("t_restart").trig(v)
    return proc, h, proc.render(frames=frames)


def test_mesh_voicebank_pallas_inside_graph():
    """tests/test_voicebank.py:838: a fused kernel bank shards into the graph
    too; against the port's unsharded graph. (The JAX mesh graph is the
    reference of test_mesh_bank_superblock_cap.)"""
    V = 128 * N_DEV
    _, _, got = _pallas_graph(kt, True, V, 512)
    _, _, plain = _pallas_graph(kt, False, V, 512)
    assert np.abs(plain).max() > 1e-4
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)


def test_mesh_bank_superblock_cap():
    """A MeshVoiceBank carries its fused bank's superblock cap (the JAX
    package's carries none): an event-free render of 17 blocks (1088
    samples) after the restarts hands the local bank no block past
    MAX_BLOCK, and the audio equals the JAX package's, whose local bank
    renders them as one 1088-sample superblock."""
    V = 128 * N_DEV
    seen = []
    proc, h, head = _pallas_graph(kt, True, V, B)
    node = proc.graph._node(h.node_id).ugen
    assert node.superblock_cap == MAX_BLOCK == node.bank.superblock_cap
    process = node._local.process

    def spy(ctx, *a, **k):
        seen.append(ctx.block_size)
        return process(ctx, *a, **k)

    node._local.process = spy
    got = np.concatenate([head, proc.render(frames=EVENT_FREE)], axis=1)
    assert sorted(seen) == [B] * N_DEV + [MAX_BLOCK] * N_DEV
    jproc, jh, jhead = _pallas_graph(jk, True, V, B)
    assert getattr(jproc.graph._node(jh.node_id).ugen, "superblock_cap", None) is None
    want = np.concatenate([jhead, jproc.render(frames=EVENT_FREE)], axis=1)
    assert np.abs(want[:, B:]).max() > 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mesh_voicebank_repush_misses_the_program_cache():
    """The structural signature of a MeshVoiceBank is None in both packages,
    so pushing one again after freeing it compiles afresh."""
    for m in (jk, kt):
        g, proc = _proc(m)
        hits = []
        for _ in range(2):
            for nid in list(g.nodes):
                g.edit(lambda gg, nid=nid: gg.free_node(nid))
            h = g.edit(lambda gg: gg.push(m.MeshVoiceBank(vmap_bank(m, N_DEV), _mesh(m))))
            h.to_graph_out()
            g.commit()
            proc.render(frames=B)
            hits.append(proc.compiled.cache_hit)
        assert hits == [False, False], m.__name__


# --------------------------------------------------------------------------
# VoicePool, the runtime, checkpoints and the stream
# --------------------------------------------------------------------------

def test_pool_over_mesh_bank_auto_release():
    """tests/test_voice_pool.py:70: VoicePool over a MeshVoiceBank releases
    every voice once its envelope ran out: the shards' idle latches, joined
    in shard order. (The pool over an unsharded bank is held against the
    JAX package's by tests/test_torch_voice_pool.py::
    test_pool_over_envelope_voice_bank; the fused bank's latch through the
    mesh, an Envelope body's, is held on the card: chip_smoke.py
    phase_mesh.)"""
    g, proc = _proc(kt)
    bank = kt.VoiceBank(kt.SineVoice(attack=0.001, release=0.004), 64, event_capacity=512)
    h = g.edit(lambda gg: gg.push(kt.MeshVoiceBank(bank, _tmesh())))
    h.to_graph_out()
    g.commit()
    pool = kt.VoicePool(proc, h)
    proc.render(frames=B)
    voices = [pool.note_on({"freq": 300.0 + 10 * i, "amp": 0.002})
              for i in range(pool.n_voices)]
    assert all(v is not None for v in voices)
    proc.render(frames=B * 2)
    for v in voices:
        pool.note_off(v)
    proc.render(frames=B * 6)  # envelopes run out: 4 ms of release
    assert pool.refresh() == pool.n_voices
    assert pool.free_count == pool.n_voices
    assert pool.note_on({"freq": 440.0, "amp": 0.002}) is not None


def _runtime_bank(m):
    freqs = 220.0 * (1 + np.arange(16, dtype=np.float32) / 16)
    return m.VoiceBank(m.SineVoice(amp=0.02), 16, voice_defaults={"freq": freqs},
                       event_capacity=512)


def _schedule_events(m, handle, n_events=120):
    """tests/test_mesh_runtime.py's >= 100 live per-voice events: triggers,
    float sets, smoothing ramps, releases."""
    rng = np.random.default_rng(7)
    t = handle.voice_param("t_restart")
    r = handle.voice_param("t_release")
    f = handle.voice_param("freq")
    frame = 10
    for count in range(n_events):
        v = int(rng.integers(0, 16))
        which = count % 4
        if which == 0:
            t.trig_at(v, _samples(m, frame))
        elif which == 1:
            f.set_at(v, float(rng.uniform(150, 800)), _samples(m, frame))
        elif which == 2:
            f.smooth(v, 0.002)
            f.set_at(v, float(rng.uniform(150, 800)), _samples(m, frame + 3))
        else:
            r.trig_at(v, _samples(m, frame))
        frame += int(rng.integers(17, 97))
    return frame


def _runtime_graph(m, shard, **opts):
    g, proc = _proc(m, **opts)
    node = m.MeshVoiceBank(_runtime_bank(m), _mesh(m)) if shard else _runtime_bank(m)
    h = g.edit(lambda gg: gg.push(node))
    h.to_graph_out()
    g.commit()
    return g, proc, h


def test_mesh_graph_render_with_live_events_matches_unsharded():
    """tests/test_mesh_runtime.py:66: 120 live per-voice events (triggers,
    float sets, smoothing ramps and releases, each localized to its shard)
    through compile, per-block events and render over the mesh equal the
    JAX package's mesh graph on the same schedule (rendered block by block:
    one shard_map program for each kind of block, each waited for: see
    ``_synchronous``) and the port's unsharded graph."""
    renders = {}
    for m, shard, opts in ((kt, True, {}), (kt, False, {}),
                           (jk, True, {"render_chunk_blocks": 1})):
        _, proc, h = _runtime_graph(m, shard, **opts)
        end = _schedule_events(m, h)
        if m is jk:
            _synchronous(proc)
        renders[m, shard] = np.asarray(proc.render(frames=((end + 256) // B) * B))
    got = renders[kt, True]
    assert np.abs(renders[kt, False]).max() > 1e-4
    np.testing.assert_allclose(got, renders[jk, True], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, renders[kt, False], rtol=0, atol=2e-5)


def test_mesh_state_carries_across_an_edit():
    """A live edit recompiles the graph: the mesh node's per-shard state is
    carried by node correspondence (and copied for the warm) like any
    node's, so the voices sound on as the unsharded bank's do."""
    renders = {}
    for shard in (True, False):
        g, proc, h = _runtime_graph(kt, shard)
        for v in range(16):
            h.voice_param("t_restart").trig(v)
        first = proc.render(frames=256)
        g.edit(lambda gg: (gg.push(kt.SinWt(330.0)) * 0.01).to_graph_out())
        renders[shard] = np.concatenate([first, proc.render(frames=256)], axis=1)
    assert np.abs(renders[False][:, 256:]).max() > 1e-3
    np.testing.assert_allclose(renders[True], renders[False], rtol=0, atol=2e-5)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """tests/test_mesh_runtime.py:89: save_state/load_state of a mesh graph:
    each shard's leaves come back onto that shard's device (restored
    sharded, not replicated), and the resumed render is sample-exact. (This
    graph over the mesh is held against the JAX package's mesh graph by
    test_mesh_graph_render_with_live_events_matches_unsharded, and an
    unsharded graph's checkpoint against the JAX package's by
    tests/test_torch_log_inspect_checkpoint.py::
    test_checkpoint_resume_matches_jax.)"""
    path = str(tmp_path / "ck.pkl")
    g, proc, h = _runtime_graph(kt, True)
    for v in range(16):
        h.voice_param("t_restart").trig(v)
    proc.render(frames=640)
    proc.save_state(path)
    after = proc.render(frames=640)
    g2, proc2, h2 = _runtime_graph(kt, True)
    proc2.load_state(path)
    node = g2._node(h2.node_id).ugen
    st = proc2.state["nodes"][proc2.compiled._node_loc(h2.node_id)[1]]
    shards = node.shards(st)
    assert len(shards) == N_DEV and all(s["fvals"].shape == (3, 2) for s in shards)
    assert all(s["fvals"].device == d for s, d in zip(shards, node.mesh.devices))
    resumed = proc2.render(frames=640)
    np.testing.assert_allclose(resumed, after, rtol=0, atol=1e-6)
    assert np.abs(after).max() > 1e-4


def test_stream_backend_drives_mesh_graph():
    """tests/test_mesh_runtime.py:119: StreamBackend (async recompile, the
    ring) streams a mesh graph with live per-voice control: silence before
    the triggers, sound after. (As in the JAX test, a stream's timing is
    the host's, so its samples are not compared; the graph it streams is
    held against the JAX package's mesh graph by
    test_mesh_graph_render_with_live_events_matches_unsharded.)"""
    g, proc, h = _runtime_graph(kt, True)
    captured = []
    be = kt.StreamBackend(SR, B, chunk_blocks=4, lookahead_blocks=16,
                          consumer=lambda blk: captured.append(blk.copy()))
    be.start_processing(proc)
    try:
        time.sleep(0.3)
        n_before = len(captured)
        for v in range(16):
            h.voice_param("t_restart").trig(v)
        time.sleep(0.6)
        for v in range(0, 16, 2):
            h.voice_param("freq").set(v, 330.0)
        time.sleep(0.3)
    finally:
        be.stop()
    data = np.concatenate(captured, axis=1)
    assert data.shape[0] == 2
    assert n_before > 0 and np.abs(np.concatenate(captured[:n_before], axis=1)).max() == 0
    assert np.abs(data).max() > 1e-4


# --------------------------------------------------------------------------
# tools/mesh_voice_cluster.py
# --------------------------------------------------------------------------

def test_mesh_voice_cluster_matches_the_jax_example():
    """tools/mesh_voice_cluster.py's graph and score over 8 shards against
    examples/mesh_voice_cluster.py's graph built over the JAX package, two
    chords long: the chords CLUSTER_SPACING apart and both processors
    rendering block by block (the example's 1 s apart, superblocked, costs
    the JAX side a compile of every superblock length in it; the JAX
    blocks each waited for, ``_synchronous``)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
    import mesh_voice_cluster as mvc

    V = mvc.VOICES_PER_DEVICE * N_DEV
    renders = {}
    for m in (jk, kt):
        bank, detune = mvc.make_bank(m, V)
        kw = {} if m is jk else {"device": "cpu"}
        g, proc = m.AudioProcessor.new(0, 2, m.AudioProcessorOptions(
            render_chunk_blocks=1, **OPTS), **kw)
        h, filt = g.edit(lambda gg: mvc.build(m, gg, m.MeshVoiceBank(bank, _mesh(m))))
        seconds = mvc.schedule(m, h, detune, mvc.VOICES_PER_DEVICE, mvc.CHORDS[:2],
                               CLUSTER_SPACING)
        assert seconds == 2 * CLUSTER_SPACING
        assert filt.param_hints()["cutoff_freq"].maximum == SR / 2
        if m is jk:
            _synchronous(proc)
        renders[m] = proc.render(seconds=seconds)
    assert renders[kt].shape == (2, round(2 * CLUSTER_SPACING * SR))
    assert np.abs(renders[jk]).max() > 1e-2
    np.testing.assert_allclose(renders[kt], renders[jk], rtol=0, atol=2e-5)
