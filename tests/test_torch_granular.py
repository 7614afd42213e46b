"""``GrainPlayer`` in the port, against the JAX package.

- Ports of tests/test_granular.py:107-434: the jitter-free numpy model
  (windows, rates), block-partition invariance with jitter, seed
  determinism, the sample-accurate ``t_spawn``, loop wrap against silence,
  slot stealing, scheduled spawns in a graph, the live amp, and players
  that auto-batch in a graph and equal the sum of the players alone. The
  JAX tests that hold its one-hot-matmul event routing and its windowed
  ``max_rate`` read bit-identical to the gathers become port-against-JAX
  cases here: the port gathers, and meets the JAX package's routed and
  windowed paths (``max_rate`` set, its clamp active and inert, loop and
  one-shot, reverse rates, a second channel).
- ``process`` block by block against the JAX package's (jitted at XLA's
  level 0 with its algebraic simplifier off, ``EXACT``, as
  tests/test_torch_envelope_modal_bank.py:39 does) at f32 and f64, the
  carried state bit-equal (the u32 seed and counter as int32 bits) but for
  the per-grain step and pan gains (``EXP_ULPS``), the output within
  ``OUT_TOL``: the G-slot sum is taken in another order by torch and by
  XLA.
- ``granular`` and ``granular_bank`` (benchmarks/suite.py:884-960) at a
  small size in a graph, against the JAX graph (``GRAPH_TOL``: the JAX
  block program is jitted at XLA's default level, which contracts the
  multiply-adds ``src0 + age * step`` and ``pos + jitter * u``), and the
  superblocked render against the per-block one, bit-equal.
- ``convert.graph_state_from_jax`` carries a player's state: the JAX
  state, converted, renders in the port as the JAX package goes on
  rendering.
"""

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu.core.ugen import AudioCtx as JCtx
from knaster_tpu_torch.convert import graph_state_from_jax, graph_state_to_numpy

SR = 48000
TDT = {np.float32: torch.float32, np.float64: torch.float64}
OUT_TOL = {np.float32: 1e-6, np.float64: 1e-12}
GRAPH_TOL = {np.float32: 1e-6, np.float64: 1e-12}
EXP_ULPS = 2
EXACT = {"xla_backend_optimization_level": 0, "xla_disable_hlo_passes": "algsimp"}


def _buffer(m=kt, n=4800, sr=SR, channels=1):
    t = np.arange(n, dtype=np.float32)
    data = np.stack([np.sin(2 * np.pi * (220.0 + 110 * c) * t / sr) * 0.5
                     for c in range(channels)]).astype(np.float32)
    return m.Buffer(data, sr)


def _params(player, B, b, overrides=None, tspawn_frames=(), dtype=np.float32):
    """Block b's params as numpy rows: the defaults, ``overrides``, spawns."""
    values = {p.name: player.pdefaults.get(p.name, p.default) for p in player.params}
    values.update(overrides or {})
    out = {}
    for p in player.params:
        if p.name == "t_spawn":
            row = np.zeros(B, dtype=bool)
            for f in tspawn_frames:
                if b <= f < b + B:
                    row[f - b] = True
            out[p.name] = row
        else:
            out[p.name] = np.full(B, values[p.name], dtype)
    return out


def _render(player, n, B=64, overrides=None, tspawn_frames=(), dtype=np.float32):
    """The port's player driven block by block: ``[2, n]``."""
    ctx = kt.AudioCtx(SR, B, TDT[dtype])
    state = player.init(ctx)
    blocks = []
    for b in range(0, n, B):
        p = _params(player, B, b, overrides, tspawn_frames, dtype)
        state, out = player.process(ctx, state, torch.zeros((0, B), dtype=TDT[dtype]),
                                    {k: torch.from_numpy(v) for k, v in p.items()})
        blocks.append(out.numpy())
    return np.concatenate(blocks, axis=1)[:, :n]


def _numpy_model(buf, n, G, density, grain_dur, rate, pos, amp=1.0, window="hann",
                 loop=True, tspawn_frames=(), sr=SR):
    """tests/test_granular.py:42: the jitter-free scheduler and readers."""
    period = sr / np.clip(density, 0.01, sr)
    dur = max(grain_dur * sr, 1.0)
    src_base, step = pos * buf.sample_rate, rate * buf.sample_rate / sr
    data = buf.data[0].astype(np.float64)
    nf = len(data)
    countdown, counter = 0.0, 0
    age, gdur = np.zeros(G), np.zeros(G)
    out = np.zeros(n)
    for i in range(n):
        countdown -= 1.0
        forced = i in tspawn_frames
        if countdown <= 0.0 or forced:
            countdown = period if forced else countdown + period
            slot = counter % G
            age += 1
            age[slot] = 0
            gdur[slot] = dur
            counter += 1
        else:
            age += 1
        active = (age < gdur) & (gdur > 0)
        ph = np.where(gdur > 0, age / np.maximum(gdur, 1e-9), 0.0)
        w = {"hann": 0.5 - 0.5 * np.cos(2 * np.pi * ph),
             "triangle": 1.0 - np.abs(2 * ph - 1.0), "rect": np.ones_like(ph)}[window]
        src = src_base + age * step
        idx = np.floor(src).astype(int)
        frac = src - idx
        if loop:
            i0, i1, valid = idx % nf, (idx + 1) % nf, active
        else:
            i0, i1 = np.clip(idx, 0, nf - 1), np.clip(idx + 1, 0, nf - 1)
            valid = active & (idx >= 0) & (idx < nf - 1)
        s = data[i0] * (1 - frac) + data[i1] * frac
        out[i] = np.where(valid, w * s, 0.0).sum() * np.cos(np.pi / 4) * amp
    return np.stack([out, out])


def test_matches_numpy_model_jitter_free():
    buf = _buffer()
    player = kt.GrainPlayer(buf, grains=8, density=40.0, grain_dur=0.02, rate=1.0,
                            pos=0.01, pos_jitter=0.0, rate_jitter=0.0, pan_spread=0.0)
    got = _render(player, 2048)
    want = _numpy_model(buf, 2048, 8, density=40.0, grain_dur=0.02, rate=1.0, pos=0.01)
    assert np.max(np.abs(got - want)) < 1e-4
    assert np.max(np.abs(got)) > 1e-3


@pytest.mark.parametrize("window", ["triangle", "rect"])
@pytest.mark.parametrize("rate", [0.5, 2.0])
def test_rate_and_window_variants(window, rate):
    buf = _buffer()
    player = kt.GrainPlayer(buf, grains=4, density=25.0, grain_dur=0.015, rate=rate,
                            pos=0.02, pos_jitter=0.0, rate_jitter=0.0, pan_spread=0.0,
                            window=window)
    want = _numpy_model(buf, 1024, 4, density=25.0, grain_dur=0.015, rate=rate, pos=0.02,
                        window=window)
    assert np.max(np.abs(_render(player, 1024) - want)) < 1e-4


def test_block_partition_invariance_with_jitter():
    buf = _buffer()
    outs = [_render(kt.GrainPlayer(buf, grains=16, density=200.0, grain_dur=0.01,
                                   pos_jitter=0.005, rate_jitter=1.0, pan_spread=1.0,
                                   seed=7), 512, B=B)
            for B in (16, 128)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_seed_determinism():
    buf = _buffer()

    def mk(s):
        return kt.GrainPlayer(buf, grains=8, density=100.0, grain_dur=0.01,
                              pos_jitter=0.01, pan_spread=1.0, seed=s)

    a, b, c = _render(mk(3), 512), _render(mk(3), 512), _render(mk(4), 512)
    np.testing.assert_array_equal(a, b)
    assert np.max(np.abs(a - c)) > 1e-6


def test_t_spawn_sample_accurate():
    buf = _buffer()
    player = kt.GrainPlayer(buf, grains=4, density=0.01, grain_dur=0.002, pos=0.01,
                            pos_jitter=0.0, rate_jitter=0.0, pan_spread=0.0)
    got = _render(player, 400, tspawn_frames=(100,))
    want = _numpy_model(buf, 400, 4, density=0.01, grain_dur=0.002, rate=1.0, pos=0.01,
                        tspawn_frames=(100,))
    assert np.max(np.abs(got - want)) < 1e-4
    grain = int(0.002 * SR)
    assert np.max(np.abs(got[:, grain + 1:100])) == 0.0
    assert np.max(np.abs(got[:, 101:101 + grain - 1])) > 0.0


def test_loop_wrap_vs_silence():
    buf = _buffer(n=1000)
    common = dict(grains=2, density=0.01, grain_dur=0.004, rate=1.0,
                  pos=1000 / SR - 0.001, pos_jitter=0.0, rate_jitter=0.0, pan_spread=0.0)
    looped = _render(kt.GrainPlayer(buf, loop=True, **common), 256)
    clipped = _render(kt.GrainPlayer(buf, loop=False, **common), 256)
    assert np.max(np.abs(looped[:, 60:150])) > 0.0
    assert np.max(np.abs(clipped[:, 60:150])) == 0.0


def test_slot_reuse_steals_oldest():
    player = kt.GrainPlayer(_buffer(), grains=2, density=480.0, grain_dur=0.01,
                            pos_jitter=0.0, rate_jitter=0.0, pan_spread=0.0)
    out = _render(player, 2048)
    assert np.all(np.isfinite(out)) and np.max(np.abs(out[:, 1024:])) > 1e-4


def test_amp_is_live_not_frozen():
    kw = dict(grains=4, density=50.0, grain_dur=0.02, pos_jitter=0.0, rate_jitter=0.0,
              pan_spread=0.0)
    a = _render(kt.GrainPlayer(_buffer(), **kw), 512)
    b = _render(kt.GrainPlayer(_buffer(), **kw), 512, overrides={"amp": 0.25})
    np.testing.assert_allclose(b, a * 0.25, atol=1e-6)


def test_rejects_bad_configs():
    buf = _buffer()
    for kw in (dict(window="gauss"), dict(grains=0), dict(channel=1), dict(max_rate=9.0)):
        with pytest.raises(ValueError):
            kt.GrainPlayer(buf, **kw)


def test_in_graph_with_scheduled_events():
    graph, proc = kt.knaster(outputs=2, block_size=64, device="cpu")

    def build(g):
        gp = g.push(kt.GrainPlayer(_buffer(), grains=8, density=0.01, grain_dur=0.002,
                                   pos_jitter=0.0, pan_spread=0.0))
        gp.to_graph_out()
        return gp

    gp = graph.edit(build)
    gp.param("t_spawn").trig_at(kt.Seconds.from_samples(200, SR))
    audio = proc.render(frames=512)
    grain = int(0.002 * SR)
    assert audio.shape == (2, 512)
    assert np.max(np.abs(audio[:, grain + 1:200])) == 0.0
    assert np.max(np.abs(audio[:, 201:201 + grain - 1])) > 0.0


# ----------------------------------------------------- against the JAX package
PARITY = {
    "jitter": dict(grains=16, seed=7, density=400.0, grain_dur=0.01, pos=0.02,
                   pos_jitter=0.005, rate_jitter=1.0, pan_spread=1.0, amp=0.3),
    # the JAX package's windowed read and its clamp: inert, then active
    "max_rate": dict(grains=64, seed=3, density=300.0, grain_dur=0.03, pos=0.02,
                     pos_jitter=0.05, rate=1.0, rate_jitter=0.5, amp=0.3, max_rate=4.0),
    "clamped": dict(grains=32, seed=9, density=500.0, grain_dur=0.02, rate=3.0,
                    rate_jitter=1.0, max_rate=1.5, amp=0.2),
    "reverse_oneshot": dict(grains=64, seed=3, density=300.0, grain_dur=0.03, pos=0.05,
                            pos_jitter=0.05, rate=-1.2, rate_jitter=0.5, amp=0.3,
                            loop=False, max_rate=4.0),
    "triangle_channel1": dict(grains=8, seed=11, density=900.0, grain_dur=0.004,
                              pos_jitter=0.01, rate_jitter=0.3, window="triangle",
                              channel=1, amp=0.5),
}


def _assert_state(ts, js, dtype, where):
    """The port's player state against the JAX one: bit-equal but for the
    frozen per-grain step and pan gains, which go through exp2, cos and
    sin, where XLA's f32 kernels and torch's part by an ulp on some inputs
    (``EXP_ULPS``)."""
    got = graph_state_to_numpy(ts, like=js)
    for k, v in js.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        if k in ("step", "gl", "gr"):
            np.testing.assert_allclose(got[k], v, rtol=EXP_ULPS * np.finfo(dtype).eps,
                                       atol=0, err_msg=f"state[{k}] {where}")
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=f"state[{k}] {where}")


def _lockstep(kw, dtype, n_blocks=6, B=64, spawns=(37, 200), density_wiggle=True):
    """The JAX player and the port's over the same blocks: output gap and
    carried state compared each block. Returns the port's last state."""
    with jax.enable_x64(dtype == np.float64):
        jp = jk.GrainPlayer(_buffer(jk, channels=2), **kw)
        tp = kt.GrainPlayer(_buffer(kt, channels=2), **kw)
        jctx, tctx = JCtx(SR, B, dtype), kt.AudioCtx(SR, B, TDT[dtype])
        js, ts = jp.init(jctx), tp.init(tctx)
        jprocess = jax.jit(lambda s, p: jp.process(jctx, s, np.zeros((0, B), dtype), p),
                           compiler_options=EXACT)
        peak = 0.0
        for b in range(n_blocks):
            p = _params(jp, B, b * B, tspawn_frames=spawns, dtype=dtype)
            if density_wiggle:  # spawn-time freezing of a moving density
                p["density"] = p["density"] * (1.0 + 0.3 * (b % 3))
            js, jo = jprocess(js, p)
            ts, to = tp.process(tctx, ts, torch.zeros((0, B), dtype=TDT[dtype]),
                                {k: torch.from_numpy(v) for k, v in p.items()})
            jo = np.asarray(jo)
            assert to.dtype == TDT[dtype]
            np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=OUT_TOL[dtype],
                                       err_msg=f"block {b}")
            _assert_state(ts, js, dtype, f"block {b}")
            peak = max(peak, float(np.abs(jo).max()))
        assert peak > 1e-4
        return ts


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(PARITY))
def test_process_matches_jax(case, dtype):
    _lockstep(PARITY[case], dtype)


def test_state_from_jax_continues_as_jax():
    """A JAX player's state after four blocks, converted, renders in the
    port as the JAX package renders on."""
    kw = PARITY["jitter"]
    B = 64
    jp = jk.GrainPlayer(_buffer(jk), **kw)
    tp = kt.GrainPlayer(_buffer(kt), **kw)
    jctx, tctx = JCtx(SR, B, np.float32), kt.AudioCtx(SR, B)
    jprocess = jax.jit(lambda s, p: jp.process(jctx, s, np.zeros((0, B), np.float32), p),
                       compiler_options=EXACT)
    js = jp.init(jctx)
    for b in range(4):
        js, _ = jprocess(js, _params(jp, B, b * B))
    ts = graph_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert ts["seed"].dtype == torch.int32 and ts["counter"].dtype == torch.int32
    for b in range(4, 7):
        p = _params(jp, B, b * B)
        js, jo = jprocess(js, p)
        ts, to = tp.process(tctx, ts, torch.zeros((0, B)),
                            {k: torch.from_numpy(v) for k, v in p.items()})
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=OUT_TOL[np.float32])
    assert graph_state_to_numpy(ts, like=js)["seed"].dtype == np.uint32
    _assert_state(ts, js, np.float32, "after the conversion")


# ------------------------------------------------------------ in a graph
TONE = np.sin(2 * np.pi * 220.0 / SR * np.arange(SR // 10)).astype(np.float32)[None, :]


def _grain_graph(m, dtype, players, chunk=None, frames=17 * 64):
    """benchmarks/suite.py:884-960 at a small size: ``players`` players of 16
    grains over one 0.1 s source (one player: the ``granular`` cell's
    settings; more: ``granular_bank``'s, densities from default_rng(7),
    max_rate 2.0), a spawn and a rate set on player 0 mid-block in block 0,
    then one 16-block superblock."""
    kw = {"device": "cpu", "dtype": TDT[dtype]} if m is kt else {"dtype": dtype}
    opts = m.AudioProcessorOptions(block_size=64, sample_rate=SR,
                                   **({"render_chunk_blocks": chunk} if chunk else {}))
    g, proc = m.AudioProcessor.new(0, 2, opts, **kw)
    src = m.Buffer(TONE, SR)
    rng = np.random.default_rng(7)

    def build(gg):
        hs = []
        for i in range(players):
            if players == 1:
                kw = dict(density=400.0, amp=0.2)
            else:
                kw = dict(seed=i, density=float(400.0 * 2 ** rng.uniform(-0.5, 0.5)),
                          max_rate=2.0, amp=0.2 / players)
            hs.append(gg.push(m.GrainPlayer(src, grains=16, grain_dur=0.08,
                                            pos_jitter=0.03, rate_jitter=0.5, **kw)))
            hs[-1].to_graph_out()
        return hs

    hs = g.edit(build)
    proc._ensure_compiled()
    batched = max((len(it) for k, it in proc.compiled.plan if k == "batch"), default=0)
    hs[0].param("t_spawn").trig_at(m.Seconds.from_samples(30, SR))
    hs[0].param("rate").set_at(1.7, m.Seconds.from_samples(45, SR))
    return np.asarray(proc.render(frames=frames)), batched


@pytest.mark.parametrize("players,dtype", [(1, np.float32), (4, np.float64)],
                         ids=["granular-f32", "granular_bank-f64"])
def test_graph_matches_jax_and_partitions(players, dtype):
    port, batched = _grain_graph(kt, dtype, players)
    with jax.enable_x64(dtype == np.float64):
        ref, jbatched = _grain_graph(jk, dtype, players)
    assert batched == jbatched == (players if players > 1 else 0)
    assert np.abs(ref).max() > 1e-4
    np.testing.assert_allclose(port, ref, rtol=0, atol=GRAPH_TOL[dtype])
    per_block, _ = _grain_graph(kt, dtype, players, chunk=1)
    np.testing.assert_array_equal(port, per_block)


def test_batched_players_match_singles():
    """tests/test_granular.py:300: four batched players equal the sum of
    each rendered alone, events included."""
    buf = _buffer()

    def build_graph(only=None):
        g, proc = kt.knaster(outputs=2, device="cpu")
        hs = []

        def b(gg):
            for i in range(4):
                if only is not None and i != only:
                    continue
                p = gg.push(kt.GrainPlayer(buf, grains=16, seed=i, density=40.0 + 10.0 * i,
                                           grain_dur=0.02, pos_jitter=0.02,
                                           rate=1.0 + 0.1 * i, amp=0.1))
                p.to_graph_out()
                hs.append(p)

        g.edit(b)
        return proc, hs

    def drive(proc, hs, spawn_idx):
        a1 = proc.render(frames=128)
        if spawn_idx is not None:
            hs[spawn_idx].param("t_spawn").trig()
            hs[spawn_idx].param("rate").set(1.7)
        return np.concatenate([a1, proc.render(frames=128)], axis=1)

    proc, hs = build_graph()
    proc._ensure_compiled()
    assert any(len(nids) == 4 for k, nids in proc.compiled.plan if k == "batch")
    a = drive(proc, hs, spawn_idx=2)
    parts = []
    for i in range(4):
        pi, hi = build_graph(only=i)
        parts.append(drive(pi, hi, spawn_idx=0 if i == 2 else None))
    assert np.abs(a).max() > 1e-4
    np.testing.assert_allclose(a, sum(parts), atol=2e-6)
