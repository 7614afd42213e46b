"""The noise UGens of the port against the JAX package: jax.random's
Threefry-2x32 restated in torch, WhiteNoise, PinkNoise, BrownNoise,
RandomLin, and WhiteNoise on the chain kernel's plain path.

- The Threefry words, ``fold_in``, ``uniform`` (f32 and f64) and ``split``
  are bit-exact against ``jax.random`` at seeds 0, 17, 2^31 and 2^32 - 1
  and at frames across the 2^32 wrap. The port restates the
  *partitionable* path only; a test asserts JAX's flag, so that a change
  of JAX's default fails by name.
- WhiteNoise is bit-exact over blocks at B in {16, 64}, f32 and f64, from
  a frame just below the wrap; so is the chain body's plain version at
  edge states (seed 2^32 - 1, frames within 2^10 of 2^32).
- PinkNoise and BrownNoise share that stream and add float sums: within
  ``TOL`` = 1e-6 of unit-amplitude outputs (measured 0 for both: PinkNoise
  sums in ``cumsum_base16``, XLA's CPU cumsum, and divides as XLA does, by
  the reciprocal; BrownNoise's clamped sum is sequential in both).
  RandomLin's per-sample wrap logic is sequential too: within ``TOL``.
- The noise chain (12 WhiteNoise + OnePoleLpf units), and the WhiteNoise
  twins of the port's one-pole and Pan2 chains, through
  ``chain_kernel_plain`` (``_MODE = "1"``) against the port's scan executor
  bit for bit, and against the JAX package's interpret-mode kernel within
  ``TOL`` (its one-pole scans associate otherwise, its renderer fuses
  multiply-adds and XLA's sin and cos differ from torch's by an ulp;
  measured 3.0e-8 on the noise chain, 2.5e-7 on the one-poles, 7.2e-7 on
  the Pan2 chain of peak 2.7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.chain_kernel as jck
import knaster_tpu.graph.compile as jC
import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.compile as tC
import knaster_tpu_torch.graph.chain_kernel as tck
from knaster_tpu_torch.kernels import chain_kernel as kck
from knaster_tpu_torch.kernels.bank_common import i32_of
from knaster_tpu_torch.ugens import noise as tn

SR = 48000
TOL = 1e-6
NO_FMA = {"xla_backend_optimization_level": 0}
SEEDS = [0, 17, 2**31, 2**32 - 1]
FRAMES = [0, 5, 2**31 - 1, 2**32 - 3, 2**32 - 1]


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    tC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


def test_threefry_partitionable_flag():
    """The port restates jax.random's partitionable path (counters (0, i),
    32-bit draws as b0 ^ b1); this JAX release takes it by default."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_match_jax(seed):
    key = jax.random.PRNGKey(jnp.uint32(seed))
    tkey = tn.prng_key(torch.tensor(seed))
    assert [int(x) for x in np.asarray(key)] == [0, seed]
    for frame in FRAMES:
        fk = jax.random.fold_in(key, jnp.uint32(frame))
        tk = tn.fold_in(tkey, torch.tensor(frame))
        assert [int(x) for x in np.asarray(fk)] == [int(tk[0]), int(tk[1])], frame
        for dt, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
            with jax.enable_x64(dt == np.float64):
                want = np.asarray(jax.random.uniform(fk, (3,), dtype=dt))
            assert want.dtype == dt
            np.testing.assert_array_equal(tn.uniform(tk, 3, tdt).numpy(), want)
    split = np.asarray(jax.random.split(key)).astype(np.int64).tolist()
    assert split == [[int(a), int(b)] for a, b in tn.split((0, seed))]


def white_blocks(B, dtype, seed, frame0, n=3):
    """``n`` blocks of WhiteNoise from ``frame0`` through both packages:
    [(jax out, jax frame, port out, port frame)]."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    ju, tu = jk.WhiteNoise(seed=seed), kt.WhiteNoise(seed=seed)
    jctx, tctx = jk.AudioCtx(SR, B, dtype), kt.AudioCtx(SR, B, tdt)
    res = []
    with jax.enable_x64(dtype == np.float64):
        js = {**ju.init(jctx), "frame": jnp.uint32(frame0)}
        fn = jax.jit(lambda s: ju.process(jctx, s, None, {}))
        ts = {**tu.init(tctx), "frame": i32_of(torch.tensor(frame0))}
        for _ in range(n):
            js, jo = fn(js)
            ts, to = tu.process(tctx, ts, None, {})
            res.append((np.asarray(jo), int(js["frame"]), to.numpy(),
                        int(ts["frame"]) & 0xFFFFFFFF))
    return res


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [16, 64])
def test_white_noise_bit_exact(B, dtype):
    """Three blocks from a frame just below the 2^32 wrap: samples and
    frames bit-exact."""
    res = white_blocks(B, dtype, 2**32 - 1, 2**32 - B - 3)
    for jo, jf, to, tf in res:
        assert to.dtype == dtype
        np.testing.assert_array_equal(to, jo)
        assert tf == jf
    assert res[-1][3] == 2 * B - 3  # the frame wrapped
    assert np.abs(res[0][0]).max() > 0.5


def test_white_noise_body_bit_exact_at_edges():
    """The chain body's plain version at seeds 2^32 - 1 and 17, frames
    within 2^10 of 2^32 and at 0: the JAX package's WhiteNoise samples, and
    the frame B on."""
    body = kck.BODIES["white_noise"]
    B = 64
    for seed, frame0 in ((2**32 - 1, 2**32 - 1000), (17, 0), (2**31, 2**32 - 1)):
        (jo, jf, _, _), = white_blocks(B, np.float32, seed, frame0, n=1)
        words = torch.tensor([frame0, seed], dtype=torch.int64)
        outs, new = body.plain(0, [], [], words, (0.0, 0.0, float(SR), B))
        np.testing.assert_array_equal(outs[0].numpy(), jo[0])
        assert [int(w) for w in new] == [jf, seed]


def run_noise(name, B, blocks, dtype=np.float32, **kw):
    """``blocks`` blocks of one noise UGen through both packages
    (jitted without FMA on the JAX side); returns [(jax state, jax out,
    port state, port out)]."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    ju, tu = getattr(jk, name)(seed=5, **kw), getattr(kt, name)(seed=5, **kw)
    jctx, tctx = jk.AudioCtx(SR, B, dtype), kt.AudioCtx(SR, B, tdt)
    rng = np.random.default_rng(B)
    res = []
    with jax.enable_x64(dtype == np.float64):
        js, ts = ju.init(jctx), tu.init(tctx)
        fn = jax.jit(lambda s, p: ju.process(jctx, s, None, p), compiler_options=NO_FMA)
        for _ in range(blocks):
            p = {}
            if name == "RandomLin":
                p["freq"] = rng.uniform(100.0, 6000.0, B).astype(dtype)
            js, jo = fn(js, {k: jnp.asarray(v) for k, v in p.items()})
            ts, to = tu.process(tctx, ts, None, {k: torch.from_numpy(v) for k, v in p.items()})
            res.append((jax.tree_util.tree_map(np.asarray, js), np.asarray(jo),
                        {k: v.numpy() for k, v in ts.items()}, to.numpy()))
    return res


@pytest.mark.parametrize("name", ["PinkNoise", "BrownNoise", "RandomLin"])
def test_noise_ugens_match_jax(name):
    """Four blocks of 64 (RandomLin at audio-rate frequencies, so it wraps
    many times a block): outputs and float state within TOL, counters
    exact."""
    res = run_noise(name, 64, 4)
    for n, (js, jo, ts, to) in enumerate(res):
        np.testing.assert_allclose(to, jo, rtol=0, atol=TOL, err_msg=f"block {n}")
        for k, v in js.items():
            if v.dtype in (np.uint32, np.int32):
                np.testing.assert_array_equal(ts[k].astype(np.int64) & 0xFFFFFFFF,
                                              v.astype(np.int64) & 0xFFFFFFFF, err_msg=k)
            else:
                np.testing.assert_allclose(ts[k], v, rtol=0, atol=TOL, err_msg=k)
    assert max(np.abs(r[1]).max() for r in res) > 0.05


def test_randomlin_init_from_split():
    """RandomLin's first two targets come from jax.random.split: exact."""
    for seed in SEEDS:
        js = jk.RandomLin(seed=seed).init(jk.AudioCtx(SR, 16, np.float32))
        ts = kt.RandomLin(seed=seed).init(kt.AudioCtx(SR, 16, torch.float32))
        for k in ("current", "width"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_seed_counter_in_construction_order():
    """Unseeded noise draws seeds from the port's own counter, in
    construction order, as the JAX package's does."""
    kt.reset_randomness_seeds()
    jk_seeds = []
    from knaster_tpu.ugens.noise import reset_randomness_seeds

    reset_randomness_seeds()
    for cls in ("WhiteNoise", "PinkNoise", "BrownNoise"):
        jk_seeds.append(getattr(jk, cls)().seed)
    t_seeds = [getattr(kt, cls)().seed for cls in ("WhiteNoise", "PinkNoise", "BrownNoise")]
    assert t_seeds == jk_seeds == [0, 1, 2]
    assert kt.Galactic().seed == 3 and kt.next_randomness_seed() == 4


# --------------------------------------------------------------------------
# chains
# --------------------------------------------------------------------------

def noise_chain(m, gg):
    """tests/test_chain_kernel.py:570-597."""
    prev = None
    for i in range(12):
        n = gg.push(m.WhiteNoise(seed=100 + i))
        lp = gg.push(m.OnePoleLpf(2000.0 + 100.0 * i))
        (n if prev is None else prev + n).to(lp)
        prev = lp
    (prev * 0.2).to_graph_out()


def noise_onepole_chain(m, gg):
    """tests/test_chain_kernel.py:142: a WhiteNoise into 16 one-poles
    alternating Lpf / Hpf, then an Hpf."""
    node = gg.push(m.WhiteNoise(seed=7))
    for i in range(16):
        f = gg.push(m.OnePoleLpf(8000.0 + 100.0 * i) if i % 2 == 0
                    else m.OnePoleHpf(40.0 + 5.0 * i))
        node.to(f)
        node = f
    hp = gg.push(m.OnePoleHpf(50.0))
    node.to(hp)
    hp.to_graph_out()


def noise_pan2_chain(m, gg):
    """tests/test_chain_kernel.py:431: ten Pan2 stages from a WhiteNoise."""
    prev = gg.push(m.WhiteNoise(seed=3))
    for i in range(10):
        p = gg.push(m.Pan2(-0.4 + 0.08 * i))
        prev.to(p)
        prev = p.out([0]) + p.out([1])
    (prev * 0.1).to_graph_out()


def render(m, mode, build, monkeypatch, bs, frames):
    if m is jk:
        monkeypatch.setattr(jck, "_MODE", mode)
        jC.clear_program_cache()
        g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=bs))
    else:
        monkeypatch.setattr(tck, "_MODE", mode)
        g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=bs),
                                       device="cpu")
    g.edit(lambda gg: build(m, gg))
    return np.asarray(proc.render(frames=frames)), proc


CHAINS = {"noise": (noise_chain, 32, "white_noise"),
          "noise_onepole": (noise_onepole_chain, 32, "onepole_lpf"),
          "noise_pan2": (noise_pan2_chain, 16, "pan2")}


@pytest.mark.parametrize("name", list(CHAINS))
def test_noise_chains_match_scan_and_jax_kernel(name, monkeypatch):
    """The chain's kernel path (plain version) equals the port's scan
    executor bit for bit and the JAX package's interpret-mode kernel within
    TOL; every event-free piece ran the kernel path."""
    build, bs, body = CHAINS[name]
    calls = {"run": 0, "ok": 0}
    real = tck.run

    def spy(*a, **k):
        calls["run"] += 1
        r = real(*a, **k)
        calls["ok"] += r is not None
        return r

    monkeypatch.setattr(tck, "run", spy)
    a, proc = render(kt, "1", build, monkeypatch, bs, 96)
    plan = [k for k, _ in proc.compiled.plan]
    assert plan.count("chain") == 1
    assert calls["ok"] >= 1 and calls["ok"] == calls["run"]
    cp = next(item for kind, item in proc.compiled.plan if kind == "chain")
    assert body in [r[0].name for r in cp.lowered["cpu"][0].records()]
    b, _ = render(kt, "0", build, monkeypatch, bs, 96)
    np.testing.assert_array_equal(a, b)
    j, jproc = render(jk, "1", build, monkeypatch, bs, 96)
    assert [k for k, _ in jproc.compiled.plan] == plan
    np.testing.assert_allclose(a, j, rtol=0, atol=TOL)
    assert np.abs(a).max() > 1e-3
