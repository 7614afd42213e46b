"""The delays of the port against the JAX package: SampleDelay,
AllpassDelay, AllpassFeedbackDelay (both paths), StaticSampleDelay, and
SampleDelay on the chain kernel's plain path.

- SampleDelay's ring reads are indexed loads into the block's history, so
  it is bit-exact against the JAX package's per-sample scan: delay 0 (the
  input passes), delay L - 1, delays beyond L (clamped), rings shorter and
  longer than the block, a per-sample delay ramp, and a ring written up to
  its last slot (pos = L - 1); the chain body's plain version too, at those
  states.
- The allpass delays' per-sample paths are bit-exact (the JAX side jitted
  without fused multiply-adds). Their ``long=True`` paths run the
  interpolator as an affine scan, which the port associates by
  Hillis-Steele doubling and the JAX package by ``associative_scan``'s
  tree: within ``TOL`` = 1e-6 (measured 1.2e-7).
- StaticSampleDelay's block delay and its linear read, bit-exact.
- The echo chain (WhiteNoise into ten SampleDelay * 0.8 stages, per-stage
  delays and one smoothed one, tests/test_chain_kernel.py:455) through
  ``chain_kernel_plain`` (``_MODE = "1"``): bit-equal to the port's scan
  executor and to the JAX package's render in both of its modes.
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

SR = 48000
TOL = 1e-6
NO_FMA = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    tC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


def _to_torch(tree):
    out = {}
    for k, v in tree.items():
        v = np.array(v)
        out[k] = torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
    return out


def run_delay(jax_ugen, port_ugen, B, blocks, state0=None):
    """Blocks of (input [1, B], params) through both packages' ``process``
    with carried state (the JAX side jitted without fused multiply-adds);
    returns [(jax state, jax out, port state, port out)] as numpy."""
    jctx = jk.AudioCtx(SR, B, np.float32)
    tctx = kt.AudioCtx(SR, B, torch.float32)
    js, ts = jax_ugen.init(jctx), port_ugen.init(tctx)
    if state0 is not None:
        js = {**js, **{k: jnp.asarray(v) for k, v in state0.items()}}
        ts = {**ts, **_to_torch(state0)}
    fn = jax.jit(lambda s, x, p: jax_ugen.process(jctx, s, x, p)[:2], compiler_options=NO_FMA)
    res = []
    for x, p in blocks:
        js, jo = fn(js, jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
        ts, to = port_ugen.process(tctx, ts, torch.from_numpy(x),
                                   {k: torch.from_numpy(v) for k, v in p.items()})
        res.append(({k: np.asarray(v) for k, v in js.items()}, np.asarray(jo),
                    {k: v.numpy() for k, v in ts.items()}, to.numpy()))
    return res


def delay_rows(rng, L, B, case):
    """A block's delay_time row in seconds."""
    if case == "zero":
        d = np.zeros(B)
    elif case == "max":
        d = np.full(B, L - 0.5)
    elif case == "beyond":
        d = np.full(B, L + 5.0)
    elif case == "ramp":
        d = np.linspace(0.0, L - 0.5, B)
    else:
        d = rng.uniform(0.0, L, B)
    return (d / SR).astype(np.float32)


SAMPLE_DELAY_CASES = [
    ("zero", 32, 16), ("max", 32, 16), ("max", 16, 64), ("beyond", 40, 64),
    ("ramp", 32, 16), ("ramp", 16, 64), ("random", 100, 64), ("random", 7, 64),
]


@pytest.mark.parametrize("case,L,B", SAMPLE_DELAY_CASES)
def test_sample_delay_matches_jax(case, L, B):
    """Four blocks from a ring of random samples written up to its last
    slot: outputs and state bit-exact."""
    rng = np.random.default_rng(L * B)
    state0 = {"buf": rng.uniform(-1, 1, L).astype(np.float32), "pos": np.int32(L - 1)}
    blocks = [(rng.uniform(-1, 1, (1, B)).astype(np.float32),
               {"delay_time": delay_rows(rng, L, B, case)}) for _ in range(4)]
    res = run_delay(jk.SampleDelay(L / SR), kt.SampleDelay(L / SR), B, blocks, state0)
    for n, (js, jo, ts, to) in enumerate(res):
        np.testing.assert_array_equal(to, jo, err_msg=f"block {n}")
        np.testing.assert_array_equal(ts["buf"], js["buf"])
        assert int(ts["pos"]) == int(js["pos"])
    if case == "zero":
        np.testing.assert_array_equal(res[0][3], blocks[0][0])  # passes through


@pytest.mark.parametrize("case,L,B", SAMPLE_DELAY_CASES)
def test_sample_delay_body_matches_jax(case, L, B):
    """The chain body's plain version on one stage's state words: the JAX
    package's SampleDelay, outputs and every word (the ring, then pos)."""
    rng = np.random.default_rng(L + B)
    buf = rng.uniform(-1, 1, L).astype(np.float32)
    x = rng.uniform(-1, 1, (1, B)).astype(np.float32)
    dt = delay_rows(rng, L, B, case)
    (js, jo, _, _), = run_delay(jk.SampleDelay(L / SR), kt.SampleDelay(L / SR), B,
                                [(x, {"delay_time": dt})],
                                {"buf": buf, "pos": np.int32(L - 1)})
    words = torch.from_numpy(np.concatenate([buf.view(np.int32).astype(np.int64)
                                             & 0xFFFFFFFF, [L - 1]]))
    body = kck.BODIES["sample_delay"]
    assert body.words(L) == L + 1
    outs, new = body.plain(L, [torch.from_numpy(x[0])], [torch.from_numpy(dt)], words,
                           (0.0, 0.0, float(SR), B))
    np.testing.assert_array_equal(outs[0].numpy(), jo[0])
    new = torch.cat([w.reshape(-1) for w in new])
    np.testing.assert_array_equal(new[:L].numpy().astype(np.uint32).view(np.float32), js["buf"])
    assert int(new[L]) == int(js["pos"])


ALLPASS_CASES = [(cls, long, case, L, B)
                 for cls in ("AllpassDelay", "AllpassFeedbackDelay")
                 for long in (False, True)
                 for case, L, B in (("random", 100, 16), ("random", 80, 64),
                                    ("random", 40, 64), ("zero", 100, 16), ("max", 80, 64),
                                    ("ramp", 40, 64))]


@pytest.mark.parametrize("cls,long,case,L,B", ALLPASS_CASES)
def test_allpass_delays_match_jax(cls, long, case, L, B):
    """Four blocks of delays (random, 0, L - 1 or a ramp to it) and
    feedback, the ring longer and shorter than the block: the per-sample
    path bit-exact, the long path (taken where L >= B) within TOL."""
    rng = np.random.default_rng(L * B + long)
    blocks = []
    for _ in range(4):
        p = {"delay_time": delay_rows(rng, L, B, case)}
        if cls == "AllpassFeedbackDelay":
            p["feedback"] = rng.uniform(-0.7, 0.7, B).astype(np.float32)
        blocks.append((rng.uniform(-1, 1, (1, B)).astype(np.float32), p))
    res = run_delay(getattr(jk, cls)(L / SR, long=long), getattr(kt, cls)(L / SR, long=long),
                    B, blocks)
    exact = not (long and L >= B)
    for n, (js, jo, ts, to) in enumerate(res):
        for name, a, b in [("out", to, jo)] + [(k, ts[k], js[k]) for k in js]:
            if exact or a.dtype == np.int32:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} block {n}")
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=f"{name} block {n}")
    if case != "zero":  # 0 reads the sample written L steps before, 0 here
        assert max(np.abs(r[1]).max() for r in res) > 0.1


def test_long_delays_declare_their_superblock_cap():
    """``long`` delays are not block-length invariant; a declared minimum
    delay becomes the superblock cap, set in ``init``, as in the JAX
    package."""
    for cls in ("AllpassDelay", "AllpassFeedbackDelay"):
        for kw in ({}, {"long": True}, {"long": True, "min_delay_time": 0.01}):
            ju, tu = getattr(jk, cls)(0.02, **kw), getattr(kt, cls)(0.02, **kw)
            ju.init(jk.AudioCtx(SR, 64, np.float32))
            tu.init(kt.AudioCtx(SR, 64, torch.float32))
            assert tu.block_invariant == ju.block_invariant == (not kw.get("long", False))
            assert tu.superblock_cap == getattr(ju, "superblock_cap", None)
            assert (tu.superblock_cap == 480) == ("min_delay_time" in kw)


@pytest.mark.parametrize("L,B", [(100, 64), (64, 64), (20, 64)])
def test_static_sample_delay_matches_jax(L, B):
    """The block delay, the ring longer, as long as and shorter than the
    block, and the linear read at fractional indices: bit-exact."""
    rng = np.random.default_rng(L)
    jd, td = jk.StaticSampleDelay(L), kt.StaticSampleDelay(L)
    js, ts = jd.make_state(np.float32), td.make_state(torch.float32)
    for _ in range(3):
        x = rng.uniform(-1, 1, B).astype(np.float32)
        js, jo = jd.process_block(js, jnp.asarray(x))
        ts, to = td.process_block(ts, torch.from_numpy(x))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ts["buf"].numpy(), np.asarray(js["buf"]))
        assert int(ts["pos"]) == int(js["pos"])
    idx = rng.uniform(-3.0, 3.0 * L, 17).astype(np.float32)
    np.testing.assert_array_equal(td.read_at_lin(ts, torch.from_numpy(idx)).numpy(),
                                  np.asarray(jd.read_at_lin(js, jnp.asarray(idx))))
    with pytest.raises(ValueError):
        kt.StaticSampleDelay(0)


# --------------------------------------------------------------------------
# the echo chain on the chain kernel's plain path
# --------------------------------------------------------------------------

def echo_chain(m, gg, hs):
    """tests/test_chain_kernel.py:455-483."""
    prev = gg.push(m.WhiteNoise(seed=9))
    for _ in range(10):
        d = gg.push(m.SampleDelay(32.0 / SR))
        prev.to(d)
        prev = d * 0.8
        hs.append(d)
    (prev * 0.5).to_graph_out()


def echo_edits(hs):
    for i, h in enumerate(hs):
        h.param("delay_time").set((3.0 + 2.0 * i) / SR)
    hs[4].param("delay_time").smooth(20.0 / SR, 0.004)


def render_echo(m, mode, monkeypatch):
    if m is jk:
        monkeypatch.setattr(jck, "_MODE", mode)
        jC.clear_program_cache()
        g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=16))
    else:
        monkeypatch.setattr(tck, "_MODE", mode)
        g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=16),
                                       device="cpu")
    hs = []
    g.edit(lambda gg: echo_chain(m, gg, hs))
    first = np.asarray(proc.render(frames=192))
    echo_edits(hs)
    return np.concatenate([first, np.asarray(proc.render(frames=192))], axis=1), proc


def test_echo_chain_matches_scan_and_jax(monkeypatch):
    """The echo chain's kernel path (plain version) is bit-equal to the
    port's scan executor and to the JAX render with and without its chain
    kernel; the lowered program carries the 32-word ring and pos per
    stage."""
    got = []
    real = kck.chain_kernel

    def spy(program, **ops):
        got.append(program)
        return real(program, **ops)

    monkeypatch.setattr(kck, "chain_kernel", spy)
    a, proc = render_echo(kt, "1", monkeypatch)
    assert [k for k, _ in proc.compiled.plan].count("chain") == 1 and got
    (rec,) = [r for r in got[0].records() if r[0].name == "sample_delay"]
    assert rec[1] == 32 and got[0].n_state == 33
    b, _ = render_echo(kt, "0", monkeypatch)
    np.testing.assert_array_equal(a, b)
    for mode in ("1", "0"):
        j, _ = render_echo(jk, mode, monkeypatch)
        np.testing.assert_array_equal(a, j)
    assert np.abs(a).max() > 1e-3
