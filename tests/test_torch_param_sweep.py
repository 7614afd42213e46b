"""The param-sweep slice of the port against the JAX package: SinNumeric,
Phasor, their chain-kernel bodies and golden ``param_sweep``.

- ``core/dsp.cumsum_base16`` is bit-equal to ``jnp.cumsum`` on XLA's CPU
  backend at every length, f32 and f64: XLA rewrites the reduce-window it
  lowers to into a blocked scan of base 16, and the port takes the same
  steps. XLA's CPU backend also turns the division of the increment by the
  sample rate (a constant) into a multiply by its reciprocal; the port
  multiplies by that reciprocal.
- Each UGen's ``process`` against the JAX one over blocks of 64 and 4096
  samples with carried state, with reset triggers (SinNumeric) and without:
  the float phase is bit-equal; Phasor's output is too, SinNumeric's within
  ``TOL`` = 1e-6 (XLA's CPU sin and torch's differ by an ulp; measured
  6.0e-8).
- The two chain bodies through ``chain_kernel_plain`` (``_MODE = "1"``)
  against the port's scan executor, bit for bit, and against the JAX
  package's Pallas chain kernel in interpret mode within ``CHAIN_TOL``.
- Golden ``param_sweep``. At f64 within the golden gate, 1e-6 + 2^-23. At
  f32 the port reproduces the JAX package's association, and equals the JAX
  package's own f32 render, made in this process with XLA's backend
  optimizations off, within ``TOL`` (measured 6.0e-8). With them on (the
  setting the fixture was rendered at), XLA:CPU contracts the Math nodes'
  ``(lfo * 200) + 330`` into one fused multiply-add, which the port rounds
  twice, and at one sample of the 14,400 that moves SinWt's u32 increment
  across an integer, so its 16384-entry table index by one: a step of at
  most ``0.2 * 2 * pi / 16384`` in the output (the sine's gain), measured
  7.47e-5 at sample 11,417. The f32 gate is the golden gate everywhere but
  at ``MAX_STEPS`` samples, and the golden gate plus that one table step
  there. (The fixture's generator notes the same 7.5e-5 between two XLA
  flag settings of the JAX package itself.)
- ``convert`` carries their f32 phases, batched and chain-stacked, from a
  JAX graph into the port.
"""

import os

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
from knaster_tpu_torch.utils.codec import read_flac
from knaster_tpu_torch.convert import graph_state_from_jax, graph_state_to_numpy
from knaster_tpu_torch.core.dsp import cumsum_base16
from knaster_tpu_torch.kernels import chain_kernel as kck
from knaster_tpu_torch.ugens.osc import recip_sample_rate

SR = 48000
TOL = 1e-6
# whole chains against the JAX package's interpret-mode kernel: its
# renderer contracts the modulators' (x * c1) + c2 into fused multiply-adds
CHAIN_TOL = 2e-6
NO_FMA = {"xla_backend_optimization_level": 0}
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_GATE = 1e-6 + 2.0**-23
# one SinWt table step at param_sweep's output gain (module docstring)
TABLE_STEP = 0.2 * 2.0 * np.pi / 16384
MAX_STEPS = 4


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    tC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


# --------------------------------------------------------------------------
# the association and the increment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 5, 16, 17, 48, 64, 100, 300, 1024, 4096, 8192])
def test_cumsum_base16_matches_xla(n, dtype):
    """Bit-equal to jnp.cumsum on XLA:CPU, one row and a batch of rows."""
    rng = np.random.default_rng(n)
    cs = jax.jit(lambda a: jnp.cumsum(a, axis=-1))
    for shape in ((n,), (3, n)):
        x = rng.uniform(-0.01, 0.03, shape).astype(dtype)
        with jax.enable_x64(dtype == np.float64):
            want = np.asarray(cs(jnp.asarray(x)))
        assert want.dtype == dtype
        got = cumsum_base16(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_increment_is_xla_division_by_the_sample_rate(dtype):
    """XLA:CPU divides by a constant as a multiply by its reciprocal; so does
    the port (and not torch's division, which rounds otherwise)."""
    f = np.random.default_rng(1).uniform(20.0, 20000.0, 4096).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.jit(lambda a: a / jnp.asarray(float(SR), dtype))(jnp.asarray(f)))
    assert want.dtype == dtype
    t = torch.from_numpy(f)
    np.testing.assert_array_equal((t * recip_sample_rate(SR, t)).numpy(), want)
    assert not np.array_equal(f / dtype(SR), want)  # the reciprocal matters


# --------------------------------------------------------------------------
# process against the JAX package
# --------------------------------------------------------------------------

def run_process(name, B, no_events, resets, batch=None):
    """Three blocks of random per-sample params through both packages'
    ``process`` (jitted without FMA on the JAX side) with carried state;
    returns [(jax phase, jax out, port phase, port out)]."""
    rng = np.random.default_rng(B + 7 * resets)
    ju, tu = getattr(jk, name)(), getattr(kt, name)()
    jctx = jk.AudioCtx(SR, B, np.float32, no_events=no_events)
    tctx = kt.AudioCtx(SR, B, torch.float32, no_events=no_events)
    lead = () if batch is None else (batch,)
    ph0 = rng.uniform(0.0, 1.0, lead).astype(np.float32)
    js, ts = {"phase": jnp.asarray(ph0)}, {"phase": torch.from_numpy(ph0.copy())}

    def one(s, p):
        return ju.process(jctx, s, jnp.zeros((0, B), jnp.float32), p)

    fn = jax.jit(jax.vmap(one) if batch else one, compiler_options=NO_FMA)
    out = []
    for blk in range(3):
        p = {"freq": rng.uniform(30.0, 3000.0, lead + (B,)).astype(np.float32)}
        if name == "SinNumeric":
            p["phase_offset"] = rng.uniform(-0.5, 0.5, lead + (B,)).astype(np.float32)
            r = np.zeros(lead + (B,), bool)
            if resets and blk > 0:
                r[..., (blk * B) // 5] = True
                r[..., B - 1 - blk] = True
            p["reset_phase"] = r
        js, jo = fn(js, {k: jnp.asarray(v) for k, v in p.items()})
        ts, to = tu.process(tctx, ts, torch.zeros(lead + (0, B)),
                            {k: torch.from_numpy(v) for k, v in p.items()})
        out.append((np.asarray(js["phase"]), np.asarray(jo), ts["phase"].numpy(),
                    to.numpy()))
    return out


@pytest.mark.parametrize("B", [64, 4096])
@pytest.mark.parametrize("case", ["resets", "no_resets", "event_free", "batch"])
@pytest.mark.parametrize("name", ["SinNumeric", "Phasor"])
def test_float_osc_process_matches_jax(name, case, B):
    """Phase bit-equal after every block; Phasor's ramp bit-equal,
    SinNumeric's sine within TOL. ``resets``: reset triggers mid-block in
    the eventful program (SinNumeric's only trigger; Phasor has none);
    ``event_free``: the fast program's no-reset path; ``batch``: an
    auto-batched group of 5."""
    res = run_process(name, B, no_events=case == "event_free", resets=case == "resets",
                      batch=5 if case == "batch" else None)
    for n, (jph, jo, tph, to) in enumerate(res):
        assert to.shape == jo.shape and to.dtype == jo.dtype
        np.testing.assert_array_equal(tph, jph, err_msg=f"phase, block {n}")
        if name == "Phasor":
            np.testing.assert_array_equal(to, jo, err_msg=f"block {n}")
        else:
            np.testing.assert_allclose(to, jo, rtol=0, atol=TOL, err_msg=f"block {n}")
    assert max(np.abs(r[1]).max() for r in res) > 0.5


# --------------------------------------------------------------------------
# the chain bodies
# --------------------------------------------------------------------------

def phasor_cascade(m, gg):
    """tests/test_chain_kernel.py:209-232: 12 Phasor LFOs, each one's
    output * 40 + 60 driving the next one's freq."""
    prev = None
    for i in range(12):
        ph = gg.push(m.Phasor(0.5 + 0.25 * i))
        if prev is not None:
            mod = (prev * 40.0) + 60.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, ph, "freq")
        prev = ph
    (prev * 0.2).to_graph_out()


def sin_numeric_cascade(m, gg):
    """tests/test_chain_kernel.py:235-258: a 12-stage SinNumeric FM cascade,
    (prev * 50) + 150 driving each next freq, with phase offsets."""
    prev = None
    for i in range(12):
        s = gg.push(m.SinNumeric(100.0 + 7.0 * i))
        if prev is not None:
            mod = (prev * 50.0) + 150.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
        prev = s
    (prev * 0.1).to_graph_out()


CASCADES = {"phasor": phasor_cascade, "sin_numeric": sin_numeric_cascade}


def render(m, mode, build, monkeypatch, bs, frames, chunk=128, dtype=None):
    """Render ``frames`` of ``build`` with the chain executor in ``mode``;
    returns (audio, processor)."""
    opts = m.AudioProcessorOptions(block_size=bs, render_chunk_blocks=chunk)
    if m is jk:
        monkeypatch.setattr(jck, "_MODE", mode)
        jC.clear_program_cache()
        g, proc = m.AudioProcessor.new(0, 1, opts, dtype=dtype)
    else:
        monkeypatch.setattr(tck, "_MODE", mode)
        g, proc = m.AudioProcessor.new(0, 1, opts, dtype=dtype, device="cpu")
    g.edit(lambda gg: build(m, gg))
    return np.asarray(proc.render(frames=frames)), proc


def spy_run(monkeypatch):
    calls = {"run": 0, "ok": 0, "B": []}
    real = tck.run

    def spy(cp, reps, ctx, *a, **k):
        calls["run"] += 1
        r = real(cp, reps, ctx, *a, **k)
        calls["ok"] += r is not None
        calls["B"].append(ctx.block_size)
        return r

    monkeypatch.setattr(tck, "run", spy)
    return calls


@pytest.mark.parametrize("name", list(CASCADES))
def test_float_osc_chain_bodies_match_scan_and_jax_kernel(name, monkeypatch):
    """The cascade's kernel path (plain version) equals the port's scan
    executor bit for bit, and the JAX package's interpret-mode kernel within
    CHAIN_TOL; the kernel ran on every event-free piece of the render (a
    96-frame render at B = 16 is one superblock of 4 blocks and one of 2)."""
    build = CASCADES[name]
    calls = spy_run(monkeypatch)
    a, proc = render(kt, "1", build, monkeypatch, 16, 96)
    assert [k for k, _ in proc.compiled.plan].count("chain") == 1
    assert calls["ok"] == calls["run"] == 2 and calls["B"] == [64, 32]
    b, _ = render(kt, "0", build, monkeypatch, 16, 96)
    np.testing.assert_array_equal(a, b)
    j, jproc = render(jk, "1", build, monkeypatch, 16, 96)
    assert [k for k, _ in jproc.compiled.plan] == [k for k, _ in proc.compiled.plan]
    np.testing.assert_allclose(a, j, rtol=0, atol=CHAIN_TOL)
    assert np.abs(a).max() > 0.02


@pytest.mark.parametrize("name", list(CASCADES))
def test_float_osc_chain_program(name, monkeypatch):
    """The cascade lowers to a 5-offset program ending in the oscillator's
    body: its f32 phase is one state word and its scan takes three scratch
    rows; the program runs the kernel with every body."""
    got = []
    real = kck.chain_kernel

    def spy(program, **ops):
        got.append((program, ops))
        return real(program, **ops)

    monkeypatch.setattr(kck, "chain_kernel", spy)
    render(kt, "1", CASCADES[name], monkeypatch, 16, 16)
    program, ops = got[0]
    assert [r[0].name for r in program.records()][-1] == name
    assert (program.period, program.n_state, program.n_scratch) == (5, 1, 3)
    assert program.all_bodies
    words = ops["state"].view(torch.float32)
    assert ops["state"].shape == (1, 11) and bool((words == 0).all())  # fresh phases


# --------------------------------------------------------------------------
# golden param_sweep
# --------------------------------------------------------------------------

def param_sweep(m, dtype, **opts):
    """tests/golden_configs.py render_param_sweep (config 4) over either
    package."""
    o = m.AudioProcessorOptions(block_size=64, sample_rate=SR, **opts)
    kw = {} if m is jk else {"device": "cpu"}
    g, proc = m.AudioProcessor.new(0, 1, o, dtype=dtype, **kw)
    hs = {}

    def build(gg):
        a = gg.push(m.SinNumeric(220.0))
        lfo = gg.push(m.Phasor(3.0))
        b = gg.push(m.SinWt(440.0))
        mod = (lfo * 200.0) + 330.0
        gg.connect_param(gg.handle(mod.channels[0][1]), 0, b, "freq")
        ((a + b) * 0.2).to_graph_out()
        hs["a"] = a

    g.edit(build)
    freq = hs["a"].param("freq")
    freq.set_at(330.0, m.Seconds.from_samples(1000, SR))
    freq.set_at(550.0, m.Seconds.from_samples(2500, SR))
    freq.smooth(m.Smoothing.linear(0.05))
    freq.set_at(110.0, m.Seconds.from_samples(7000, SR))
    return proc


def golden(name):
    ref, sr = read_flac(os.path.join(GOLDEN_DIR, f"param_sweep_{name}.flac"))
    assert sr == SR
    return ref


def test_param_sweep_meets_golden_f64():
    audio = param_sweep(kt, torch.float64).render(frames=14400)
    ref = golden("f64")
    assert audio.dtype == np.float64 and ref.shape == audio.shape
    assert float(np.abs(audio.astype(np.float32) - ref).max()) <= GOLDEN_GATE
    assert np.abs(ref).max() > 0.3


def assert_within_f32_gate(audio, ref):
    """The golden gate but at MAX_STEPS samples, one SinWt table step there
    (module docstring)."""
    err = np.abs(audio.astype(np.float32) - ref)
    off = np.flatnonzero(err > GOLDEN_GATE)
    assert off.size <= MAX_STEPS, off
    assert float(err.max()) <= GOLDEN_GATE + TABLE_STEP


def test_param_sweep_meets_golden_f32():
    audio = param_sweep(kt, torch.float32).render(frames=14400)
    ref = golden("f32")
    assert audio.dtype == np.float32 and ref.shape == audio.shape
    assert_within_f32_gate(audio, ref)
    assert np.abs(ref).max() > 0.3


def test_param_sweep_f32_matches_jax_render():
    """The port's f32 render against the JAX package's, both made here:
    within TOL of the JAX render without fused multiply-adds (XLA's backend
    optimizations off), and within the f32 golden gate of its default one."""
    port = param_sweep(kt, torch.float32).render(frames=14400)
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        plain = np.asarray(param_sweep(jk, np.float32).render(frames=14400))
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
    jC.clear_program_cache()
    fused = np.asarray(param_sweep(jk, np.float32).render(frames=14400))
    np.testing.assert_allclose(port, plain, rtol=0, atol=TOL)
    assert_within_f32_gate(port, fused)
    assert np.flatnonzero(np.abs(port - fused) > GOLDEN_GATE).size >= 1  # the FMA step


def test_param_sweep_superblocks_equal_per_block_f64():
    """At f64 the superblocked render and the per-block one
    (render_chunk_blocks=1) agree far inside the gate: only the float
    phase's association differs between them."""
    a = param_sweep(kt, torch.float64).render(frames=14400)
    b = param_sweep(kt, torch.float64, render_chunk_blocks=1).render(frames=14400)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# convert
# --------------------------------------------------------------------------

def convert_graph(m):
    """Three auto-batched SinNumerics (a batch group of f32 phases), a
    12-stage Phasor cascade (a chain stack) and a Phasor, B = 16."""
    kw = {} if m is jk else {"device": "cpu"}
    g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=16), **kw)

    def build(gg):
        for i in range(3):
            (gg.push(m.SinNumeric(300.0 + 110.0 * i)) * 0.05).to_graph_out()
        phasor_cascade(m, gg)
        (gg.push(m.Phasor(7.0)) * 0.1).to_graph_out()

    g.edit(build)
    return proc


def test_convert_carries_float_osc_state():
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
    assert any(x.shape == (3,) and x.dtype == np.float32 for x in flat_a)  # the batch
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(y, x)
    a = np.asarray(pj.render(frames=160))
    b = pt.render(frames=160)
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    assert np.abs(b).max() > 1e-3
