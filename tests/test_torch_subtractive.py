"""The subtractive slice of the port against the JAX package: PolyBlep,
SvfFilter, the one-poles, EnvAsr/EnvAr and Pan2, as UGens and on the chain
kernel's plain path.

- Each UGen's ``process`` against the JAX one over several blocks with
  carried state, in the eventful and the event-free renderer (for the
  envelopes: the per-sample loop and the closed form). Integer state (the
  PolyBlep phase, the envelope stage) and the done rows are exact; floats
  are within ``TOL`` = 1e-6 of unit-amplitude outputs. The JAX side runs
  jitted at ``xla_backend_optimization_level`` 0 (no fused multiply-add).
  Measured at these sizes: PolyBlep 1.2e-7, batched 2.4e-7 (XLA's CPU sin
  and torch's differ by an ulp), SvfFilter 4.8e-7 and the one-poles 1.2e-7
  (the JAX package's associative-scan tree against the port's
  Hillis-Steele doubling), the envelopes' closed forms 1.8e-7 (jnp.cumsum
  against the doubling) and their per-sample loops 0, Pan2 6.0e-8.
- The graph renderer hands PolyBlep its waveforms from the param engine's
  host copy, and the render equals the one that reads them from the device.
- Each new chain-kernel body through ``chain_kernel_plain``
  (``graph.chain_kernel._MODE = "1"``) against the port's own scan
  executor, bit for bit, and against the JAX package's Pallas chain kernel
  in interpret mode within ``CHAIN_TOL`` = 2e-6, done vectors exact. The
  JAX package jits its renderer with XLA's default CPU options, which
  contract multiply-adds into fused ones, and a chain of 17 one-poles
  carries those roundings: measured 1.25e-6 at 0.62 of a 1.26 peak; the
  other chains 7.2e-7 or less (Pan2, peak 2.7), the PolyBlep cascade 0.
- Golden ``subtractive_voice`` at f32 and f64 through the port, at the
  golden gate 1e-6 + 2^-23 (fixtures read with the port's codec).
- ``convert`` carries these units' state (batched groups with two-word
  SVF state, chain stacks) from a JAX graph into the port.
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
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
import knaster_tpu_torch.graph.compile as tC
import knaster_tpu_torch.graph.chain_kernel as tck
from knaster_tpu_torch.utils.codec import read_flac
from knaster_tpu_torch.convert import graph_state_from_jax, graph_state_to_numpy

SR = 48000
TOL = 1e-6
# whole chains against the JAX package's kernel: see the module docstring
CHAIN_TOL = 2e-6
NO_FMA = {"xla_backend_optimization_level": 0}
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_GATE = 1e-6 + 2.0**-23


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    tC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


# --------------------------------------------------------------------------
# UGen process against the JAX package
# --------------------------------------------------------------------------

def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.array(x)


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    x = np.array(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x)


def run_blocks(jax_ugen, port_ugen, B, blocks, no_events, batch=None, state0=None):
    """Run ``blocks`` (each (inputs [.., in, B] np, params {name: np})) through
    both packages' ``process`` with carried state; returns the per-block
    (jax, port) results as numpy (state, out, done)."""
    jctx = jk.AudioCtx(SR, B, np.float32, no_events=no_events)
    tctx = kt.AudioCtx(SR, B, torch.float32, no_events=no_events)
    js = jax_ugen.init(jctx)
    ts = port_ugen.init(tctx)
    if batch is not None:
        js = jax.tree_util.tree_map(lambda x: jnp.stack([x] * batch), js)
        ts = {k: torch.stack([v] * batch) for k, v in ts.items()}
    if state0 is not None:
        js = {**js, **{k: jnp.asarray(v) for k, v in state0.items()}}
        ts = {**ts, **_to_torch(state0)}

    def one(s, i, p):
        r = jax_ugen.process(jctx, s, i, p)
        return r if len(r) == 3 else (r[0], r[1], jnp.zeros(r[1].shape[:-2] + (B,), bool))

    fn = jax.vmap(one) if batch is not None else one
    fn = jax.jit(fn, compiler_options=NO_FMA)
    results = []
    for inputs, params in blocks:
        js, jo, jd = fn(js, jnp.asarray(inputs), {k: jnp.asarray(v) for k, v in params.items()})
        r = port_ugen.process(tctx, ts, torch.from_numpy(inputs),
                              {k: torch.from_numpy(v) for k, v in params.items()})
        ts, to = r[0], r[1]
        td = r[2] if len(r) == 3 else torch.zeros(to.shape[:-2] + (B,), dtype=torch.bool)
        results.append(((_np_tree(js), np.asarray(jo), np.asarray(jd)),
                        (graph_state_to_numpy(ts, like=_np_tree(js)), to.numpy(),
                         td.numpy())))
    return results


def assert_blocks(results, exact=(), tol=TOL):
    peak = 0.0
    for n, ((js, jo, jd), (ts, to, td)) in enumerate(results):
        assert to.shape == jo.shape and to.dtype == jo.dtype, n
        np.testing.assert_allclose(to, jo, rtol=0, atol=tol, err_msg=f"block {n}")
        np.testing.assert_array_equal(td, jd, err_msg=f"done, block {n}")
        for k in js:
            if k in exact:
                np.testing.assert_array_equal(ts[k], js[k], err_msg=f"{k}, block {n}")
            else:
                np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=tol,
                                           err_msg=f"{k}, block {n}")
        peak = max(peak, float(np.abs(jo).max()))
    return peak


def _rng_rows(rng, lo, hi, B, lead=()):
    return rng.uniform(lo, hi, lead + (B,)).astype(np.float32)


@pytest.mark.parametrize("no_events", [False, True], ids=["eventful", "event_free"])
@pytest.mark.parametrize("waveform", list(range(14)), ids=[w.name for w in kt.Waveform])
def test_polyblep_process_matches_jax(waveform, no_events):
    """Every waveform, with per-sample frequency and pulse width, from a phase
    near the top of the u32 range; the last block runs above sr/4 (the pure
    sine)."""
    B = 64
    rng = np.random.default_rng(waveform)
    blocks = []
    for n in range(4):
        lo, hi = (13000.0, 20000.0) if n == 3 else (50.0, 3000.0)
        blocks.append((np.zeros((0, B), np.float32), {
            "waveform": np.full(B, waveform, np.int32),
            "freq": _rng_rows(rng, lo, hi, B),
            "pulse_width": _rng_rows(rng, 0.1, 0.9, B)}))
    res = run_blocks(jk.PolyBlep(), kt.PolyBlep(), B, blocks, no_events,
                     state0={"t": np.uint32(2**32 - 12345)})
    assert assert_blocks(res, exact=("t",)) > 0.5


def test_polyblep_batch_mixes_waveforms():
    """A batched call selects the waveform per row, as the JAX package's
    vmapped process does."""
    B, N = 32, 6
    rng = np.random.default_rng(7)
    blocks = [(np.zeros((N, 0, B), np.float32), {
        "waveform": np.repeat(np.array([0, 3, 4, 5, 13, 9], np.int32)[:, None], B, 1),
        "freq": _rng_rows(rng, 80.0, 2000.0, B, (N,)),
        "pulse_width": _rng_rows(rng, 0.2, 0.8, B, (N,))}) for _ in range(3)]
    res = run_blocks(jk.PolyBlep(), kt.PolyBlep(), B, blocks, True, batch=N)
    assert_blocks(res, exact=("t",))


def test_renderer_passes_polyblep_waveforms_on_the_host(monkeypatch):
    """The graph renderer hands every PolyBlep call its rows' waveforms from
    the param engine's host copy, equal to the device rows at sample 0,
    for a single node, a batch and a chain on the scan executor, through
    waveform sets at frame 0 and mid-block; the render equals the one that
    reads the waveforms back from the device, bit for bit; after the sets
    the engine's copy follows the state's tensor without a read."""
    from knaster_tpu_torch.ugens import polyblep as pb

    seen = []
    real = pb.polyblep_block

    def spy(t_word, waveform, *a):
        seen.append((waveform[..., 0].numpy().copy(), a[-1]))
        return real(t_word, waveform, *a)

    monkeypatch.setattr(pb, "polyblep_block", spy)

    def run():
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                        device="cpu")
        hs = {}

        def build(gg):
            hs["one"] = gg.push(kt.PolyBlep(kt.Waveform.Square, 200.0))
            lone = hs["one"] * 0.1
            hs["batch"] = [gg.push(kt.PolyBlep(kt.Waveform(w), 300.0 + 50 * w))
                           for w in (0, 3, 5)]
            for b in hs["batch"]:
                lone = lone + b * 0.1
            lone.to_graph_out()
            polyblep_cascade(kt, gg)

        g.edit(build)
        proc.render(frames=32)
        hs["one"].param("waveform").set(int(kt.Waveform.Triangle))
        hs["batch"][1].param("waveform").set_at(int(kt.Waveform.TrapezoidVariable),
                                                kt.Seconds.from_samples(32 + 7, SR))
        cascade = [n for n in g.nodes if n not in (hs["one"].id, *(b.id for b in hs["batch"]))
                   and isinstance(g.nodes[n].ugen, kt.PolyBlep)]
        g.handle(cascade[4]).param("waveform").set(int(kt.Waveform.Sine))
        audio = proc.render(frames=64)
        return audio, proc

    a, proc = run()
    plan = [k for k, _ in proc.compiled.plan]
    assert "single" in plan and "batch" in plan and "chain" in plan
    assert seen and all(h is not None for _, h in seen)
    for rows, host in seen:
        np.testing.assert_array_equal(np.asarray(host).reshape(rows.shape), rows)
    assert {int(w) for rows, _ in seen for w in np.ravel(rows)} >= {1, 3, 4, 13}
    engine, pe = proc.compiled.engine, proc.state["pe"]
    assert engine._ints_host[0]() is pe["int_value"]
    np.testing.assert_array_equal(engine._ints_host[2], pe["int_value"].numpy())
    monkeypatch.setattr(kt.PolyBlep, "host_int_params", ())
    # renderers are built with the class's host params and cached by the
    # graph's signature, which holds instance config only: build anew
    tC.clear_program_cache()
    seen.clear()
    b, _ = run()
    assert seen and all(h is None for _, h in seen)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() > 0.05


@pytest.mark.parametrize("no_events", [False, True], ids=["eventful", "event_free"])
@pytest.mark.parametrize("ty", list(range(9)), ids=[t.name for t in kt.SvfFilterType])
def test_svf_process_matches_jax(ty, no_events):
    """Every filter type with per-sample cutoff, q and gain over a noise
    input scaled to keep the output near unit amplitude (the resonant types
    gain up to 4x), the cutoff up to just under Nyquist in the last block."""
    B = 64
    rng = np.random.default_rng(100 + ty)
    blocks = []
    for n in range(4):
        hi = 23900.0 if n == 3 else 8000.0
        blocks.append((_rng_rows(rng, -0.3, 0.3, B, (1,)), {
            "filter": np.full(B, ty, np.int32),
            "cutoff_freq": _rng_rows(rng, 60.0, hi, B),
            "q": _rng_rows(rng, 0.5, 1.5, B),
            "gain": _rng_rows(rng, -9.0, 9.0, B),
            "t_calculate_coefficients": np.zeros(B, bool)}))
    res = run_blocks(jk.SvfFilter(), kt.SvfFilter(), B, blocks, no_events)
    assert assert_blocks(res) > 0.05


@pytest.mark.parametrize("no_events", [False, True], ids=["eventful", "event_free"])
@pytest.mark.parametrize("kind", ["OnePoleLpf", "OnePoleHpf"])
def test_onepole_process_matches_jax(kind, no_events):
    B = 64
    rng = np.random.default_rng(len(kind))
    blocks = [(_rng_rows(rng, -1.0, 1.0, B, (1,)),
               {"cutoff_freq": _rng_rows(rng, 20.0, 20000.0, B)}) for _ in range(4)]
    res = run_blocks(getattr(jk, kind)(), getattr(kt, kind)(), B, blocks, no_events)
    assert assert_blocks(res) > 0.05


@pytest.mark.parametrize("no_events", [False, True], ids=["eventful", "event_free"])
def test_pan2_process_matches_jax(no_events):
    B = 64
    rng = np.random.default_rng(3)
    blocks = [(_rng_rows(rng, -1.0, 1.0, B, (1,)),
               {"pan": _rng_rows(rng, -1.0, 1.0, B)}) for _ in range(2)]
    res = run_blocks(jk.Pan2(), kt.Pan2(), B, blocks, no_events)
    assert assert_blocks(res) > 0.5


def envelope_blocks(kind, B, eventful):
    """Blocks that walk an envelope through its stages: a restart, the
    attack crossing 1 mid-block, sustain (ASR), a release (ASR) and the
    release ending mid-block. Event-free blocks carry all-false triggers;
    the times are off the sample grid."""
    atk = np.full(B, 50.3 / SR, np.float32)
    rel = np.full(B, 95.5 / SR, np.float32)
    names = ("t_restart", "t_release") if kind == "EnvAsr" else ("t_restart",)

    def block(**trig):
        p = {"attack_time": atk, "release_time": rel}
        for n in names:
            row = np.zeros(B, bool)
            if n in trig:
                row[trig[n]] = True
            p[n] = row
        return np.zeros((0, B), np.float32), p

    if kind == "EnvAsr":
        seq = [block(t_restart=5)] + [block() for _ in range(3)]
        seq += [block(t_release=9)] + [block() for _ in range(3)]
        seq += [block(t_restart=3, t_release=30)] + [block() for _ in range(3)]
    else:  # attack then release, about 146 samples: five blocks each
        seq = [block(t_restart=5)] + [block() for _ in range(5)]
        seq += [block(t_restart=20)] + [block() for _ in range(5)]
    return seq if eventful else None, seq


@pytest.mark.parametrize("kind", ["EnvAsr", "EnvAr"])
@pytest.mark.parametrize("closed_form", [False, True], ids=["per_sample", "closed_form"])
def test_envelope_process_matches_jax(kind, closed_form):
    """The per-sample loop (eventful renderer) over every block, or the
    event-free closed form on the blocks without triggers (the eventful
    ones run the loop, as the renderers do). Stage and done rows exact."""
    B = 32
    _, seq = envelope_blocks(kind, B, True)
    if not closed_form:
        res = run_blocks(getattr(jk, kind)(), getattr(kt, kind)(), B, seq, False)
        assert assert_blocks(res, exact=("stage",)) > 0.9
        assert any(r[0][2].any() for r in res)
        return
    # alternate the two renderers by carrying state across two runs
    jctx = {f: jk.AudioCtx(SR, B, np.float32, no_events=f) for f in (False, True)}
    tctx = {f: kt.AudioCtx(SR, B, torch.float32, no_events=f) for f in (False, True)}
    ju, tu = getattr(jk, kind)(), getattr(kt, kind)()
    js, ts = ju.init(jctx[False]), tu.init(tctx[False])
    fns = {f: jax.jit(lambda s, p, f=f: ju.process(jctx[f], s, jnp.zeros((0, B)), p),
                      compiler_options=NO_FMA) for f in (False, True)}
    dones = 0
    for inputs, params in seq:
        f = not any(v.any() for k, v in params.items() if k.startswith("t_"))
        js, jo, jd = fns[f](js, {k: jnp.asarray(v) for k, v in params.items()})
        ts, to, td = tu.process(tctx[f], ts, torch.from_numpy(inputs),
                                {k: torch.from_numpy(v) for k, v in params.items()})
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert int(ts["stage"]) == int(js["stage"])
        np.testing.assert_allclose(float(ts["t"]), float(js["t"]), rtol=0, atol=TOL)
        np.testing.assert_allclose(float(ts["release_scale"]), float(js["release_scale"]),
                                   rtol=0, atol=TOL)
        dones += int(td.sum())
    assert dones >= 1


def test_envelope_closed_form_equals_loop_in_the_port():
    """In the port itself the closed form and the per-sample loop agree on a
    batch of envelopes in every stage (a stage, t and release scale per
    row), the attack and release crossing mid-block."""
    B, N = 64, 8
    rng = np.random.default_rng(11)
    for kind in ("EnvAsr", "EnvAr"):
        u = getattr(kt, kind)()
        stage = torch.tensor([1, 3, 2, 0, 1, 3, 1, 3], dtype=torch.int32)
        state = {"stage": stage, "t": torch.tensor(rng.uniform(0.3, 0.9, N), dtype=torch.float32),
                 "release_scale": torch.tensor(rng.uniform(0.5, 1, N), dtype=torch.float32)}
        params = {"attack_time": torch.full((N, B), 60.3 / SR),
                  "release_time": torch.full((N, B), 40.7 / SR)}
        for n in u.param_names():
            if n.startswith("t_"):
                params[n] = torch.zeros((N, B), dtype=torch.bool)
        a = u.process(kt.AudioCtx(SR, B, torch.float32, no_events=True), state,
                      torch.zeros((N, 0, B)), params)
        b = u.process(kt.AudioCtx(SR, B, torch.float32), state, torch.zeros((N, 0, B)),
                      params)
        torch.testing.assert_close(a[1], b[1], rtol=0, atol=TOL)
        assert torch.equal(a[2], b[2]) and torch.equal(a[0]["stage"], b[0]["stage"])
        assert a[2].any()


# --------------------------------------------------------------------------
# the chain kernel's new bodies, through whole graphs
# --------------------------------------------------------------------------

def onepole_chain(m, gg):
    """tests/test_chain_kernel.py:142 from a PolyBlep saw: 16 one-poles
    alternating Lpf / Hpf (period 2), then an Hpf."""
    node = gg.push(m.PolyBlep(m.Waveform.Sawtooth, 220.0))
    for i in range(16):
        f = gg.push(m.OnePoleLpf(8000.0 + 100.0 * i) if i % 2 == 0
                    else m.OnePoleHpf(40.0 + 5.0 * i))
        node.to(f)
        node = f
    hp = gg.push(m.OnePoleHpf(50.0))
    node.to(hp)
    hp.to_graph_out()


def svf_chain(m, gg):
    """tests/test_chain_kernel.py:174 from a PolyBlep saw: 10 Bell SVFs."""
    node = gg.push(m.PolyBlep(m.Waveform.Sawtooth, 110.0))
    for i in range(10):
        f = gg.push(m.SvfFilter(m.SvfFilterType.Bell, 400.0 * (i + 1), q=1.2,
                                gain_db=3.0 if i % 2 == 0 else -2.0))
        node.to(f)
        node = f
    node.to_graph_out()


def mixed_svf_chain(m, gg):
    """Eight SVFs of eight filter types in series: the type is a per-stage
    integer plane."""
    node = gg.push(m.PolyBlep(m.Waveform.Square, 150.0))
    for i, ty in enumerate((0, 1, 2, 3, 4, 5, 7, 8)):
        f = gg.push(m.SvfFilter(m.SvfFilterType(ty), 300.0 * (i + 2), q=0.9, gain_db=2.0))
        node.to(f)
        node = f
    (node * 0.3).to_graph_out()


def pan2_chain(m, gg):
    """tests/test_chain_kernel.py:431 from a PolyBlep square."""
    prev = gg.push(m.PolyBlep(m.Waveform.Square, 330.0))
    for i in range(10):
        p = gg.push(m.Pan2(-0.4 + 0.08 * i))
        prev.to(p)
        prev = p.out([0]) + p.out([1])
    (prev * 0.1).to_graph_out()


def polyblep_cascade(m, gg, out=True):
    """tests/test_chain_kernel.py:400 with the suite's (x * 100) + 200 drive
    and five waveforms, two of them pulse-width users."""
    W = m.Waveform
    waves = (W.Sawtooth, W.Square, W.Triangle, W.Rectangle, W.TrapezoidVariable)
    prev = None
    for i in range(12):
        s = gg.push(m.PolyBlep(waves[i % 5], 80.0 + 11.0 * i))
        if prev is not None:
            mod = (prev * 100.0) + 200.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
        prev = s
    if out:
        (prev * 0.1).to_graph_out()


def env_chain(kind, free_parent=False):
    """tests/test_chain_kernel.py:265 / :355: ten envelopes mixed serially."""
    def build(m, gg):
        prev = None
        for i in range(10):
            e = getattr(m, kind)(attack_time=(50.3 + 7.1 * i) / SR,
                                 release_time=(95.5 + 3.0 * i) / SR)
            e = (gg.push_with_done_action(e, m.Done.FREE_PARENT) if free_parent
                 else gg.push(e))
            prev = e if prev is None else prev + e
        (prev * 0.05).to_graph_out()
    return build


def spy_run(monkeypatch):
    calls = {"run": 0, "ok": 0}
    real = tck.run

    def spy(*a, **k):
        calls["run"] += 1
        r = real(*a, **k)
        calls["ok"] += r is not None
        return r

    monkeypatch.setattr(tck, "run", spy)
    return calls


def render(m, mode, build, monkeypatch, bs, frames, triggers=()):
    """Render ``frames`` twice, each time after triggering ``triggers`` on
    every node that has them; returns (audio, processor, graph)."""
    if m is jk:
        monkeypatch.setattr(jck, "_MODE", mode)
        jC.clear_program_cache()
        g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=bs))
    else:
        monkeypatch.setattr(tck, "_MODE", mode)
        g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=bs),
                                       device="cpu")
    g.edit(lambda gg: build(m, gg))
    outs = []
    for trig in (triggers[:1], triggers[1:]) if triggers else ((), ()):
        for name in trig:
            for nid, e in list(g.nodes.items()):
                if name in e.ugen.param_names():
                    g.handle(nid).param(name).trig()
        outs.append(np.asarray(proc.render(frames=frames)))
    return np.concatenate(outs, axis=1), proc, g


CHAINS = {
    "onepole": (onepole_chain, 32, 96, ()),
    "svf_bell": (svf_chain, 32, 96, ()),
    "svf_types": (mixed_svf_chain, 32, 96, ()),
    "pan2": (pan2_chain, 16, 96, ()),
    "polyblep": (polyblep_cascade, 16, 96, ()),
    "env_asr": (env_chain("EnvAsr"), 16, 160, ("t_restart", "t_release")),
    "env_ar": (env_chain("EnvAr"), 16, 256, ("t_restart", "t_restart")),
    "env_asr_free_parent": (env_chain("EnvAsr", True), 16, 160,
                            ("t_restart", "t_release")),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_bodies_match_scan_and_jax_kernel(name, monkeypatch):
    """The chain's kernel path (plain version) equals the port's scan
    executor bit for bit and the JAX package's interpret-mode kernel within
    TOL; the kernel ran on every event-free block."""
    build, bs, frames, triggers = CHAINS[name]
    calls = spy_run(monkeypatch)
    a, proc, _ = render(kt, "1", build, monkeypatch, bs, frames, triggers)
    assert [k for k, _ in proc.compiled.plan].count("chain") == 1
    assert calls["ok"] >= 1 and calls["ok"] == calls["run"]
    b, _, _ = render(kt, "0", build, monkeypatch, bs, frames, triggers)
    np.testing.assert_array_equal(a, b)
    j, jproc, _ = render(jk, "1", build, monkeypatch, bs, frames, triggers)
    assert [k for k, _ in jproc.compiled.plan] == [k for k, _ in proc.compiled.plan]
    np.testing.assert_allclose(a, j, rtol=0, atol=CHAIN_TOL)
    assert np.abs(a).max() > 1e-3
    if name.startswith("env"):
        assert np.abs(a[:, -16:]).max() == 0.0  # every release ended
    if name == "env_asr_free_parent":
        assert proc.freed and jproc.freed
        nz, jz = np.flatnonzero(np.abs(a[0]) > 0), np.flatnonzero(np.abs(j[0]) > 0)
        assert nz[-1] == jz[-1] < a.shape[1] - 1  # the same free frame


@pytest.mark.parametrize("kind", ["EnvAsr", "EnvAr"])
def test_chain_done_vector_matches_scan_and_jax(kind, monkeypatch):
    """The done vector of event-free blocks across the release ends: the
    kernel path's done planes equal the scan executor's and the JAX
    kernel's (frame placement included)."""
    def dones(m, mode):
        # FREE_PARENT makes the port's renderer return its done vector;
        # render_fast is called directly, so nothing is freed
        build = env_chain(kind, free_parent=True)
        trig = ("t_restart", "t_release") if kind == "EnvAsr" else ("t_restart",)
        _, proc, g = render(m, mode, build, monkeypatch, 16, 48, trig)
        cg = proc.compiled
        st, out = proc.state, []
        if m is jk:
            st = jax.tree_util.tree_map(jnp.array, st)
            zeros = jnp.zeros((0, 16), cg.ctx.dtype)
        else:
            zeros = torch.zeros((0, 16))
        for _ in range(24):
            st, _o, done = cg.render_fast(st, zeros)
            out.append(np.asarray(done))
        return np.stack(out)

    d1 = dones(kt, "1")
    assert d1.any()
    np.testing.assert_array_equal(d1, dones(kt, "0"))
    np.testing.assert_array_equal(d1, dones(jk, "1"))


def test_chain_state_words_and_done_planes(monkeypatch):
    """The lowered program of the SVF chain carries the two-word ``ic`` and
    the filter type as a plane; the env chain's program has one done plane
    whose rows come back as the JAX shape ([K, B] bool per offset)."""
    from knaster_tpu_torch.kernels import chain_kernel as kck

    got = []
    real = kck.chain_kernel

    def spy(program, **ops):
        got.append((program, ops))
        return real(program, **ops)

    monkeypatch.setattr(kck, "chain_kernel", spy)
    render(kt, "1", svf_chain, monkeypatch, 32, 32)
    program, ops = got[-1]
    assert (program.period, program.n_state, program.n_done, program.n_scratch) == (1, 2, 0, 12)
    (rec,) = program.records()
    assert rec[0].name == "svf" and rec[3][0] == (kck.SRC_PLANE, 3)  # the int plane
    assert program.all_bodies  # the kernel's instantiation with every body
    assert sorted(set(ops["planes"][3].flatten().tolist())) == [6.0]  # Bell
    runs = []
    real_run = tck.run

    def keep(*a, **k):
        runs.append(real_run(*a, **k))
        return runs[-1]

    monkeypatch.setattr(tck, "run", keep)
    render(kt, "1", env_chain("EnvAsr"), monkeypatch, 16, 32, ("t_restart",))
    program, ops = got[-1]
    assert (program.n_done, program.n_state, program.n_scratch) == (1, 3, 4)
    dones = runs[-1][2]
    shapes = sorted((tuple(d.shape), d.dtype) if d is not None else () for d in dones.values())
    # the second render's two event-free blocks ride one superblock
    assert ops["block_size"] == 32
    assert shapes == [(), ((ops["K"], 32), torch.bool)]


@pytest.mark.parametrize("name, dtype", [("f32", torch.float32), ("f64", torch.float64)])
def test_subtractive_voice_meets_golden(name, dtype):
    """tests/golden_configs.py render_subtractive_voice through the port."""
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=64,
                                                                   sample_rate=SR),
                                    dtype=dtype, device="cpu")
    hs = {}

    def build(gg):
        saw = gg.push(kt.PolyBlep(kt.Waveform.Sawtooth, 110.0))
        svf = gg.push(kt.SvfFilter(kt.SvfFilterType.Low, 900.0, q=2.5))
        env = gg.push(kt.EnvAsr(attack_time=0.01, release_time=0.08))
        saw.to(svf)
        (svf * env * 0.5).to_graph_out()
        hs["svf"], hs["env"] = svf, env

    g.edit(build)
    hs["env"].param("t_restart").trig()
    cutoff = hs["svf"].param("cutoff_freq")
    cutoff.set_at(500.0, kt.Seconds.from_samples(4000, SR))
    cutoff.smooth(kt.Smoothing.linear(0.1))
    cutoff.set_at(4500.0, kt.Seconds.from_samples(4801, SR))
    hs["env"].param("t_release").trig_at(kt.Seconds.from_samples(12000, SR))
    audio = proc.render(frames=19200)
    assert audio.dtype == (np.float32 if name == "f32" else np.float64)
    ref, sr = read_flac(os.path.join(GOLDEN_DIR, f"subtractive_voice_{name}.flac"))
    assert sr == SR and ref.shape == audio.shape
    assert float(np.abs(audio.astype(np.float32) - ref).max()) <= GOLDEN_GATE
    assert np.abs(ref).max() > 0.5


def convert_graph(m):
    """A PolyBlep into three SVFs of three types (a batch group, ``ic``
    [3, 2]), a 12-stage PolyBlep cascade (a chain stack of u32 phases) and
    an EnvAsr gate, B = 16, rendered block by block. (JAX filter chains
    take the scan executor on the CPU, which compiles for minutes: the SVF
    and one-pole chains are held against it above, at fewer blocks; each
    superblock length would compile one more program, ~40 s of the JAX
    side on the CPU, so the state carry is held on the per-block programs.)"""
    kw = {} if m is jk else {"device": "cpu"}
    g, proc = m.AudioProcessor.new(0, 2, m.AudioProcessorOptions(
        block_size=16, render_chunk_blocks=1), **kw)

    def build(gg):
        s = gg.push(m.PolyBlep(m.Waveform.Triangle, 220.0))
        for i in range(3):
            f = gg.push(m.SvfFilter(m.SvfFilterType(i), 500.0 * (i + 1), q=1.1))
            s.to(f)
            (f * 0.05).to_graph_out()
        polyblep_cascade(m, gg, out=False)
        env = gg.push(m.EnvAsr(attack_time=0.002, release_time=0.003))
        (gg.handle(max(gg.nodes)) * env * 0.2).out([0, 0]).to_graph_out()
        return env

    env = g.edit(build)
    env.param("t_restart").trig()
    return proc, env


def test_convert_carries_subtractive_state():
    (pj, ej), (pt, et) = convert_graph(jk), convert_graph(kt)
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
    assert any(x.shape == (3, 2) for x in flat_a)  # the SVF group's ic
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(y, x)
    ej.param("t_release").trig()
    et.param("t_release").trig()
    a = np.asarray(pj.render(frames=320))
    b = pt.render(frames=320)
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    assert np.abs(b).max() > 1e-3
