"""The port's chain executor: the chain kernel's plain version against the JAX
package's Pallas chain kernel (interpret mode) and the port's scan executor.

``graph.chain_kernel._MODE = "1"`` sends collapsed chains through
``chain_kernel.run`` on the CPU too, where the wrapper runs
``chain_kernel_plain`` over the lowered program (the JAX tests set their
``_MODE`` the same way, tests/test_chain_kernel.py:41-42); "0" keeps the
scan executor. Tolerances: the plain chain equals the port's scan executor
exactly (the same torch arithmetic, body for body); against the JAX package
within 1e-6, since XLA's CPU ``sin`` and torch's differ by an ulp at some
table indices (measured 7.5e-9 at these sizes).
"""

import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.graph.chain_kernel as jck
import knaster_tpu.graph.compile as jC
import knaster_tpu_torch as kt
import knaster_tpu_torch.graph.chain_kernel as tck
from knaster_tpu_torch.kernels import chain_kernel as kck

JAX_TOL = 1e-6


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    yield
    jC.clear_program_cache()


def build_cascade(m, gg, n, hs=None):
    """tests/test_chain_collapse.py build_cascade, over either package."""
    prev = None
    for i in range(n):
        s = gg.push(m.SinWt(100.0 + i))
        if prev is not None:
            mod = (prev * 100.0) + 200.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
        prev = s
        if hs is not None:
            hs.append(s)
    (prev * 0.1).to_graph_out()


def cascade16(m, gg, hs):
    build_cascade(m, gg, 16, hs)


def tapped14(m, gg, hs):
    build_cascade(m, gg, 14, hs)
    (hs[7] * 0.05).to_graph_out()


def render(m, mode, make, frames, monkeypatch, bs=16, edits=None, dtype=None):
    """Render ``frames`` (twice, with ``edits`` between, when given) with the
    chain executor in ``mode``; returns (audio, processor)."""
    if m is jk:
        monkeypatch.setattr(jck, "_MODE", mode)
        jC.clear_program_cache()
    else:
        monkeypatch.setattr(tck, "_MODE", mode)
    g, proc = m.AudioProcessor.new(0, 1, m.AudioProcessorOptions(block_size=bs),
                                   dtype=dtype)
    hs = []
    g.edit(lambda gg: make(m, gg, hs))
    outs = [np.asarray(proc.render(frames=frames))]
    if edits:
        edits(hs)
        outs.append(np.asarray(proc.render(frames=frames)))
    return np.concatenate(outs, axis=1), proc


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


@pytest.mark.parametrize("make, frames", [(cascade16, 128), (tapped14, 96)],
                         ids=["cascade", "mid_chain_tap"])
def test_plain_chain_matches_scan_and_jax_kernel(make, frames, monkeypatch):
    calls = spy_run(monkeypatch)
    a, proc = render(kt, "1", make, frames, monkeypatch)
    assert [k for k, _ in proc.compiled.plan].count("chain") == 1
    assert calls["ok"] == frames // 16  # one kernel run per event-free block
    b, _ = render(kt, "0", make, frames, monkeypatch)
    np.testing.assert_array_equal(a, b)
    j, jproc = render(jk, "1", make, frames, monkeypatch)
    assert [k for k, _ in jproc.compiled.plan] == [k for k, _ in proc.compiled.plan]
    np.testing.assert_allclose(a, j, rtol=0, atol=JAX_TOL)
    assert np.abs(a).max() > 1e-3


def test_state_carries_across_blocks(monkeypatch):
    """Many short renders equal one long one: the kernel writes the stage
    phases back by stage index."""
    whole, _ = render(kt, "1", lambda m, gg, hs: build_cascade(m, gg, 12), 160,
                      monkeypatch)
    monkeypatch.setattr(tck, "_MODE", "1")
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16))
    g.edit(lambda gg: build_cascade(kt, gg, 12))
    parts = np.concatenate([proc.render(frames=32) for _ in range(5)], axis=1)
    np.testing.assert_array_equal(whole, parts)


def test_eventful_blocks_keep_the_scan_path(monkeypatch):
    """Events send their block to the scan executor; the blocks around them
    still take the kernel. The mixed run equals an all-scan run and the JAX
    package's mixed run."""
    def edits(hs):
        hs[7].param("phase_offset").set(0.3)
        hs[3].param("phase_offset").smooth(0.25, 0.005)

    def make(m, gg, hs):
        build_cascade(m, gg, 12, hs)

    calls = spy_run(monkeypatch)
    a, _ = render(kt, "1", make, 96, monkeypatch, edits=edits)
    assert calls["ok"] == 2 * 96 // 16 - 1  # the eventful block took the scan
    b, _ = render(kt, "0", make, 96, monkeypatch, edits=edits)
    np.testing.assert_array_equal(a, b)
    j, _ = render(jk, "1", make, 96, monkeypatch, edits=edits)
    np.testing.assert_allclose(a, j, rtol=0, atol=JAX_TOL)


def lookup_chain(m, gg, hs):
    """tests/test_chain_kernel.py: a cascade of table-lookup oscillators."""
    prev = None
    for i in range(10):
        s = gg.push(m.SinWt(100.0 + i, lookup=True))
        if prev is not None:
            mod = (prev * 100.0) + 200.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
        prev = s
    (prev * 0.1).to_graph_out()


def op_chain(op):
    """A cascade whose modulator passes through ``op``: a Math or Math1 op
    the kernel has no body for."""
    def make(m, gg, hs):
        prev = None
        for i in range(10):
            s = gg.push(m.SinWt(100.0 + i))
            if prev is not None:
                if op == "pow":
                    x = (prev + 2.0).pow(1.5)
                else:
                    u = gg.push(m.Math1UGen(op))
                    (prev * 3.0).to(u)
                    x = u
                mod = (x * 100.0) + 200.0
                gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
            prev = s
        (prev * 0.1).to_graph_out()
    return make


@pytest.mark.parametrize("make, dtype", [
    (lookup_chain, None), (op_chain("pow"), None), (op_chain("trunc"), None),
    (op_chain("fract"), None), (cascade16, torch.float64)],
    ids=["sinwt_lookup", "math_pow", "math1_trunc", "math1_fract", "f64"])
def test_unsupported_chain_returns_none(make, dtype, monkeypatch):
    """Where the JAX package's run() returns None (no Mosaic body, f64),
    the port's does too, and the scan executor renders."""
    calls = spy_run(monkeypatch)
    a, proc = render(kt, "1", make, 64, monkeypatch, dtype=dtype)
    assert "chain" in [k for k, _ in proc.compiled.plan]
    assert calls["run"] == 4 and calls["ok"] == 0
    b, _ = render(kt, "0", make, 64, monkeypatch, dtype=dtype)
    np.testing.assert_array_equal(a, b)


def body_chain(ops):
    """A cascade whose stage passes the modulator through three Math1 ops
    and a Math sub and div before (x * 100) + 200 drives the next sine."""
    def make(m, gg, hs):
        prev = None
        for i in range(9):
            s = gg.push(m.SinWt(100.0 + 3 * i))
            if prev is not None:
                x = prev + 1.5
                for op in ops:
                    u = gg.push(m.Math1UGen(op))
                    x.to(u)
                    x = u
                mod = (((x - 0.25) / 2.0) * 100.0) + 200.0
                gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
            prev = s
        (prev * 0.1).to_graph_out()
    return make


@pytest.mark.parametrize("ops", [("abs", "sqrt", "log"), ("exp", "sin", "cos"),
                                 ("tanh", "neg", "ceil"), ("floor", "neg", "abs")],
                         ids="-".join)
def test_every_body_matches_scan(ops, monkeypatch):
    """Each Math and Math1 body the kernel has, on the chain's plain path,
    equals the scan executor."""
    calls = spy_run(monkeypatch)
    a, proc = render(kt, "1", body_chain(ops), 64, monkeypatch)
    assert "chain" in [k for k, _ in proc.compiled.plan] and calls["ok"] == 4
    b, _ = render(kt, "0", body_chain(ops), 64, monkeypatch)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() > 1e-3


def test_lowered_program_of_the_cascade(monkeypatch):
    """The 16-stage cascade lowers to a 5-offset program: one carry (the
    previous stage's sine), five slots, one state word (the phase), one out
    plane (the last sine, read by the graph output); the wrapper's plain
    version reproduces a scan-executor block from it."""
    monkeypatch.setattr(tck, "_MODE", "1")
    got = []
    real = kck.chain_kernel

    def spy(program, **ops):
        got.append((program, ops))
        return real(program, **ops)

    monkeypatch.setattr(kck, "chain_kernel", spy)
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16))
    g.edit(lambda gg: build_cascade(kt, gg, 16))
    proc.render(frames=16)
    program, ops = got[0]
    assert (program.period, program.n_carry, program.n_slots, program.n_ext,
            program.n_state, program.n_out) == (5, 1, 5, 0, 1, 1)
    assert ops["planes"].shape == (program.n_planes, 15, 16)
    assert [r[0].name for r in program.records()] == [
        "constant", "math", "constant", "math", "sinwt"]
    out, state = kck.chain_kernel_plain(program, **ops)
    assert out.shape == (1, 15, 16) and state.shape == (1, 15)
    with pytest.raises(ValueError):
        kck.chain_kernel_plain(program, **dict(ops, rows=ops["rows"][:, :8]))
