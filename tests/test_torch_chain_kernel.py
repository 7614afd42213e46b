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
import knaster_tpu_torch.graph.compile as tC
import knaster_tpu_torch.graph.chain_kernel as tck
from knaster_tpu_torch.kernels import chain_kernel as kck

JAX_TOL = 1e-6


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    jC.clear_program_cache()
    tC.clear_program_cache()
    monkeypatch.setattr(tck, "_MODE", None)
    yield
    jC.clear_program_cache()
    tC.clear_program_cache()


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
                                   dtype=dtype, **({} if m is jk else {"device": "cpu"}))
    hs = []
    g.edit(lambda gg: make(m, gg, hs))
    outs = [np.asarray(proc.render(frames=frames))]
    if edits:
        edits(hs)
        outs.append(np.asarray(proc.render(frames=frames)))
    return np.concatenate(outs, axis=1), proc


def pieces(n_blocks):
    """Superblocks the renderer covers an event-free run of ``n_blocks``
    (at most a chunk) with: lengths halving from the chunk, so one per set
    bit of ``n_blocks`` (processor.render, as the JAX package splits it)."""
    return bin(n_blocks).count("1")


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
    # one kernel run per event-free superblock
    assert calls["ok"] == pieces(frames // 16)
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
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                    device="cpu")
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
    # six event-free blocks, then the eventful block (on the scan) and five
    assert calls["ok"] == pieces(96 // 16) + pieces(96 // 16 - 1)
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
    assert calls["run"] == pieces(64 // 16) and calls["ok"] == 0
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
    assert "chain" in [k for k, _ in proc.compiled.plan]
    assert calls["ok"] == pieces(64 // 16)
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
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                    device="cpu")
    g.edit(lambda gg: build_cascade(kt, gg, 16))
    proc.render(frames=16)
    program, ops = got[0]
    assert (program.period, program.n_carry, program.n_slots, program.n_ext,
            program.n_state, program.n_out, program.n_done,
            program.n_scratch) == (5, 1, 5, 0, 1, 1, 0, 0)
    assert ops["planes"].shape == (program.n_planes, 15, 16)
    assert [r[0].name for r in program.records()] == [
        "constant", "math", "constant", "math", "sinwt"]
    assert not program.all_bodies  # the kernel's small instantiation
    out, state, done = kck.chain_kernel_plain(program, **ops)
    assert out.shape == (1, 15, 16) and state.shape == (1, 15) and done.shape == (0, 15, 16)
    with pytest.raises(ValueError):
        kck.chain_kernel_plain(program, **dict(ops, rows=ops["rows"][:, :8]))


# --------------------------------------------------------------------------
# launch_plan: the layout of every launch, chosen on the host before it
# --------------------------------------------------------------------------

import chip_smoke  # noqa: E402  (the graphs chip_smoke.py drives the kernel with)


def _smoke_paths():
    paths = {"fm_cascade": lambda m, gg: chip_smoke.build_cascade(m, gg, chip_smoke.CASCADE)}
    paths.update(chip_smoke.chain_paths(kt))
    paths.update(chip_smoke.float_osc_paths(kt))
    paths.update(chip_smoke.noise_delay_paths(kt))
    return paths


SMOKE_PATHS = _smoke_paths()
PLAN_BLOCKS = (16, 64, 1024, 8192, 131072)
# the paths whose rows a cluster of 16 CTAs cannot hold at 131,072 samples
# (rows x 8192 x 4 bytes past a CTA's shared memory): the workspace there
GLOBAL_AT_131072 = {"graphic_eq_31", "phasor_cascade", "sin_numeric_cascade", "noise_chain"}


def smoke_program(name, monkeypatch):
    """The lowered program of a chip_smoke.py path, captured on the CPU."""
    monkeypatch.setattr(tck, "_MODE", "1")
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=64),
                                    device="cpu")
    g.edit(lambda gg: SMOKE_PATHS[name](kt, gg))
    program, ops = chip_smoke.capture_chain(torch, proc)
    return program, ops["K"]


@pytest.mark.parametrize("name", list(SMOKE_PATHS))
def test_launch_plan_of_every_smoke_path(name, monkeypatch):
    """For the program of every path chip_smoke.py builds, at B in
    PLAN_BLOCKS: one CTA with shared rows up to 1024 samples, a cluster of
    8 at 8192 and of 16 (or the workspace) at 131,072; the shared bytes are
    the kernel's layout and fit a CTA; the rows fit where a layout says
    they do; the workspace is taken only where no cluster holds the rows."""
    program, K = smoke_program(name, monkeypatch)
    n_rows = kck.row_floats(program, 1)
    for max_cluster in (kck.MAX_CLUSTER, kck.PORTABLE_CLUSTER):
        for B in PLAN_BLOCKS:
            plan = kck.launch_plan(program, B, K, max_cluster=max_cluster)
            assert plan.layout in kck.LAYOUTS
            assert plan.chunk * plan.cluster == B
            assert plan.threads == min(1024, (plan.chunk + 31) // 32 * 32)
            assert plan.smem_bytes == kck.smem_bytes(
                program, plan.chunk, plan.staged, plan.layout == "global",
                K if plan.staging == "whole" else 2)
            assert plan.staging in kck.STAGINGS
            # every stage staged before the loop only in one CTA, two stages
            # at a time only in a cluster of a long chain; a ring stages none
            assert plan.staging != "whole" or plan.cluster == 1
            assert plan.staging != "ring" or (plan.cluster > 1 and K >= kck.RING_STAGES)
            assert not (program.has_ring or plan.staging == "direct") or (
                plan.staging == "direct" and plan.staged == 0)
            assert plan.smem_bytes <= kck.SMEM_LIMIT
            assert 0 <= plan.staged <= program.n_planes
            rows_bytes = 4 * n_rows * ((plan.chunk + 3) // 4 * 4)
            if plan.layout == "shared":
                assert plan.cluster == 1 and B <= kck.SHARED_SAMPLES
                assert rows_bytes <= plan.smem_bytes
            elif plan.layout == "cluster":
                assert 2 <= plan.cluster <= max_cluster and plan.chunk % 32 == 0
                assert rows_bytes <= plan.smem_bytes
                assert plan.cluster in kck.cluster_sizes(program, B, max_cluster)
            else:
                # past every cluster's shared memory
                assert plan.cluster == 1
                assert not kck.cluster_sizes(program, B, max_cluster)
                assert kck.smem_bytes(program, B, 0) > kck.SMEM_LIMIT
            assert kck.rows_in_shared(program, B, max_cluster) == (plan.layout != "global")
        for B in (16, 64, 1024):
            plan = kck.launch_plan(program, B, K, max_cluster=max_cluster)
            assert (plan.layout, plan.cluster) == ("shared", 1)
            if K * B * 4 * program.n_planes <= kck.SMEM_LIMIT // 2 and not program.has_ring:
                assert (plan.staging, plan.staged) == ("whole", program.n_planes)
        plan = kck.launch_plan(program, 8192, K, max_cluster=max_cluster)
        C = min(max_cluster, 8192 // kck.CLUSTER_CHUNK)
        assert (plan.layout, plan.cluster, plan.chunk) == ("cluster", C, 8192 // C)
    plan = kck.launch_plan(program, 131072, K)
    if name in GLOBAL_AT_131072:
        assert plan.layout == "global"
    else:
        assert (plan.layout, plan.cluster, plan.chunk) == ("cluster", 16, 8192)


def test_launch_plan_of_forced_layouts(monkeypatch):
    """A forced cluster size or the forced workspace is taken as asked, or
    refused (ValueError) where it cannot hold the rows; the FM cascade's
    6144 samples (96 blocks of 64) split into chunks of 768."""
    program, K = smoke_program("fm_cascade", monkeypatch)
    for C in (2, 4, 8, 16):
        plan = kck.launch_plan(program, 8192, K, cluster=C)
        assert (plan.layout, plan.cluster, plan.chunk) == ("cluster", C, 8192 // C)
    assert kck.launch_plan(program, 8192, K, cluster=1).layout == "shared"
    plan = kck.launch_plan(program, 8192, K, global_rows=True)
    assert (plan.layout, plan.cluster, plan.chunk) == ("global", 1, 8192)
    plan = kck.launch_plan(program, 6144, K)
    assert (plan.layout, plan.chunk) == ("cluster", 6144 // plan.cluster)
    assert plan.chunk & (plan.chunk - 1)  # not a power of two
    for kw in (dict(cluster=1), dict(cluster=3), dict(global_rows=True, cluster=2)):
        with pytest.raises(ValueError):
            kck.launch_plan(program, 131072 if kw.get("cluster") == 1 else 8192, K, **kw)
    # an odd length takes no cluster (no chunk of whole warps)
    assert kck.launch_plan(program, 8191, K).layout == "global"
    plan = kck.launch_plan(program, 61, K)
    assert (plan.layout, plan.staging) == ("shared", "whole")
    assert kck.launch_plan(program, 8192, K).staging == "ring"  # K = 255
    assert kck.launch_plan(program, 1024, K).staging == "direct"  # no plane fits whole


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    """A chain kernel call on CPU tensors runs chain_kernel_plain and never
    the launch path; the launch itself refuses CPU tensors before it loads
    any library."""
    got = []
    monkeypatch.setattr(tck, "_MODE", "1")
    real = kck.chain_kernel

    def spy(program, **ops):
        got.append((program, ops))
        return real(program, **ops)

    monkeypatch.setattr(kck, "chain_kernel", spy)
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                    device="cpu")
    g.edit(lambda gg: build_cascade(kt, gg, 16))
    proc.render(frames=16)
    program, ops = got[0]

    def refuse(*a, **k):
        raise AssertionError("the launch path ran on CPU tensors")

    monkeypatch.setattr(kck, "launch", refuse)
    monkeypatch.setattr(kck, "_load", refuse)
    out, state, done = real(program, **ops)
    want = kck.chain_kernel_plain(program, **ops)
    for a, b in zip((out, state, done), want):
        assert torch.equal(a, b)
    monkeypatch.undo()
    monkeypatch.setattr(kck, "_load", refuse)
    outs = kck.empty_outputs(program, "cpu", ops["K"], ops["block_size"])
    with pytest.raises(ValueError, match="unsupported device"):
        kck.launch(outs, program, **ops)


def test_refused_launch_raises_by_name():
    """A launch the card refuses raises with the CUDA error's name and the
    plan it refused."""
    class Lib:
        @staticmethod
        def ktt_chain_error_name(err):
            return b"cudaErrorClusterOutOfResources"

        @staticmethod
        def ktt_error_string(err):
            return b"too many resources requested for launch"

    plan = kck.LaunchPlan("cluster", 16, 8192, 1024, 198896, 0, "direct")
    err = kck.launch_error(Lib, 721, plan)
    assert isinstance(err, RuntimeError)
    assert "cudaErrorClusterOutOfResources" in str(err) and "cluster 16" in str(err)
