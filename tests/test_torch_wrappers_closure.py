"""The port's wrappers, closures, ``sample_scan``, ``SafetyLimiter`` and
``DoneOnTrig`` against the JAX package.

Each case is written once over a module (``knaster_tpu`` or
``knaster_tpu_torch``) with operator-only arithmetic, so the same function
runs in both. The wrappers are held at ``process``, the JAX side op by op:
equal, ``WrPowf`` within 2 ulps (XLA's ``pow`` and torch's are separate
implementations); ``WrPowi`` multiplies in XLA's ``integer_pow`` order and
is held equal. A jitted JAX graph rewrites ``out / c`` into ``out * (1 /
c)`` (XLA's CPU backend, PERF.md §6), so the graph renders of a ``WrDiv``
agree within 1 ulp; graphs of ``SinWt`` within 1e-6 (``sin`` from XLA's
library and from torch's differ by an ulp at some table indices); the rest
equal. Ports tests/test_ugens_misc.py:285 (``ugen_from_sample_fn``) and
:312 (``WrArParamToInput``), and tests/test_subgraph.py:75 (``DoneOnTrig``
under ``Done.FREE_PARENT``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import PortInPlusParam, PortNum

import knaster_tpu as jk
import knaster_tpu.wrappers as jw
from tests.utils import TestInPlusParamUGen as JaxInPlusParam

import knaster_tpu_torch as kt
import knaster_tpu_torch.wrappers as tw
from knaster_tpu_torch.core.ugen import sample_scan as t_sample_scan

SR = 48000
B = 16


def _new(m, inputs=0, outputs=1, block=B, chunk=128):
    kw = {"device": "cpu"} if m is kt else {}
    opts = m.AudioProcessorOptions(block_size=block, render_chunk_blocks=chunk)
    return m.AudioProcessor.new(inputs, outputs, opts, **kw)


def _render(m, build, frames=4 * B, inputs=0, in_data=None, block=B, chunk=128):
    g, proc = _new(m, inputs, block=block, chunk=chunk)
    out = g.edit(lambda gg: build(m, gg))
    return np.asarray(proc.render(frames=frames, inputs=in_data)), g, proc, out


def _in_plus(m):
    return JaxInPlusParam() if m is jk else PortInPlusParam()


def _wrap(m):
    return jw if m is jk else tw


WRAPPERS = (("WrMul", 0.5), ("WrAdd", 0.25), ("WrSub", 0.3), ("WrVSub", 0.7),
            ("WrDiv", 3.0), ("WrVDiv", 2.0), ("WrPowf", 1.7), ("WrPowi", 3),
            ("WrPowi", 5), ("WrPowi", -2), ("WrPowi", 0))


def _process(m, u, x, number=0.05):
    """One block of ``u`` on inputs ``x`` [1, n], the JAX side op by op."""
    n = x.shape[-1]
    if m is jk:
        ctx = jk.AudioCtx(SR, n, np.float32)
        r = u.process(ctx, u.init(ctx), jnp.asarray(x), {"number": jnp.full((n,), number)})
        return np.asarray(r[1])
    ctx = kt.AudioCtx(SR, n)
    r = u.process(ctx, u.init(ctx), torch.from_numpy(x), {"number": torch.full((n,), number)})
    return r[1].numpy()


@pytest.mark.parametrize("cls, c", WRAPPERS, ids=[f"{n}({c})" for n, c in WRAPPERS])
def test_wrapper_matches_jax(cls, c):
    x = np.random.default_rng(4).uniform(0.1, 2.0, (1, 4 * B)).astype(np.float32)
    a = _process(jk, getattr(jw, cls)(_in_plus(jk), c), x)
    b = _process(kt, getattr(tw, cls)(_in_plus(kt), c), x)
    if cls == "WrPowf":
        np.testing.assert_array_max_ulp(b, a, maxulp=2)
    else:
        np.testing.assert_array_equal(b, a)
    assert np.abs(b).max() > 0.01


def test_wrapped_graph_matches_jax():
    """A WrDiv in a jitted JAX graph: XLA multiplies by the reciprocal."""
    x = np.random.default_rng(9).uniform(0.1, 2.0, (1, 4 * B)).astype(np.float32)

    def build(m, gg):
        n = gg.push(getattr(_wrap(m), "WrDiv")(_in_plus(m), 3.0))
        gg.from_inputs(0).to(n)
        n.to_graph_out()

    a, *_ = _render(jk, build, inputs=1, in_data=x)
    b, *_ = _render(kt, build, inputs=1, in_data=x)
    np.testing.assert_array_max_ulp(b, a, maxulp=1)
    np.testing.assert_array_equal(b, (x + np.float32(0.0)) / np.float32(3.0))


def _fluent(m):
    return (_in_plus(m).wr(lambda o: o * o - o).wr_add(0.5).wr_sub(0.25).wr_v_sub(1.0)
            .wr_mul(2.0).wr_div(4.0).wr_v_div(3.0).wr_powi(2).wr_powf(1.5)
            .smooth_params().ar_params().precise_timing(4))


def test_wr_closure_and_fluent_forms_match_jax():
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (1, 4 * B)).astype(np.float32)
    u = _fluent(kt)
    np.testing.assert_array_max_ulp(_process(kt, u, x), _process(jk, _fluent(jk), x),
                                    maxulp=2)
    assert isinstance(u, tw.WrPowf) and isinstance(u.inner, tw.WrPowi)
    assert u.name() == "WrPowf(WrPowi(WrVDiv(WrDiv(WrMul(WrVSub(WrSub(WrAdd(WrClosure(" \
        "PortInPlusParam)))))))))"
    assert u.inner.inner.inner.inner.inner.inner.inner.inner.batch_key() is None  # WrClosure
    assert u.params == PortInPlusParam.params


def test_integer_pow_order_is_xla_s():
    """Square and multiply: x^5 = x * (x^2)^2, not ((((x x) x) x) x)."""
    x = torch.from_numpy(np.random.default_rng(6).uniform(0.5, 1.5, 4096).astype(np.float32))
    got = tw.math.integer_pow(x, 5)
    x2 = x * x
    np.testing.assert_array_equal(got.numpy(), (x * (x2 * x2)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x.numpy()) ** 5))
    np.testing.assert_array_equal(tw.math.integer_pow(x, -3).numpy(),
                                  np.asarray(jnp.asarray(x.numpy()) ** -3))


def test_two_wrapped_sines_batch_at_one_depth():
    def build(m, gg):
        for f in (440.0, 660.0):
            gg.push(m.SinWt(f).wr_mul(0.25)).to_graph_out()
        gg.push(m.SinWt(880.0).wr_mul(0.5)).to_graph_out()  # another constant

    a, _, jproc, _ = _render(jk, build, frames=8 * B)
    b, _, tproc, _ = _render(kt, build, frames=8 * B)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    for proc in (jproc, tproc):
        sizes = sorted(len(it) for k, it in proc.compiled.plan if k == "batch")
        assert sizes == [2], proc.compiled.plan
    assert tw.WrMul(kt.SinWt(), 0.25).batch_key() != tw.WrMul(kt.SinWt(), 0.5).batch_key()


def test_wr_ar_param_to_input_matches_jax():
    """tests/test_ugens_misc.py:312: channel 1 drives the param."""

    def build(m, gg):
        lfo = gg.push(m.Phasor(48000.0 / 16.0))
        u = _wrap(m).WrArParamToInput(_in_plus(m), "number")
        wrapped = gg.push(u)
        gg.connect(lfo, 0, 1, wrapped)
        wrapped.to_graph_out()
        return u

    a, *_ = _render(jk, build, frames=B)
    b, _, _, u = _render(kt, build, frames=B)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(b[0], np.arange(16) / 16.0, atol=1e-6)
    assert u.inputs == 2 and u.name() == "WrArParamToInput(PortInPlusParam.number)"
    with pytest.raises(TypeError, match="only float parameters"):
        tw.WrArParamToInput(kt.DoneOnTrig(), "t_done")


def _closure(m, form):
    """A ClosureUGen in one of its three return forms: out; (state, out);
    (state, out, done). Stateful forms count blocks."""

    def fn(ctx, st, inp, par):
        out = inp * 2.0 + par["gain"][None, :]
        if form == "out":
            return out
        new = {"n": st["n"] + 1.0}
        out = out + st["n"]
        if form == "state":
            return new, out
        return new, out, inp[0] > 0.5

    zeros = (lambda ctx: {"n": jnp.zeros((), ctx.dtype)}) if m is jk else \
        (lambda ctx: {"n": torch.zeros((), dtype=ctx.dtype)})
    return m.ClosureUGen(fn, inputs=1, outputs=1, params=(m.pfloat("gain", 0.125),),
                         init_state=None if form == "out" else zeros, name=f"c_{form}")


@pytest.mark.parametrize("form", ["out", "state", "done"])
def test_closure_ugen_forms_match_jax(form):
    x = np.random.default_rng(7).uniform(0.0, 1.0, (1, 4 * B)).astype(np.float32)

    def build(m, gg):
        u = _closure(m, form)
        n = gg.push(u)
        gg.from_inputs(0).to(n)
        n.to_graph_out()
        return u

    for chunk in (128, 1):  # superblocked, and block by block
        a, *_ = _render(jk, build, inputs=1, in_data=x, chunk=chunk)
        b, _, _, u = _render(kt, build, inputs=1, in_data=x, chunk=chunk)
        np.testing.assert_array_equal(b, a)
    assert u.name() == f"c_{form}" and u.may_set_done
    # block by block, the stateful forms' block counter reaches the output
    assert np.allclose(b[0], x[0] * 2.0 + 0.125) == (form == "out")


def test_closure_voice_in_a_voice_bank_sees_one_instance():
    """The batch-axis hazard: the port's VoiceBank passes [V, B] params; the
    closure's function still sees one voice's [B] params, as under the JAX
    VoiceBank's vmap."""
    V = 6
    seen = []

    def voice(m):
        def fn(ctx, st, inp, par):
            seen.append(tuple(par["freq"].shape))
            return par["freq"][None, :] * 0.001 + st["n"]

        init = (lambda ctx: {"n": jnp.full((), 0.5, ctx.dtype)}) if m is jk else \
            (lambda ctx: {"n": torch.full((), 0.5, dtype=ctx.dtype)})
        return m.ClosureUGen(fn, 0, 1, (m.pfloat("freq", 100.0),), init)

    d = {"freq": np.linspace(100.0, 600.0, V).astype(np.float32)}
    jb = jk.VoiceBank(voice(jk), V, voice_defaults=d, mix="stack")
    tb = kt.VoiceBank(voice(kt), V, voice_defaults=d, mix="stack")
    jctx, tctx = jk.AudioCtx(SR, B, np.float32), kt.AudioCtx(SR, B)
    _, oj, _ = jb.process(jctx, jb.init(jctx), jnp.zeros((0, B)), {})
    seen.clear()
    _, ot, _ = tb.process(tctx, tb.init(tctx, device="cpu"), None, None)
    assert set(seen) == {(B,)}
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_ugen_from_sample_fn_matches_jax():
    """tests/test_ugens_misc.py:285."""
    x = np.linspace(-1, 1, 64, dtype=np.float32)[None, :]

    def build(m, gg):
        sq = gg.push(m.ugen_from_sample_fn(lambda f: f * f, inputs=1, outputs=1))
        gg.from_inputs(0).to(sq)
        sq.to_graph_out()

    a, *_ = _render(jk, build, frames=64, inputs=1, in_data=x, block=64)
    b, *_ = _render(kt, build, frames=64, inputs=1, in_data=x, block=64)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(b[0], x[0] ** 2, atol=1e-7)

    # no inputs: the function gets [0]-sample frames
    u = kt.ugen_from_sample_fn(lambda f: torch.ones(2) * 0.5 + f.sum(), inputs=0, outputs=2)
    _, out = u.process(kt.AudioCtx(SR, B), {}, torch.zeros(0, B), {})
    np.testing.assert_array_equal(out.numpy(), np.full((2, B), 0.5, np.float32))


def _scan_closure(m, with_done):
    """A per-sample counter through each package's ``sample_scan``: out =
    the count plus the input, done once the count reaches 21."""
    where = jnp.where if m is jk else torch.where
    stack = (lambda xs: jnp.stack(xs)) if m is jk else (lambda xs: torch.stack(xs))
    scan = jk.sample_scan if m is jk else t_sample_scan

    def step(carry, frame):
        n = carry["n"] + frame["step"]
        out = stack([n + frame["in"][0]])
        if with_done:
            return {"n": n}, (out, n >= 21.0)
        return {"n": where(n > 100.0, n * 0.0, n)}, out

    def fn(ctx, st, inp, par):
        return scan(step, st, ctx, inp, par, n_out=1, with_done=with_done)

    init = (lambda ctx: {"n": jnp.zeros((), ctx.dtype)}) if m is jk else \
        (lambda ctx: {"n": torch.zeros((), dtype=ctx.dtype)})
    return m.ClosureUGen(fn, 1, 1, (m.pfloat("step", 1.0),), init)


@pytest.mark.parametrize("with_done", [False, True], ids=["plain", "with_done"])
def test_sample_scan_matches_jax(with_done):
    x = np.random.default_rng(8).uniform(-1, 1, (1, 4 * B)).astype(np.float32)

    def build(m, gg):
        n = gg.push(_scan_closure(m, with_done))
        gg.from_inputs(0).to(n)
        n.to_graph_out()
        n.param("step").set_at(2.5, m.Seconds.from_samples(9, SR))

    a, *_ = _render(jk, build, inputs=1, in_data=x)
    b, *_ = _render(kt, build, inputs=1, in_data=x)
    np.testing.assert_array_equal(b, a)
    # directly: [n_out, B] outputs and a [B] done row
    ctx = kt.AudioCtx(SR, B)
    st, out, done = t_sample_scan(
        lambda c, f: ({"n": c["n"] + 1.0}, (torch.stack([c["n"], -c["n"]]), c["n"] > 3.0)),
        {"n": torch.zeros(())}, ctx, None, {}, n_out=2, with_done=True)
    assert out.shape == (2, B) and done.shape == (B,) and float(st["n"]) == B
    np.testing.assert_array_equal(done.numpy(), np.arange(B) > 3)


def test_safety_limiter_matches_jax():
    x = np.array([[np.nan, np.inf, -np.inf, 2.0, -2.0, 0.5, -0.25, 1.0, -1.0, 0.0,
                   1.0000001, -0.9999999, 3e38, -3e38, np.nan, 0.75]], np.float32)
    jl, tl = jk.SafetyLimiter(), kt.SafetyLimiter()
    _, oj = jl.process(jk.AudioCtx(SR, B, np.float32), {}, jnp.asarray(x), {})
    _, ot = tl.process(kt.AudioCtx(SR, B), {}, torch.from_numpy(x), {})
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(ot[0, :5].numpy(), [0.0, 1.0, -1.0, 1.0, -1.0])
    assert tl.batch_key() == (kt.SafetyLimiter,)
    # leading batch axes pass through
    _, o2 = tl.process(kt.AudioCtx(SR, B), {}, torch.from_numpy(np.stack([x, -x])), {})
    assert o2.shape == (2, 1, B)


def test_done_on_trig_frees_its_subgraph():
    """tests/test_subgraph.py:75 on the port: a child node with
    Done.FREE_PARENT frees its enclosing subgraph."""
    g, proc = _new(kt)

    def build(g):
        child, ch = g.subgraph(inputs=0, outputs=1, name="voice")
        n = child.push(PortNum(1.0))
        n.to_graph_out()
        d = child.push_with_done_action(kt.DoneOnTrig(), kt.Done.FREE_PARENT)
        keep = g.push(PortNum(0.25))
        ch.to_graph_out()
        keep.to_graph_out()
        return d.param("t_done"), ch.id()

    trig, chid = g.edit(build)
    proc.run_without_inputs()
    assert proc.output_block()[0, 0] == 1.25
    trig.trig()
    proc.run_without_inputs()  # done fires; the subgraph is freed after this block
    proc.run_without_inputs()
    assert proc.output_block()[0, 0] == pytest.approx(0.25)
    assert chid not in g.nodes


def test_done_on_trig_process_matches_jax():
    trig = np.zeros((3, B), bool)
    trig[1, 5] = True
    ju, tu = jk.DoneOnTrig(), kt.DoneOnTrig()
    jctx, tctx = jk.AudioCtx(SR, B, np.float32), kt.AudioCtx(SR, B)
    sj, st = ju.init(jctx), tu.init(tctx)
    assert tu.may_set_done and tu.inputs == 0 and tu.outputs == 0
    for blk in range(3):
        sj, oj, dj = ju.process(jctx, sj, jnp.zeros((0, B)), {"t_done": jnp.asarray(trig[blk])})
        st, ot, dt = tu.process(tctx, st, torch.zeros(0, B),
                                {"t_done": torch.from_numpy(trig[blk])})
        assert ot.shape == (0, B)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        assert bool(st["triggered"]) == bool(sj["triggered"])
    assert dt.all()
