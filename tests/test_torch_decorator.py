"""The port's ``@ugen`` decorator against the JAX package's.

Ports tests/test_decorator_checkpoint.py:19-140 (the block form, the
per-sample form with a trigger, the inference errors, the flexible
signatures) and tests/test_hints.py:58 (a ``Param`` default keeps its
hints under the keyword's name), each rendered through both packages'
graphs and held equal (the functions use exact arithmetic only). The
inferred parameter tables must be the JAX package's, field for field. A
decorated UGen's state survives ``save_state``/``load_state``. The
batch-axis hazard: a decorated voice inside the port's ``VoiceBank``
(which passes ``[V, ...]`` state and ``[V, B]`` params) sees one instance,
as under the JAX ``VoiceBank``'s vmap, and the banks agree exactly.
"""

import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knaster_tpu as jk

import knaster_tpu_torch as kt

SR = 48000
B = 16


def _new(m, inputs=0, outputs=1, block=B):
    kw = {"device": "cpu"} if m is kt else {}
    return m.AudioProcessor.new(inputs, outputs, m.AudioProcessorOptions(block_size=block),
                                **kw)


def _gain(m):
    @m.ugen(inputs=1, outputs=1)
    def gain(ctx, state, inputs, *, amount=1.0):
        return state, inputs * amount[None, :]

    return gain


def test_block_form_matches_jax():
    outs = {}
    for m in (jk, kt):
        g, proc = _new(m, 1)

        def build(gg):
            n = gg.push(_gain(m)(amount=0.5))
            gg.from_inputs(0).to(n)
            n.to_graph_out()
            return n.param("amount")

        p = g.edit(build)
        x = np.ones((1, B), np.float32)
        proc.run(x)
        first = proc.output_block()[0].copy()
        p.set_at(2.0, m.Seconds.from_samples(24, SR))  # sample-accurate for free
        proc.run(x)
        outs[m] = np.concatenate([first, proc.output_block()[0]])
    np.testing.assert_array_equal(outs[kt], outs[jk])
    np.testing.assert_array_equal(outs[kt], [0.5] * 24 + [2.0] * 8)


def _counter(m):
    if m is jk:
        @jk.ugen.sample(inputs=0, outputs=1,
                        state=lambda ctx: {"count": jnp.zeros((), jnp.int32)})
        def counter(carry, frame, *, t_reset=jk.TRIG, step=1):
            c = jnp.where(t_reset, 0, carry["count"])
            return {"count": c + step}, jnp.asarray([c], jnp.float32)
    else:
        @kt.ugen.sample(inputs=0, outputs=1,
                        state=lambda ctx: {"count": torch.zeros((), dtype=torch.int32)})
        def counter(carry, frame, *, t_reset=kt.TRIG, step=1):
            c = torch.where(t_reset, 0, carry["count"])
            return {"count": c + step}, c.to(torch.float32).reshape(1)
    return counter


def test_sample_form_with_trigger_matches_jax():
    outs = {}
    for m in (jk, kt):
        g, proc = _new(m)

        def build(gg):
            n = gg.push(_counter(m)(step=2))
            n.to_graph_out()
            return n

        n = g.edit(build)
        n.param("t_reset").trig_at(m.Seconds.from_samples(5, SR))
        n.param("step").set_at(3, m.Seconds.from_samples(27, SR))
        outs[m] = np.asarray(proc.render(frames=3 * B))
    np.testing.assert_array_equal(outs[kt], outs[jk])
    np.testing.assert_array_equal(outs[kt][0, :5], 2 * np.arange(5))
    np.testing.assert_array_equal(outs[kt][0, 5:16], 2 * np.arange(11))


class Mode(enum.IntEnum):
    A = 0
    B = 1
    C = 2


def test_inferred_params_match_jax():
    def fns(m):
        def f(ctx, state, inputs, *, freq=440.0, on=True, n=3, mode=Mode.C, t=m.TRIG,
              amp=m.pfloat(0.5, range=(0.0, 1.0)),
              hz=m.pfloat(220.0, kind=m.ParameterKind.FREQUENCY,
                          range=(20.0, m.NYQUIST), logarithmic=True)):
            return state, inputs

        return m.ugen(inputs=1, outputs=1)(f)

    a, b = fns(jk).params, fns(kt).params
    assert [p.name for p in b] == ["freq", "on", "n", "mode", "t", "amp", "hz"]
    for pj, pt in zip(a, b):
        assert pt.name == pj.name and pt.ptype == pj.ptype and pt.default == pj.default
        assert repr(pt.hint) == repr(pj.hint)
        assert pt.kind.value == pj.kind.value


def test_inference_errors_match_jax():
    for m in (jk, kt):
        with pytest.raises(TypeError, match="cannot infer a parameter type"):
            @m.ugen()
            def bad(ctx, state, inputs, *, weird="str"):
                return state, inputs

        with pytest.raises(TypeError, match="needs a default"):
            @m.ugen()
            def nodefault(ctx, state, inputs, *, x):
                return state, inputs

        with pytest.raises(TypeError, match="subset of ctx/state/inputs"):
            @m.ugen(inputs=0, outputs=1)
            def banana(banana, *, x=1.0):
                return banana

        with pytest.raises(TypeError, match="unknown parameter 'volume'"):
            _gain(m)(volume=0.5)


def test_flexible_signatures_match_jax():
    def units(m):
        ones = (lambda ctx: jnp.ones((1, ctx.block_size), ctx.dtype)) if m is jk else \
            (lambda ctx: torch.ones((1, ctx.block_size), dtype=ctx.dtype))

        @m.ugen(inputs=0, outputs=1)
        def just_params(ctx, *, level=0.25):
            return level[None, :] * ones(ctx)

        @m.ugen(inputs=1, outputs=1)
        def gain_no_ctx(inp, *, amount=2.0):
            return inp * amount[None, :]

        @m.ugen(inputs=1, outputs=1, name="renamed",
                state=(lambda ctx: {"k": jnp.full((), 3.0, ctx.dtype)}) if m is jk else
                (lambda ctx: {"k": torch.full((), 3.0, dtype=ctx.dtype)}))
        def st_first(st, input):
            return {"k": st["k"] + 1.0}, input * st["k"]

        return just_params, gain_no_ctx, st_first

    outs = {}
    for m in (jk, kt):
        g, proc = _new(m)
        jp, gn, sf = units(m)

        def build(gg):
            src, amp, mul = gg.push(jp()), gg.push(gn()), gg.push(sf())
            src.to(amp)
            amp.to(mul)
            mul.to_graph_out()

        g.edit(build)
        outs[m] = np.asarray(proc.render(frames=4 * B))
        assert sf().name() == "renamed" and type(sf()).__name__ == "renamed"
    np.testing.assert_array_equal(outs[kt], outs[jk])
    np.testing.assert_allclose(outs[kt][0, :B], 1.5)


def test_param_declaration_keeps_its_hints():
    """tests/test_hints.py:58 on the port."""

    @kt.ugen(inputs=0, outputs=1)
    def osc(ctx, state, inputs, *,
            freq=kt.pfloat(440.0, kind=kt.ParameterKind.FREQUENCY,
                           range=(20.0, kt.NYQUIST), logarithmic=True),
            amp=kt.pfloat(0.5, range=(0.0, 1.0))):
        return state, (amp * (freq * 0.0 + 1.0))[None, :]

    g, proc = _new(kt, block=64)
    h = g.edit(lambda gg: (lambda hh: (hh.to_graph_out(), hh)[1])(gg.push(osc(freq=220.0))))
    hints = h.param_hints()
    assert hints["freq"].minimum == 20.0
    assert hints["freq"].maximum == 24000.0
    assert hints["freq"].logarithmic
    assert hints["amp"] == kt.FloatHint(minimum=0.0, maximum=1.0, default=0.5,
                                        logarithmic=False)
    out = proc.render(frames=64)
    np.testing.assert_allclose(out[0], 0.5, atol=1e-7)


def test_decorated_state_survives_a_checkpoint(tmp_path):
    path = str(tmp_path / "ckpt.pkl")

    def make():
        g, proc = _new(kt)
        g.edit(lambda gg: gg.push(_counter(kt)(step=3)).to_graph_out())
        return proc

    p1 = make()
    p1.render(frames=3 * B + 5)  # not block-aligned: the pending samples too
    p1.save_state(path)
    cont = p1.render(frames=2 * B)
    p2 = make()
    p2.load_state(path)
    np.testing.assert_array_equal(p2.render(frames=2 * B), cont)
    assert cont[0, 0] == 3 * (3 * B + 5)


def _voice(m, sample_form):
    """A decorated voice: a saw whose phase is its state, per block or per
    sample; it fails if it sees more than one instance's shapes."""
    zeros = (lambda ctx: {"ph": jnp.zeros((), ctx.dtype)}) if m is jk else \
        (lambda ctx: {"ph": torch.zeros((), dtype=ctx.dtype)})
    if sample_form:
        @m.ugen.sample(inputs=0, outputs=1, state=zeros)
        def saw(carry, frame, *, freq=100.0, amp=0.5, t_restart=m.TRIG):
            assert freq.shape == () and carry["ph"].shape == ()
            ph = carry["ph"] * (1.0 - t_restart * 1.0)
            nxt = ph + freq * np.float32(1.0 / 1024.0)
            over = (nxt >= 1.0) * 1.0
            out = (ph * amp)[None] if m is jk else (ph * amp).reshape(1)
            return {"ph": nxt - over}, out
    else:
        @m.ugen(inputs=0, outputs=1, state=zeros)
        def saw(ctx, state, *, freq=100.0, amp=0.5, t_restart=m.TRIG):
            assert freq.shape == (ctx.block_size,) and state["ph"].shape == ()
            ph = state["ph"] + freq * np.float32(1.0 / 1024.0)
            ph = ph - (ph >= 1.0) * 1.0
            return {"ph": ph[-1]}, (ph * amp)[None, :]
    return saw()


@pytest.mark.parametrize("sample_form", [False, True], ids=["block", "sample"])
def test_decorated_voice_in_a_voice_bank_matches_jax(sample_form):
    V = 8
    d = {"freq": np.linspace(50.0, 400.0, V).astype(np.float32)}
    jb = jk.VoiceBank(_voice(jk, sample_form), V, voice_defaults=d, mix="stack")
    tb = kt.VoiceBank(_voice(kt, sample_form), V, voice_defaults=d, mix="stack")
    jctx, tctx = jk.AudioCtx(SR, B, np.float32), kt.AudioCtx(SR, B)
    sj, st = jb.init(jctx), tb.init(tctx, device="cpu")
    tr = tb.trig_index("t_restart")
    for blk, evs in enumerate([None, [(3, 2, tr, 1, 0.0), (9, 5, tr, 1, 0.0)], None]):
        ej = None if evs is None else jb.node_events_from_lists(evs)
        et = None if evs is None else tb.node_events_from_lists(evs)
        sj, oj, _ = jb.process(jctx, sj, jnp.zeros((0, B)), {}, events=ej)
        st, ot, _ = tb.process(tctx, st, None, None, events=et)
        assert ot.shape == (V, B)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj), err_msg=f"block {blk}")
    np.testing.assert_array_equal(st["voices"]["ph"].numpy(), np.asarray(sj["voices"]["ph"]))
