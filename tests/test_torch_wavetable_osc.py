"""The port's wavetables, XOrShift32 and ``OscWt`` against the JAX package.

The tables are float64 numpy on the host in both packages, so every
``NonAaWavetable`` and ``Wavetable`` builder (``add_noise`` included, over
the port's own XOrShift32) must give the same buffers bit for bit, and
``stacked`` the same f32 and f64 tables.

``OscWt.process`` is held against the JAX package's, called op by op (no
jit, so XLA rewrites nothing: a jitted block may fold the interpolation's
division by 65535 into a multiply), block by block over a 20 Hz -> 20 kHz
glide that crosses all 17 tables, the thresholds themselves, a negative
frequency, a phase offset and reset triggers, at f32 and f64, nearest and
interpolated: the u32 phase and the output bit-equal. The graph test ports
tests/test_coverage_extras.py:73 (the interpolated read is the smoother).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knaster_tpu as jk
from knaster_tpu.ugens import wavetable as jwt
from knaster_tpu.utils.xorrng import XOrShift32Rng as JaxRng

import knaster_tpu_torch as kt
from knaster_tpu_torch.ugens import wavetable as twt
from knaster_tpu_torch.utils.xorrng import XOrShift32Rng

SR = 48000

NON_AA_BUILDERS = ("sine", "cosine", "aliasing_saw", "hann_window", "hamming_window",
                   "sine_window")
# (method, args) applied in turn to a table built from the sine
NON_AA_METHODS = (
    ("fill", (0.25,)),
    ("add_sine", (3.0, 0.5, 0.7)),
    ("fill_sine", (7, 2.0)),
    ("add_saw", (2, 40, 0.8)),
    ("add_odd_harmonics", (9, 1.3)),
    ("add_noise", (0.3, 12345)),
    ("add_noise", (0.9, 0)),
    ("multiply", (-0.7,)),
)
AA_BUILDERS = NON_AA_BUILDERS + ("saw",)
AA_METHODS = (
    ("fill", (0.1,)),
    ("add_sine", (5.0, 0.5, 0.2)),
    ("add_sine", (700.0, 0.5, 0.0)),
    ("fill_sine", (30, 1.5)),
    ("add_aliasing_saw", (200, 0.3)),
    ("add_saw", (10, 300, 0.5)),
    ("add_odd_harmonics", (120, 1.0)),
    ("multiply", (0.5,)),
    ("normalize", ()),
)


def test_xorshift_matches():
    for seed in (0, 1, 17, 2**32 - 1, 2**33 + 5):
        a, b = JaxRng(seed), XOrShift32Rng(seed)
        assert [a.gen_u32() for _ in range(64)] == [b.gen_u32() for _ in range(64)]
        assert [a.gen_f32() for _ in range(64)] == [b.gen_f32() for _ in range(64)]
        assert [a.gen_f64() for _ in range(64)] == [b.gen_f64() for _ in range(64)]


def test_aa_ladder_matches():
    np.testing.assert_array_equal(twt.AA_FREQ_THRESHOLDS, jwt.AA_FREQ_THRESHOLDS)
    assert twt.AA_FREQ_THRESHOLDS.dtype == np.float32
    for f in (0.0, 31.9, 32.0, 32.1, 48.0, 440.0, 14013.9, 1e5, -5.0):
        assert twt.freq_to_table_index(f) == jwt.freq_to_table_index(f)
    for i in range(twt.NUM_AA_TABLES):
        assert twt.table_index_to_max_freq_produced(i) == jwt.table_index_to_max_freq_produced(i)
        assert twt.table_index_to_max_harmonic(i) == jwt.table_index_to_max_harmonic(i)


@pytest.mark.parametrize("builder", NON_AA_BUILDERS)
def test_non_aa_builder_bit_equal(builder):
    a = getattr(jwt.NonAaWavetable, builder)()
    b = getattr(twt.NonAaWavetable, builder)()
    np.testing.assert_array_equal(b.buffer, a.buffer)
    np.testing.assert_array_equal(b.diff_buffer(), a.diff_buffer())


@pytest.mark.parametrize("method, args", NON_AA_METHODS,
                         ids=[f"{m}{i}" for i, (m, _) in enumerate(NON_AA_METHODS)])
def test_non_aa_method_bit_equal(method, args):
    a, b = jwt.NonAaWavetable.sine(), twt.NonAaWavetable.sine()
    getattr(a, method)(*args)
    getattr(b, method)(*args)
    np.testing.assert_array_equal(b.buffer, a.buffer)
    assert np.any(b.buffer != twt.NonAaWavetable.sine().buffer)


def test_non_aa_rejects_a_wrong_length():
    with pytest.raises(ValueError, match="16384 samples"):
        twt.NonAaWavetable(np.zeros(100))


@pytest.mark.parametrize("builder", AA_BUILDERS)
def test_aa_builder_bit_equal(builder):
    a = getattr(jwt.Wavetable, builder)()
    b = getattr(twt.Wavetable, builder)()
    for dtype in (np.float32, np.float64):
        for x, y in zip(b.stacked(dtype), a.stacked(dtype)):
            assert x.dtype == dtype and x.shape == (17, twt.TABLE_SIZE)
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("method, args", AA_METHODS,
                         ids=[f"{m}{i}" for i, (m, _) in enumerate(AA_METHODS)])
def test_aa_method_bit_equal(method, args):
    a, b = jwt.Wavetable.sine(), twt.Wavetable.sine()
    getattr(a, method)(*args)
    getattr(b, method)(*args)
    for x, y in zip(b.partial_tables, a.partial_tables):
        np.testing.assert_array_equal(x.buffer, y.buffer)


def test_aa_from_buffer_and_closure_bit_equal():
    buf = np.random.default_rng(3).uniform(-1, 1, twt.TABLE_SIZE)

    def fill(b):
        b[:] = np.tanh(np.linspace(-3, 3, twt.TABLE_SIZE))

    for make in (lambda m: m.Wavetable.from_buffer(buf),
                 lambda m: m.Wavetable.from_closure(fill)):
        a, b = make(jwt), make(twt)
        np.testing.assert_array_equal(b.stacked(np.float64)[0], a.stacked(np.float64)[0])


def _glide(B, n_blocks):
    """Per-block freq rows: a 20 Hz -> 20 kHz exponential glide over the
    blocks, with each threshold of the ladder and a negative frequency
    placed in block 1."""
    f = 20.0 * 1000.0 ** (np.arange(n_blocks * B) / (n_blocks * B - 1))
    f[B: B + 16] = jwt.AA_FREQ_THRESHOLDS
    f[B + 16] = -300.0
    return f.reshape(n_blocks, B)


@pytest.mark.parametrize("interpolate", [False, True], ids=["nearest", "interpolated"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_oscwt_process_matches_jax(dtype, interpolate):
    B, n_blocks = 64, 8
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    freqs = _glide(B, n_blocks).astype(dtype)
    offsets = np.zeros((n_blocks, B), dtype)
    offsets[2] = 0.37
    offsets[3] = np.linspace(0.0, 0.9, B)
    resets = np.zeros((n_blocks, B), bool)
    resets[4, 17] = resets[4, 40] = resets[6, 0] = True
    with jax.enable_x64(dtype == np.float64):
        jo = jk.OscWt(jk.Wavetable.saw(), 20.0, interpolate=interpolate)
        to = kt.OscWt(kt.Wavetable.saw(), 20.0, interpolate=interpolate)
        sj = jo.init(jk.AudioCtx(SR, B, dtype))
        st = to.init(kt.AudioCtx(SR, B, tdtype))
        np.testing.assert_array_equal(st["tables"].numpy(), np.asarray(sj["tables"]))
        for blk in range(n_blocks):
            no_events = not resets[blk].any() and blk % 2 == 1
            jctx = jk.AudioCtx(SR, B, dtype, no_events=no_events)
            tctx = kt.AudioCtx(SR, B, tdtype, no_events=no_events)
            jp = {"freq": jnp.asarray(freqs[blk]), "phase_offset": jnp.asarray(offsets[blk]),
                  "reset_phase": jnp.asarray(resets[blk])}
            tp = {"freq": torch.from_numpy(freqs[blk]),
                  "phase_offset": torch.from_numpy(offsets[blk]),
                  "reset_phase": torch.from_numpy(resets[blk])}
            sj, oj = jo.process(jctx, sj, jnp.zeros((0, B), dtype), jp)
            st, ot = to.process(tctx, st, torch.zeros((0, B), dtype=tdtype), tp)
            assert ot.shape == (1, B) and ot.dtype == tdtype
            np.testing.assert_array_equal(ot.numpy(), np.asarray(oj), err_msg=f"block {blk}")
            np.testing.assert_array_equal(st["phase"].numpy().view(np.uint32),
                                          np.asarray(sj["phase"]), err_msg=f"block {blk}")


def test_oscwt_reads_every_table_and_batches_over_leading_axes():
    """The glide selects all 17 tables; a [2, B] batch (a voice bank's
    leading axis) gives each row what a single instance gives."""
    B = 64
    ctx = kt.AudioCtx(SR, B)
    osc = kt.OscWt(kt.Wavetable.saw(), interpolate=True)
    freqs = torch.from_numpy(_glide(B, 8).astype(np.float32))
    idx = torch.searchsorted(torch.from_numpy(twt.AA_FREQ_THRESHOLDS), freqs)
    assert set(idx.flatten().tolist()) == set(range(17))
    st1 = osc.init(ctx)
    st2 = {k: torch.stack([v, v]) for k, v in osc.init(ctx).items()}
    st2["phase"] = torch.tensor([0, 123456789], dtype=torch.int32)
    for blk in range(8):
        f = freqs[blk]
        p1 = {"freq": f, "phase_offset": torch.zeros(B),
              "reset_phase": torch.zeros(B, dtype=torch.bool)}
        p2 = {k: torch.stack([v, v * 1.5 if k == "freq" else v]) for k, v in p1.items()}
        st1, o1 = osc.process(ctx, st1, torch.zeros(0, B), p1)
        st2, o2 = osc.process(ctx, st2, torch.zeros(2, 0, B), p2)
        assert o2.shape == (2, 1, B)
        if blk == 0:
            torch.testing.assert_close(o2[0], o1, rtol=0, atol=0)
    assert st2["tables"].shape == (2, 17, twt.TABLE_SIZE)


def test_oscwt_interpolated_smoother_than_nearest():
    """tests/test_coverage_extras.py:73 on the port."""

    def render(interp):
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=64),
                                        device="cpu")
        g.edit(lambda gg: gg.push(
            kt.OscWt(kt.Wavetable.sine(), 440.7, interpolate=interp)).to_graph_out())
        return proc.render(frames=4800)[0]

    a, b = render(True), render(False)

    def noise(x):
        sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        k = np.argmax(sp)
        mask = np.ones_like(sp, bool)
        mask[max(0, k - 3): k + 4] = False
        return sp[mask].sum() / sp.sum()

    assert noise(a) < noise(b)
