"""``PluckedString`` and ``PluckedVoice`` in the port, against the JAX package.

- Ports of tests/test_physical.py:83-221: the string against a per-sample
  numpy model on both paths (the per-sample loop, ``long=False``, and the
  blockwise one), the two paths against each other, pitch tracking, the
  brightness compensation, damping, the long mode's superblock cap, the
  ``WhiteNoise * EnvAr`` idiom in a graph; and the bank-scale voice: pitch
  per voice, ``vseed`` decorrelation, a sample-accurate pluck, the summed
  mix and the block contract the bank carries. The JAX tests excite the
  string through a ``BufferReader``, which the port has not; here the
  same burst goes straight into ``process``, block by block.
- ``PluckedString.process`` (f32 and f64) and ``VoiceBank(PluckedVoice)``
  (f32) block by block against the JAX package's on the same seeded
  inputs, within ``TOL[dtype]`` of the output: the loop's one-pole
  recurrences are affine scans, which the port takes in its Hillis-Steele
  association and the JAX package in ``associative_scan``'s, an ulp apart
  per sample, and the loop feeds each block back into the ring. The burst
  noise is the same Threefry stream, bit for bit: the ring after the first
  block, before any feedback reaches a read, matches at 2 ulps of the
  burst. The JAX ``PluckedVoice`` does not trace with 64-bit types on (its
  tile write mixes an int32 pointer with an int64 index), so at f64 the
  bank's first block, the burst alone, is held to ``jax.random``'s f64
  stream and a sequential envelope within ``F64_BURST`` (the port's
  envelope is an affine scan); the f64 loop is ``PluckedString``'s, held
  to the JAX package above.
"""

import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu.models import PluckedVoice as JPluckedVoice
from knaster_tpu_torch.convert import bank_state_from_jax

SR = 48000
B = 64
TOL = {np.float32: 1e-6, np.float64: 1e-12}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
F64_BURST = 1e-15


def _np_model(x, freq, damp, brightness, L, sr=SR):
    """tests/test_physical.py:19: the recurrence sample by sample."""
    b1 = min(max(1.0 - brightness, 0.0), 0.995)
    comp = 0.5 + min(b1 / (1.0 - b1), 8.0)
    df = np.clip(sr / freq - comp, 1.0, L - 2)
    nf_f = np.floor(df)
    delta = df - nf_f
    if df > 0.5 and delta < 0.5:
        delta += 1.0
        nf_f -= 1.0
    nf = int(np.clip(nf_f, 0, L - 1))
    coeff = (1.0 - delta) / (1.0 + delta)
    buf = np.zeros(L, np.float32)
    wp = 0
    ap_in = ap_out = d_last = lp = np.float32(0.0)
    out = np.zeros_like(x)
    for n in range(len(x)):
        raw = buf[(wp + L - nf) % L]
        d = np.float32(coeff) * (raw - ap_out) + ap_in
        h = np.float32(0.5) * (d + d_last)
        lp = np.float32(b1) * lp + np.float32(1.0 - b1) * h
        w = x[n] + np.float32(damp) * lp
        buf[wp] = w
        wp = (wp + 1) % L
        ap_in, ap_out, d_last = raw, d, d
        out[n] = w
    return out


def _burst(n, burst=64, seed=3):
    rng = np.random.default_rng(seed)
    x = np.zeros(n, np.float32)
    x[:burst] = rng.standard_normal(burst).astype(np.float32) * 0.5
    return x


def _string(x, long, freq=220.0, damp=0.995, brightness=1.0, **kw):
    """The port's PluckedString over ``x``, block by block."""
    s = kt.PluckedString(freq=freq, damp=damp, brightness=brightness, long=long, **kw)
    ctx = kt.AudioCtx(SR, B)
    st = s.init(ctx)
    p = {n: torch.full((B,), v) for n, v in s.pdefaults.items()}
    outs = []
    for i in range(len(x) // B):
        st, o = s.process(ctx, st, torch.from_numpy(x[None, i * B:(i + 1) * B]), p)
        outs.append(o[0].numpy())
    return np.concatenate(outs)


def _f0_autocorr(sig, sr=SR, lo=50.0, hi=2000.0):
    sig = sig - sig.mean()
    ac = np.correlate(sig, sig, mode="full")[len(sig) - 1:]
    lmin, lmax = int(sr / hi), int(sr / lo)
    k = lmin + np.argmax(ac[lmin:lmax])
    if 1 <= k < len(ac) - 1:
        a, b, c = ac[k - 1], ac[k], ac[k + 1]
        k = k + 0.5 * (a - c) / (a - 2 * b + c)
    return sr / k


@pytest.mark.parametrize("long", [False, True], ids=["per_sample", "blockwise"])
def test_string_matches_numpy_model(long):
    x = _burst(2048)
    L = int(np.ceil(SR / 20.0)) + 4
    np.testing.assert_allclose(_string(x, long), _np_model(x, 220.0, 0.995, 1.0, L),
                               atol=2e-5)


def test_blockwise_equals_per_sample():
    x = _burst(4096)
    np.testing.assert_allclose(_string(x, True), _string(x, False), atol=2e-5)


@pytest.mark.parametrize("freq,brightness,tol", [(110.0, 1.0, 0.01), (220.0, 1.0, 0.01),
                                                 (440.0, 1.0, 0.01), (220.0, 0.5, 0.015)])
def test_pitch_tracks_freq(freq, brightness, tol):
    """Pitch within 1% (1.5% with the brightness compensation at 0.5)."""
    out = _string(_burst(SR // 2), True, freq=freq, brightness=brightness)
    f0 = _f0_autocorr(out[2000:])
    assert abs(f0 - freq) / freq < tol, f0


def test_damp_controls_decay():
    x = _burst(SR // 2)
    short, ring = _string(x, True, damp=0.9), _string(x, True, damp=0.999)
    tail = slice(SR // 4, SR // 2)
    e_ring = float(np.sum(ring[tail] ** 2))
    assert e_ring > 100 * max(float(np.sum(short[tail] ** 2)), 1e-12)
    assert e_ring < float(np.sum(ring[:SR // 4] ** 2))


def test_long_mode_declares_superblock_cap():
    s = kt.PluckedString(freq=220.0, long=True, max_freq=440.0)
    s.init(kt.AudioCtx(SR, 32))
    assert s.superblock_cap == int(SR / 440.0) and s.block_invariant is False


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("long", [False, True], ids=["per_sample", "blockwise"])
def test_string_process_matches_jax(dtype, long):
    """Both paths against ``PluckedString.process`` of the JAX package, with
    a freq ramp and a brightness under 1 (the one-pole in the loop)."""
    import jax

    with jax.enable_x64(dtype == np.float64):
        js = jk.PluckedString(freq=300.0, damp=0.998, brightness=0.6, long=long)
        ts = kt.PluckedString(freq=300.0, damp=0.998, brightness=0.6, long=long)
        ctx = jk.AudioCtx(SR, B, dtype)
        tctx = kt.AudioCtx(SR, B, TDT[dtype])
        sj, st = js.init(ctx), ts.init(tctx)
        x = _burst(24 * B).astype(dtype)
        freq = np.linspace(300.0, 330.0, 24 * B).astype(dtype)
        step = jax.jit(lambda s, xin, p: js.process(ctx, s, xin, p))
        err = 0.0
        for i in range(24):
            sl = slice(i * B, (i + 1) * B)
            p = {"freq": freq[sl], "damp": np.full(B, 0.998, dtype),
                 "brightness": np.full(B, 0.6, dtype)}
            sj, oj = step(sj, x[None, sl], p)
            st, ot = ts.process(tctx, st, torch.from_numpy(x[None, sl]),
                                {k: torch.from_numpy(v) for k, v in p.items()})
            assert ot.dtype == TDT[dtype]
            err = max(err, float(np.abs(ot.numpy() - np.asarray(oj)).max()))
    assert err <= TOL[dtype], err


def test_excited_by_graph_noise_chain():
    """The intended idiom: WhiteNoise * EnvAr burst -> string, in a graph."""
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B,
                                                                   sample_rate=SR),
                                    device="cpu")

    def build(gg):
        noise = gg.push(kt.WhiteNoise(seed=5))
        env = gg.push(kt.EnvAr(0.001, 0.003))
        s = gg.push(kt.PluckedString(freq=330.0, long=True, damp=0.997))
        (noise * env).to(s)
        s.to_graph_out()
        return env

    g.edit(build).param("t_restart").trig()
    out = proc.render(frames=SR // 2)[0]
    assert np.abs(out).max() > 1e-3
    f0 = _f0_autocorr(out[2000:])
    assert abs(f0 - 330.0) / 330.0 < 0.01, f0


# ---------------------------------------------------------------------------
# PluckedVoice: the bank-scale string
# ---------------------------------------------------------------------------

def _pluck_bank(V, vd, frames, plucks, mix="stack", **voice):
    """tests/test_physical.py:176 through the port: plucks are (voice,
    frame or None for the next block)."""
    g, proc = kt.AudioProcessor.new(0, V if mix == "stack" else 1,
                                    kt.AudioProcessorOptions(block_size=B, sample_rate=SR),
                                    device="cpu")
    bank = g.edit(lambda gg: gg.push(kt.VoiceBank(kt.PluckedVoice(**voice), V,
                                                  voice_defaults=vd, mix=mix)))
    bank.to_graph_out()
    g.commit()
    pluck = bank.voice_param("t_pluck")
    for v, t in plucks:
        if t is None:
            pluck.set(v, None)
        else:
            pluck.set_at(v, None, kt.Seconds.from_samples(t, SR))
    return proc.render(frames=frames)


def test_plucked_voice_pitch_per_voice_and_vseed():
    vd = {"vseed": np.array([0, 7]), "freq": np.array([110.0, 220.0])}
    out = _pluck_bank(2, vd, SR // 2, [(0, None), (1, None)])
    for ch, f in [(0, 110.0), (1, 220.0)]:
        f0 = _f0_autocorr(out[ch, 2000:])
        assert abs(f0 - f) / f < 0.01, (ch, f0)
    # different vseeds, different bursts (tests/test_physical.py:207)
    same = _pluck_bank(2, {"vseed": np.array([0, 7]), "freq": np.array([220.0, 220.0])},
                       4096, [(0, None), (1, None)])
    a, b = same[0], same[1]
    assert np.abs(a).max() > 1e-3 and np.abs(b).max() > 1e-3
    corr = float(np.dot(a, b)) / max(float(np.sqrt(np.sum(a * a) * np.sum(b * b))), 1e-12)
    assert abs(corr) < 0.5, corr


def test_plucked_voice_sample_accurate_pluck_and_mix():
    ch = _pluck_bank(1, {"vseed": np.arange(1), "freq": np.array([220.0])}, 1024,
                     [(0, 100)])[0]
    assert np.all(ch[:100] == 0.0)
    assert np.abs(ch[100:140]).max() > 1e-4
    vd = {"vseed": np.arange(4), "freq": 110.0 * 2 ** (np.arange(4) / 4.0)}
    out = _pluck_bank(4, vd, 8192, [(v, None) for v in range(4)], mix="sum")
    assert out.shape == (1, 8192) and np.abs(out).max() > 1e-3


def test_plucked_voice_bank_propagates_block_contract():
    bank = kt.VoiceBank(kt.PluckedVoice(max_freq=440.0), 4)
    assert bank.block_invariant is False
    st = bank.init(kt.AudioCtx(SR, 32))
    assert bank.superblock_cap == int(SR / 440.0)
    # the ring pointer and frame counter stay unbatched; the rest is [V, ...]
    v = st["voices"]
    assert v["wq"].shape == () and v["frame"].shape == ()
    assert v["buf"].shape[0] == 4 and v["lp"].shape == (4,)


def _pluck_defaults(V):
    rng = np.random.default_rng(4)
    return {"vseed": np.arange(V) * 3,
            "freq": (110.0 * 2 ** rng.uniform(0, 2, V)).astype(np.float32),
            "damp": rng.uniform(0.995, 0.999, V).astype(np.float32),
            "brightness": rng.uniform(0.4, 0.9, V).astype(np.float32)}


def _pluck_schedule(bank, V):
    """Plucks across the first block; then a freq set, a brightness ramp, an
    int vseed set and a re-pluck mid-block."""
    tp, fi, vs = bank.trig_index("t_pluck"), bank.float_index, bank.int_index("vseed")
    return {0: [(v * 7 % B, v, tp, 1, 0.0) for v in range(V)],
            3: [(20, 2, fi("freq"), 0, 180.0), (0, 5, fi("brightness"), 4, 96.0),
                (5, 5, fi("brightness"), 0, 0.95), (33, 4, vs, 2, 99.0),
                (40, 4, tp, 1, 0.0)]}


def _port_pluck_render(dtype, V=8, blocks=24):
    tb = kt.VoiceBank(kt.PluckedVoice(seed=11), V, voice_defaults=_pluck_defaults(V))
    ctx = kt.AudioCtx(SR, B, TDT[dtype])
    st, sched, outs = tb.init(ctx), _pluck_schedule(tb, V), []
    for blk in range(blocks):
        evs = sched.get(blk)
        ev = None if evs is None else tb.node_events_from_lists(evs, dtype)
        st, o, _ = tb.process(ctx, st, events=ev)
        outs.append(o.numpy())
    return np.concatenate(outs, axis=1)


def test_plucked_voice_bank_f64_burst_matches_jax_random():
    import jax

    V = 8
    out = _port_pluck_render(np.float64, V, blocks=1)
    assert out.dtype == np.float64
    vd, voice = _pluck_defaults(V), kt.PluckedVoice(seed=11)
    g = np.exp(-1.0 / max(voice.burst_seconds * SR, 1.0))
    want = np.zeros((V, B))
    with jax.enable_x64(True):
        for v in range(V):
            key = jax.random.fold_in(jax.random.PRNGKey(11), int(vd["vseed"][v]))
            u = np.array([float(jax.random.uniform(jax.random.fold_in(key, t), (),
                                                   dtype=np.float64)) for t in range(B)])
            env, e = np.zeros(B), 0.0
            for t in range(B):
                e = 1.0 if t == v * 7 % B else g * e
                env[t] = e
            want[v] = (u * 2.0 - 1.0) * env * voice.pdefaults["amp"]
    np.testing.assert_allclose(out[0], want.sum(axis=0), rtol=0, atol=F64_BURST)
    assert np.abs(want).max() > 0.1


def test_plucked_voice_bank_matches_jax():
    """``VoiceBank(PluckedVoice)`` against the JAX package's vmap bank over
    24 blocks of ``_pluck_schedule``, event-free blocks between. The JAX
    state enters through the converter; the ring after block 0 matches to
    2 ulps of the burst (the noise stream is bit-equal)."""
    import jax

    V, dtype = 8, np.float32
    vd = _pluck_defaults(V)
    if True:
        jb = jk.VoiceBank(JPluckedVoice(seed=11), V, voice_defaults=vd)
        jb.track_idle = True
        tb = kt.VoiceBank(kt.PluckedVoice(seed=11), V, voice_defaults=vd)
        ctx = jk.AudioCtx(SR, B, dtype)
        tctx = kt.AudioCtx(SR, B, TDT[dtype])
        sj = jb.init(ctx)
        st = bank_state_from_jax(jax.tree_util.tree_map(np.asarray, sj), "cpu")
        no_in = np.zeros((0, B), dtype)
        step = jax.jit(lambda s, e: jb.process(ctx, s, no_in, {}, events=e)[:2])
        free = jax.jit(lambda s: jb.process(ctx, s, no_in, {}, events=None)[:2])
        sched = _pluck_schedule(jb, V)
        err = 0.0
        for blk in range(24):
            evs = sched.get(blk)
            if evs is None:
                sj, oj = free(sj)
                st, ot, _ = tb.process(tctx, st, events=None)
            else:
                sj, oj = step(sj, jb.node_events_from_lists(evs, dtype))
                st, ot, _ = tb.process(tctx, st, events=tb.node_events_from_lists(evs, dtype))
            err = max(err, float(np.abs(ot.numpy() - np.asarray(oj)).max()))
            if blk == 0:
                ring = np.asarray(sj["voices"]["buf"])
                np.testing.assert_allclose(st["voices"]["buf"].numpy(), ring, rtol=0,
                                           atol=2 * np.finfo(dtype).eps)
        assert int(st["voices"]["wq"]) == int(sj["voices"]["wq"])
        assert int(st["voices"]["frame"].view(torch.int32)) == int(
            np.asarray(sj["voices"]["frame"]).view(np.int32))
        np.testing.assert_array_equal(st["ivals"].numpy(), np.asarray(sj["ivals"]))
    assert err <= TOL[dtype], err
