"""Bank event staging of the PyTorch port against the JAX package.

The same seeded inputs go through the JAX ``PallasSineVoiceBank`` host
staging and the port's ``FusedSineVoiceBank``: event packing, packed
trigger words, the breakpoint round fold, the ramp advance and the initial
state. Integers must be exact; floats agree to 1e-6 (the same f32 ops in
the same order, so in practice they are bit-equal).
"""

import warnings

import numpy as np
import pytest
import torch

from knaster_tpu import AudioCtx, PallasSineVoiceBank

import knaster_tpu_torch as ktt
from knaster_tpu_torch.convert import bank_state_from_jax, bank_state_to_numpy

SR = 48000
V = 1024
FLOAT_TOL = 1e-6  # f32 host arithmetic in the same order on both sides


def _banks(V=V, **kw):
    return PallasSineVoiceBank(V, **kw), ktt.FusedSineVoiceBank(V, **kw)


def _assert_same(a, b, name):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_TOL, err_msg=name)
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)


def _event_mix(rng, B, n_trig=300):
    """Every event kind, with same-slot bursts and out-of-order frames."""
    evs = [(int(rng.integers(0, B)), int(v), 0, 1, 0.0)
           for v in rng.choice(V, n_trig, replace=False)]
    evs += [(int(rng.integers(0, B)), int(v), 1, 1, 0.0)
            for v in rng.choice(V, 40, replace=False)]
    evs += [
        (B - 1, 3, 0, 0, 880.0), (B // 4, 3, 0, 0, 220.0),   # burst, reordered
        (0, 4, 0, 4, 96.0), (5, 4, 0, 0, 440.0),              # cfg then ramp
        (10, 5, 0, 0, 700.0), (B // 2, 5, 0, 4, 0.0),         # depth-3 burst:
        (B - 2, 5, 0, 0, 300.0),                              # set, freeze, set
        (7, 6, 1, 0, 0.5), (7, 6, 1, 0, 0.25),                # same-frame tie
        (1, 8, 2, 0, -0.5),
        (3, 9, 0, 3, 0.0), (9, 9, 0, 3, 1.0),                 # active: latest wins
        (4, 10, 0, 5, 0.0),                                   # note-on
        (2, 11, 2, 2, 5.0),                                   # int set: no int params
    ]
    return evs


@pytest.mark.parametrize("B", [48, 64, 1024])
def test_node_events_from_lists_matches(B):
    pb, fb = _banks(event_capacity=512)
    evs = _event_mix(np.random.default_rng(B), B)
    ej, et = pb.node_events_from_lists(evs), fb.node_events_from_lists(evs)
    assert sorted(ej) == sorted(et)
    for k in ej:
        assert ej[k].dtype == et[k].dtype, k
        np.testing.assert_array_equal(et[k], ej[k], err_msg=k)
    ej, et = pb.empty_node_events(), fb.empty_node_events()
    for k in ej:
        np.testing.assert_array_equal(et[k], np.asarray(ej[k]), err_msg=k)


def test_burst_deeper_than_depth_warns_and_truncates_alike():
    pb, fb = _banks()
    burst = [(5 + 10 * i, 2, 0, 0, 200.0 + 100 * i) for i in range(5)]
    with pytest.warns(UserWarning, match="kernel_burst_depth=3"):
        ej = pb.node_events_from_lists(burst)
    with pytest.warns(UserWarning, match="kernel_burst_depth=3"):
        et = fb.node_events_from_lists(burst)
    for k in ej:
        np.testing.assert_array_equal(et[k], ej[k], err_msg=k)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once per bank
        fb.node_events_from_lists(burst)
    with pytest.raises(ValueError):
        ktt.FusedSineVoiceBank(V, kernel_burst_depth=0)
    with pytest.raises(ValueError, match="event_capacity"):
        ktt.FusedSineVoiceBank(V, event_capacity=4).node_events_from_lists(
            [(0, v, 0, 1, 0.0) for v in range(5)])


@pytest.mark.parametrize("B", [48, 64, 1024])
def test_packed_trigs_match(B):
    pb, fb = _banks(event_capacity=512)
    ev = pb.node_events_from_lists(_event_mix(np.random.default_rng(7 + B), B))
    ctx, tctx = AudioCtx(SR, B, np.float32), ktt.AudioCtx(SR, B)
    evt = fb._events_to(ev, "cpu")
    for ti in (0, 1):
        wj = np.asarray(pb._packed_trigs(ctx, ev, ti)).view(np.int32)
        wt = fb._packed_trigs(tctx, evt, ti)
        assert wt.dtype == torch.int32 and wt.shape == ((B + 31) // 32, V)
        np.testing.assert_array_equal(wt.numpy(), wj)
        assert wj.any()


def _random_state(rng):
    """A mid-render ramp state: anchors, steps, elapsed/duration/config
    counters in flight, some voices inactive or idle."""
    nf = 3
    return {
        "fvals": rng.uniform(-1, 1000, (nf, V)).astype(np.float32),
        "ftarget": rng.uniform(-1, 1000, (nf, V)).astype(np.float32),
        "fstep": rng.uniform(-2, 2, (nf, V)).astype(np.float32),
        "felapsed": rng.integers(-20, 120, (nf, V)).astype(np.int32),
        "fdur": rng.integers(0, 200, (nf, V)).astype(np.int32),
        "fsdur": rng.integers(0, 3, (nf, V)).astype(np.int32) * 50,
        "ivals": np.zeros((0, V), np.int32),
        "active": rng.random(V) > 0.1,
        "idle": rng.random(V) > 0.7,
    }


@pytest.mark.parametrize("B", [48, 64])
def test_apply_events_breakpoints_matches(B):
    pb, fb = _banks(event_capacity=512)
    rng = np.random.default_rng(11 + B)
    st = _random_state(rng)
    ev = pb.node_events_from_lists(_event_mix(rng, B))
    ctx, tctx = AudioCtx(SR, B, np.float32), ktt.AudioCtx(SR, B)
    fj, pj, ij, aj, dj = pb._apply_events_breakpoints(ctx, st, ev)
    ft, pt, it, at, dt = fb._apply_events_breakpoints(
        tctx, bank_state_from_jax(st, "cpu"), fb._events_to(ev, "cpu"))
    names = ("fvals", "ftarget", "fstep", "felapsed", "fdur", "fsdur")
    for name, a, b in zip(names, fj, ft):
        _assert_same(a, b, name)
    for name, a, b in zip(("v0", "step", "dur", "tgt", "frame"), pj, pt):
        _assert_same(a, b, f"piece {name}")
    # untouched rounds carry the frame = B sentinel
    assert (pt[4] == B).float().mean() > 0.9
    _assert_same(ij, it, "ivals")
    _assert_same(aj, at, "active")
    _assert_same(dj, dt, "idle")


def test_advance_ramps_matches():
    st = _random_state(np.random.default_rng(5))
    keys = ("fvals", "ftarget", "fstep", "felapsed", "fdur", "fsdur")
    tst = bank_state_from_jax(st, "cpu")
    for B in (48, 64, 1024):
        aj = PallasSineVoiceBank._advance_ramps(tuple(st[k] for k in keys), B)
        at = ktt.FusedSineVoiceBank._advance_ramps(
            tuple(tst[k] for k in keys), B)
        for name, a, b in zip(keys, aj, at):
            _assert_same(a, b, f"B={B} {name}")


def test_init_through_converter_and_round_trip():
    rng = np.random.default_rng(2)
    defaults = {"freq": rng.uniform(100, 4000, V).astype(np.float32),
                "pan": rng.uniform(-1, 1, V).astype(np.float32)}
    pb, fb = _banks(voice_defaults=defaults)
    jst = {k: np.asarray(v) for k, v in
           pb.init(AudioCtx(SR, 64, np.float32)).items()}
    tst = fb.init(ktt.AudioCtx(SR, 64), device="cpu")
    conv = bank_state_from_jax(jst, "cpu")
    assert sorted(conv) == sorted(tst)
    for k in tst:
        assert conv[k].dtype == tst[k].dtype and conv[k].shape == tst[k].shape, k
        assert torch.equal(conv[k], tst[k]), k
    # phases near 2^32 survive the u32 <-> int32 bit pattern both ways
    jst["phase"] = rng.integers(0, 2**32, jst["phase"].shape,
                                dtype=np.uint64).astype(np.uint32)
    jst["phase"].flat[:3] = (0, 2**31, 2**32 - 1)
    back = bank_state_to_numpy(bank_state_from_jax(jst, "cpu"))
    for k in jst:
        assert back[k].dtype == jst[k].dtype and back[k].shape == jst[k].shape, k
        np.testing.assert_array_equal(back[k], jst[k], err_msg=k)
    with pytest.raises(ValueError, match="multiple of 128"):
        bank_state_to_numpy(ktt.FusedSineVoiceBank(100).init(
            ktt.AudioCtx(), device="cpu"))
