"""The host side of the generic and wavetable bank kernels' Hopper design, on
the CPU: the rules and tables the kernels take from the host, each against
what the plain versions compute.

- ``ramp_flat_over_block``, the rule by which the generic kernel takes a
  stereo body's pan gains once a block: held against ``_mat`` over seeded
  random ramps and the edge cases; exact (it is true only where ``_mat``
  gives one bit pattern at every sample of the block).
- The kernel-parameter images (``generic_bank.const_image``,
  ``wt_bank.coef_image``): they unpack to ``spec.consts`` and the ``wt_coefs``
  table exactly; padding is A = B = 0, thr = -inf; a table past the largest
  instantiation raises by name.
- Padding changes nothing: the plain Additive and wavetable harnesses fed
  the padded table are bit-equal to the unpadded runs (carries bit for bit,
  mix equal), and the padded runs match the JAX banks as their own tests
  hold them (mix within 1e-5, carries exact or within 1e-6; the JAX side
  runs ``_wt_kernel`` and ``_generic_kernel`` in the Pallas interpreter).
- The Envelope body's index select (``env_segment_index``) picks the
  segment the S-long select loop picks, for every seg the carry can hold.
- The mix scratch's row counts (``mix_rows``, ``mix_scratch_rows``).
"""

import numpy as np
import pytest
import torch
from test_torch_fm_bank import rich_schedule
from test_torch_sine_bank import lockstep
from test_torch_wt_bank import saw_table, wt_defaults

import knaster_tpu as kt
from knaster_tpu import PallasWavetableVoiceBank

import knaster_tpu_torch as ktt
from knaster_tpu_torch.kernels import bank_common as bc
from knaster_tpu_torch.kernels import generic_bank as gk
from knaster_tpu_torch.kernels import wt_bank as wk

SR = 48000


def _bits(x):
    return x.contiguous().view(torch.int32)


# --------------------------------------------------------------------------
# the flat-ramp rule
# --------------------------------------------------------------------------

def _ramps(seed, n, B):
    """[5, n] ramp groups (v0, step, el, dur, tgt): seeded random ones and
    every edge case of the rule."""
    rng = np.random.default_rng(seed)
    v0 = rng.choice([0.0, -0.0, 0.25, -0.7, 3.0], n).astype(np.float32)
    step = rng.choice([0.0, -0.0, 1e-3, -2e-2], n).astype(np.float32)
    el = rng.integers(-3, 2 * B, n).astype(np.float32)
    dur = rng.integers(0, 3 * B, n).astype(np.float32)
    tgt = rng.choice([0.0, -0.0, 0.25, 0.9], n).astype(np.float32)
    g = np.stack([v0, step, el, dur, tgt])
    edges = [
        (0.3, 0.01, 5.0, 5.0, 0.9),           # el == dur: ended at sample 0
        (0.3, 0.0, 7.0, 7.0 + B - 1, 0.9),    # el + B - 1 == dur: ends at the last sample
        (0.3, 0.0, 7.0, 7.0 + B, 0.9),        # el + B - 1 < dur: flat at v0
        (0.3, 0.0, 0.0, B / 2, 0.9),          # step == 0, ends inside at tgt != v0
        (-0.0, 0.0, 0.0, 2.0 * B, 0.9),       # v0 = -0.0, step = +0.0: +0.0 throughout
        (-0.0, -0.0, 0.0, 2.0 * B, 0.9),      # v0 = -0.0, step = -0.0: -0.0 throughout
        (-0.0, 0.0, -2.0, 2.0 * B, 0.9),      # prog crosses zero: -0.0 then +0.0
        (-0.0, -0.0, -0.0, 2.0 * B, 0.9),     # el = -0.0: prog +0.0 from sample 0
        (0.5, 0.02, 0.0, 3.0 * B, 0.9),       # a glide across the block
        (0.0, 0.0, 10.0, 2.0, -0.0),          # ended at -0.0
    ]
    return torch.from_numpy(np.concatenate([g, np.array(edges, np.float32).T], axis=1))


def _one_pattern(g, B):
    """bool [n]: ``_mat`` gives one bit pattern at every sample of the block."""
    first = _bits(bc._mat(0.0, g))
    same = torch.ones_like(first, dtype=torch.bool)
    for i in range(1, B):
        same &= _bits(bc._mat(float(i), g)) == first
    return same


@pytest.mark.parametrize("B", [1, 48, 64, 1024])
def test_flat_ramp_rule_holds_only_where_mat_is_one_bit_pattern(B):
    g = _ramps(B, 4000, B)
    flat = bc.ramp_flat_over_block(g, B)
    same = _one_pattern(g, B)
    assert bool((same | ~flat).all()), "the rule says flat where _mat varies"
    # not vacuous: ended ramps, and zero-step ramps that do not end, are flat
    assert int(flat.sum()) > 1000
    n = g.shape[1]
    edge = flat[n - 10:].tolist()
    assert edge[0] and edge[2] and edge[4] and edge[5] and edge[7] and edge[9]
    assert not edge[6] and not edge[8]
    # a ramp that ends at the last sample, or inside the block, moves (one
    # sample is always one value)
    assert edge[1] == edge[3] == (B == 1)
    # the hoisted value is _mat at sample 0, not v0: (-0.0, +0.0) gives +0.0
    assert _bits(bc._mat(0.0, g[:, n - 6:n - 5])).item() == 0
    assert _bits(g[0, n - 6:n - 5]).item() != 0


# --------------------------------------------------------------------------
# the kernel-parameter images
# --------------------------------------------------------------------------

def _table(n_harmonics, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, 16384)


def _additive(n_harmonics):
    return ktt.AdditiveVoice(table=_table(n_harmonics), n_harmonics=n_harmonics)


@pytest.mark.parametrize("H, hmax", [(1, 8), (8, 8), (16, 16), (17, 32), (64, 64)])
def test_additive_image_unpacks_to_the_constants(H, hmax):
    spec = _additive(H).kernel_voice(ktt.AudioCtx(SR, 64))
    k = spec.consts
    image = gk.const_image(spec)
    assert image.dtype == np.float32 and image.shape == (4 + 3 * hmax,)
    np.testing.assert_array_equal(image[:3], k[:3])
    assert image[3] == H
    table = image[4:].reshape(3, hmax)
    np.testing.assert_array_equal(table[:, :H], k[3:].reshape(3, H))
    np.testing.assert_array_equal(table[:2, H:], 0.0)
    assert np.all(np.isneginf(table[2, H:]))
    assert gk.const_image(spec) is image  # built once per spec


def test_additive_past_the_largest_instantiation_raises_by_name():
    """A table past the largest unrolled instantiation (64 harmonics) takes
    the run-time variant, which reads the table from device memory: its
    kernel-parameter image is the head alone (the generic body: f2pi, atk,
    rel, H; the wavetable kernel: H), and the table it reads is the one the
    plain versions read. What still raises, by name, is a table of no
    harmonics."""
    for H in (65, 128, 1024):
        assert bc.harmonic_slots(H) == bc.RUNTIME_H
        spec = _additive(H).kernel_voice(ktt.AudioCtx(SR, 64))
        k = spec.consts
        assert k.shape == (3 + 3 * H,)
        image = gk.const_image(spec)
        assert image.dtype == np.float32 and image.flags.c_contiguous
        np.testing.assert_array_equal(image, np.concatenate([k[:3], [np.float32(H)]]))
        coefs = wk.wt_coefs(np.linspace(1.0, 0.0, H, dtype=np.float32),
                            np.arange(H, dtype=np.uint32) * 7919, SR)
        assert coefs.shape == (3, H)
        np.testing.assert_array_equal(wk.coef_image(coefs), np.float32([H]))
    assert bc.harmonic_slots(64) == 64 and bc.harmonic_slots(17) == 32
    with pytest.raises(ValueError, match="H >= 1"):
        bc.harmonic_slots(0)


@pytest.mark.parametrize("name", ["sine", "fm", "subtractive", "envelope", "bell", "bar",
                                  "string"])
def test_other_body_images_unpack_to_the_constants(name):
    voice = {"sine": ktt.SineVoice, "fm": ktt.FMVoice, "subtractive": ktt.SubtractiveVoice,
             "envelope": ktt.EnvelopeVoice}.get(name)
    if voice is None:
        voice = lambda: ktt.ModalVoice(getattr(ktt.ModalResonator, name)(330.0))  # noqa: E731
    spec = voice().kernel_voice(ktt.AudioCtx(SR, 64))
    k, image = spec.consts, gk.const_image(spec)
    if name in ("sine", "fm", "subtractive"):
        np.testing.assert_array_equal(image, k)
    elif name == "envelope":
        # the head: f2pi, 1/sr, start, looping, S, n_present, present[4]
        np.testing.assert_array_equal(image, k[:gk.ENVELOPE_HEAD])
        assert int(image[4]) == (k.shape[0] - gk.ENVELOPE_HEAD) // 4
    else:
        M = int(k[5])
        # atk, rel, 1/area, 2pi/sr, then ratio, k_exp, gain (not thr^2, M, gain^2)
        np.testing.assert_array_equal(image[:4], k[:4])
        np.testing.assert_array_equal(image[4:].reshape(3, M), k[6:6 + 3 * M].reshape(3, M))
    assert image.dtype == np.float32 and image.flags.c_contiguous


@pytest.mark.parametrize("H, hmax", [(1, 8), (16, 16), (40, 64)])
def test_wavetable_image_unpacks_to_the_coefs(H, hmax):
    mags, offs = ktt.harmonics_from_table(_table(H), H)
    coefs = wk.wt_coefs(mags, offs, SR)
    image = wk.coef_image(coefs)
    assert image.dtype == np.float32 and image.shape == (1 + 3 * hmax,)
    assert image[0] == H
    table = image[1:].reshape(3, hmax)
    np.testing.assert_array_equal(table[:, :H], coefs)
    np.testing.assert_array_equal(table[:2, H:], 0.0)
    assert np.all(np.isneginf(table[2, H:]))


# --------------------------------------------------------------------------
# padding changes nothing
# --------------------------------------------------------------------------

class PaddedWavetableBank(ktt.FusedWavetableVoiceBank):
    """The wavetable bank with its [3, H] table padded to the kernel's
    instantiation (``bank_common.padded_harmonics``)."""

    def kernel_operands(self, ctx, state, events=None):
        operands, carry = super().kernel_operands(ctx, state, events)
        coefs = operands["coefs"]
        hmax = bc.harmonic_slots(coefs.shape[1])
        operands["coefs"] = torch.from_numpy(bc.padded_harmonics(coefs.numpy(), hmax))
        return operands, carry


def _run(bank, B, sched):
    ctx = ktt.AudioCtx(SR, B)
    st = bank.init(ctx, device="cpu")
    outs = []
    for evs in sched:
        ev = None if evs is None else bank.node_events_from_lists(evs)
        st, out = bank.process(ctx, st, events=ev)
        outs.append(out)
    return torch.cat(outs, dim=1), st


def _assert_same_run(a, b):
    (ma, sa), (mb, sb) = a, b
    assert torch.equal(ma, mb)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(_bits(sa[k]) if sa[k].dtype == torch.float32 else sa[k],
                           _bits(sb[k]) if sb[k].dtype == torch.float32 else sb[k]), k


def test_padded_wavetable_table_changes_nothing():
    """H = 17 padded to 32: the plain version bit-equal to the unpadded run
    and, as test_torch_wt_bank.py holds it, to the JAX bank."""
    V, B, H = 256, 64, 17
    d = wt_defaults(V, 21)
    kw = dict(table=saw_table(H), n_harmonics=H, voice_defaults=d, event_capacity=1024,
              attack=0.002)
    padded = PaddedWavetableBank(V, **kw)
    sched = rich_schedule(padded, {"pan": -0.7, "freq": 13000.0, "amp": 0.02}, B)
    _assert_same_run(_run(padded, B, sched), _run(ktt.FusedWavetableVoiceBank(V, **kw), B,
                                                  sched))
    mix, _ = lockstep(PallasWavetableVoiceBank(V, **kw), padded, B, sched)
    assert np.abs(mix).max() > 1e-3


def test_padded_additive_table_changes_nothing(monkeypatch):
    """The generic bank's Additive body over a table padded from 17 to 32
    harmonics: the plain harness bit-equal to the unpadded run and, as
    test_torch_generic_bank.py holds it, to the JAX PallasVoiceBank."""
    V, B, H = 256, 64, 17
    d = wt_defaults(V, 22)
    fparams = {"freq": 13000.0, "amp": 0.02, "pan": -0.7}
    plain = ktt.FusedVoiceBank(ktt.AdditiveVoice(table=saw_table(H), n_harmonics=H,
                                                 attack=0.002), V, voice_defaults=d,
                               event_capacity=1024)
    sched = rich_schedule(plain, fparams, B)
    want = _run(plain, B, sched)
    wt_coefs = wk.wt_coefs
    monkeypatch.setattr(wk, "wt_coefs",
                        lambda *a: bc.padded_harmonics(wt_coefs(*a), 32))
    padded = ktt.FusedVoiceBank(ktt.AdditiveVoice(table=saw_table(H), n_harmonics=H,
                                                  attack=0.002), V, voice_defaults=d,
                                event_capacity=1024)
    assert padded.spec(ktt.AudioCtx(SR, B)).consts.shape == (3 + 3 * 32,)
    _assert_same_run(_run(padded, B, sched), want)
    jb = kt.PallasVoiceBank(kt.AdditiveVoice(table=saw_table(H), n_harmonics=H, attack=0.002),
                            V, voice_defaults=d, event_capacity=1024)
    mix, _ = lockstep(jb, padded, B, sched)
    assert np.abs(mix).max() > 1e-3


# --------------------------------------------------------------------------
# the Envelope body's index select
# --------------------------------------------------------------------------

def _select_loop(seg, table):
    """The S-long select loop of ``_make_env_multiseg``: segment 0's
    constants, replaced by segment s's where seg == s."""
    sel = table[0].expand(seg.shape[0], 4).clone()
    for s in range(1, table.shape[0]):
        sel = torch.where((seg == np.float32(s))[:, None], table[s], sel)
    return sel


@pytest.mark.parametrize("S", [1, 2, 4, 7])
def test_envelope_index_select_matches_the_select_loop(S):
    rng = np.random.default_rng(S)
    table = torch.from_numpy(rng.uniform(-1, 1, (S, 4)).astype(np.float32))
    segs = [bc.ENV_SEG_STOPPED, bc.ENV_SEG_FINISHED] + list(range(S))
    seg = torch.tensor(segs + [0.5, S - 0.5, float(S), 1e9, -0.0, float("nan")],
                       dtype=torch.float32)
    idx = bc.env_segment_index(seg, S)
    assert torch.equal(table[idx], _select_loop(seg, table))
    assert idx[:2].tolist() == [0, 0] and idx[2:2 + S].tolist() == list(range(S))


# --------------------------------------------------------------------------
# the mix scratch
# --------------------------------------------------------------------------

def test_mix_rows_and_buffers():
    for V, want in ((1, (1, 1)), (256, (1, 1)), (257, (2, 1)), (8192, (32, 1)),
                    (8193, (33, 2)), (131055, (512, 16)), (131072, (512, 16))):
        assert bc.mix_rows(V) == want
    assert bc.mix_scratch_rows(131072) == 512 + 16 + 8 * 512
    mix, work = bc.empty_mix(131055, 2, 48, "cpu")
    assert mix.shape == (2, 48) and work.shape == (512 + 16 + 8 * 512, 2, 48)
    assert work.dtype == mix.dtype == torch.float32
