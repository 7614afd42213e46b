"""The port's generic FusedVoiceBank against the JAX PallasVoiceBank, and
against the port's own hand-written banks.

On the CPU the port's harness runs each voice's torch body; the JAX bank
runs ``_generic_kernel`` with the voice's ``mosaic_voice`` body in the
Pallas interpreter (jitted at XLA optimization level 0, see
tests/test_torch_sine_bank.py). Tolerances as there: the mix within 1e-5,
u32 and stage carries and the ramp state exact, f32 carries within 1e-6.

Against the hand banks, as tests/test_generic_bank.py holds the JAX
package's: the generic harness multiplies each output by the active gain
per sample while the hand banks fold it into amp, so the mixes may differ
by rounding only (5e-7), and the idle latches agree.
"""

import numpy as np
import pytest
import torch
from test_generic_bank import DetunedVoice, _fm_defaults
from test_torch_fm_bank import rich_schedule
from test_torch_sine_bank import lockstep
from test_torch_sub_bank import sub_defaults
from test_torch_wt_bank import saw_table, wt_defaults

import knaster_tpu as kt

import knaster_tpu_torch as ktt
from knaster_tpu_torch.kernels import generic_bank as tgb
from knaster_tpu_torch.kernels.bank_common import _env_ar, _sin_quant, _to_inc, u32_add

V = 512
HAND_ATOL = 5e-7  # tests/test_generic_bank.py's bound for the same pairs


def _voices(name, pkg):
    """(voice, defaults, fparams) of a library voice from ``pkg``."""
    if name == "sine":
        d = wt_defaults(V, 14)
        return pkg.SineVoice(attack=0.002), d, {"freq": 1234.0, "amp": 0.02, "pan": 0.9}
    if name == "fm":
        return pkg.FMVoice(), _fm_defaults(V, 12), {"freq": 555.0, "index": 2.5, "amp": 0.02}
    if name == "subtractive":
        return (pkg.SubtractiveVoice(attack=0.002), sub_defaults(V, 16),
                {"cutoff": 900.0, "freq": 220.0, "q": 2.5, "amp": 0.02})
    return (pkg.AdditiveVoice(table=saw_table(), attack=0.002), wt_defaults(V, 18),
            {"freq": 13000.0, "amp": 0.02, "pan": -0.7})


@pytest.mark.parametrize("B", [48, 64])
@pytest.mark.parametrize("name", ["sine", "fm", "subtractive", "additive"])
def test_matches_jax_generic_bank(name, B):
    jv, d, fparams = _voices(name, kt)
    tv, _, _ = _voices(name, ktt)
    pb = kt.PallasVoiceBank(jv, V, voice_defaults=d, event_capacity=1024)
    fb = ktt.FusedVoiceBank(tv, V, voice_defaults=d, event_capacity=1024)
    mix, st = lockstep(pb, fb, B, rich_schedule(fb, fparams, B))
    assert np.abs(mix).max() > 1e-3


def _run(bank, ctx, sched):
    st = bank.init(ctx, device="cpu")
    outs = []
    for evs in sched:
        ev = None if evs is None else bank.node_events_from_lists(evs)
        st, out = bank.process(ctx, st, events=ev)
        outs.append(out.numpy())
    return np.concatenate(outs, axis=1), st


@pytest.mark.parametrize("name, hand", [
    ("fm", ktt.FusedFMVoiceBank),
    ("subtractive", ktt.FusedSubtractiveVoiceBank),
    # pan moves by instant sets only: mid-ramp pan differs by design (the
    # hand bank's event-free pan is the polynomial of the linear angle)
    ("additive", ktt.FusedWavetableVoiceBank),
])
def test_generic_matches_hand_bank(name, hand):
    ctx = ktt.AudioCtx(48000, 64)
    voice, d, fparams = _voices(name, ktt)
    gb = ktt.FusedVoiceBank(voice, V, voice_defaults=d, event_capacity=1024)
    kw = dict(voice_defaults=d, event_capacity=1024, attack=voice.attack,
              release=voice.release)
    if name == "additive":
        kw["table"] = saw_table()
    hb = hand(V, **kw)
    sched = rich_schedule(gb, fparams, 64)
    a, sa = _run(gb, ctx, sched)
    b, sb = _run(hb, ctx, sched)
    assert np.abs(b).max() > 1e-3
    np.testing.assert_allclose(a, b, rtol=0, atol=HAND_ATOL)
    assert torch.equal(sa["idle"], sb["idle"])
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k


class TorchDetunedVoice(ktt.UGen):
    """tests/test_generic_bank.py's user voice (two detuned sines, AR
    envelope) with a torch body and no CUDA body: it runs on CPU tensors
    only."""

    inputs = 0
    outputs = 1
    params = DetunedVoice.params

    def __init__(self, attack=0.004, release=0.2):
        self.pdefaults = {"freq": 330.0, "detune": 1.003, "amp": 0.02}
        self.attack, self.release = attack, release

    def kernel_voice(self, ctx):
        f2pi = np.float32(16384 * 65536 / ctx.sample_rate)
        atk = np.float32(1.0 / max(self.attack * ctx.sample_rate, 1.0))
        rel = np.float32(1.0 / max(self.release * ctx.sample_rate, 1.0))

        def body(i_f, c, P, T):
            env, stage, t = _env_ar(c["stage"], c["t"], T["t_restart"], atk, rel)
            freq = P["freq"]
            s1, s2 = _sin_quant(c["p1"]), _sin_quant(c["p2"])
            p1 = u32_add(c["p1"], _to_inc(freq * f2pi))
            p2 = u32_add(c["p2"], _to_inc(freq * P["detune"] * f2pi))
            new = {"p1": p1, "p2": p2, "stage": stage, "t": t}
            return new, ((s1 + s2) * env * P["amp"],)

        return ktt.KernelVoiceSpec(
            carry={"p1": ("u32", 0), "p2": ("u32", 0), "stage": ("f32", 0.0),
                   "t": ("f32", 0.0)},
            body=body, idle_of=lambda c: c["stage"] == 0.0, cuda_body=None,
            voice_name=self.name())


def test_cpu_only_user_voice_matches_jax_and_names_itself_off_the_cpu():
    rng = np.random.default_rng(15)
    n = 256
    d = {"freq": rng.uniform(100, 900, n).astype(np.float32),
         "detune": rng.uniform(1.0, 1.01, n).astype(np.float32),
         "amp": np.full(n, 0.01, np.float32)}
    pb = kt.PallasVoiceBank(DetunedVoice(), n, voice_defaults=d, event_capacity=1024)
    fb = ktt.FusedVoiceBank(TorchDetunedVoice(), n, voice_defaults=d,
                            event_capacity=1024)
    sched = rich_schedule(fb, {"freq": 444.0, "detune": 1.02, "amp": 0.02}, 64)
    mix, st = lockstep(pb, fb, 64, sched)
    assert np.abs(mix).max() > 1e-3
    ctx = ktt.AudioCtx(48000, 64)
    ops, _ = fb.kernel_operands(ctx, st)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in ops.items()}
    with pytest.raises(ValueError, match="TorchDetunedVoice has no CUDA body"):
        tgb.generic_bank(**meta)
