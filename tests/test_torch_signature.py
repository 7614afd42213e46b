"""The port's structural signatures (knaster_tpu_torch/core/signature.py)
against the JAX package's.

* ``_freeze`` gives the JAX version's value for every type that version
  handles, and refuses what it refuses;
* ``ugen_signature`` of one constructor config in both packages: equal
  value for value (module names mapped) where the two UGens hold the same
  instance attributes; elsewhere both freeze, and two configs share a
  signature in the port exactly where they share one in the JAX package;
* a tensor makes a UGen unfreezable, and so does a callable that is not one
  of the port's own functions; a value attached after the push leaves the
  node's signature as it was.
"""

import enum

import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu.core.signature as js
import knaster_tpu_torch as kt
import knaster_tpu_torch.core.signature as ts
import knaster_tpu_torch.graph.compile as tC
from knaster_tpu_torch.parallel.generic_bank import KernelVoiceSpec


class Color(enum.Enum):
    RED = 1
    BLUE = "b"


class Config:
    def __init__(self):
        self.a = 1
        self.b = [1.5, (2, "x")]
        self.c = {"k": np.arange(3, dtype=np.int16)}


FREEZABLE = [
    True, 0, -7, 2.5, "s", b"\x00\x01", None,
    Color.RED, Color.BLUE,
    np.zeros((2, 3), np.float32), np.arange(5, dtype=np.int64),
    np.asfortranarray(np.ones((3, 2))), np.array(1.5, np.float64),
    np.float32(0.25), np.int32(-3), np.bool_(True),
    [1, 2.0, "three"], (None, (1, (2,))), frozenset({3, 1, 2}),
    {"b": 1, "a": [2]}, {3: "int key", "x": 1.0},
    int, np.ndarray, Config(), [Config(), {"nested": Config()}],
]


def _nested(depth):
    v = 0
    for _ in range(depth):
        v = [v]
    return v


UNFREEZABLE = [lambda x: x, print, np.sin, _nested(20), object()]


@pytest.mark.parametrize("value", FREEZABLE, ids=lambda v: type(v).__name__)
def test_freeze_equals_the_jax_version(value):
    assert ts._freeze(value) == js._freeze(value)
    hash(ts._freeze(value))


@pytest.mark.parametrize("value", UNFREEZABLE, ids=lambda v: type(v).__name__)
def test_unfreezable_in_both(value):
    for mod in (ts, js):
        with pytest.raises(mod._Unfreezable):
            mod._freeze(value)


def test_tensors_are_unfreezable_and_dtypes_freeze():
    with pytest.raises(ts._Unfreezable):
        ts._freeze(torch.zeros(3))
    with pytest.raises(ts._Unfreezable):
        ts._freeze({"w": [torch.ones(())]})
    assert ts._freeze(torch.float32) == ("dtype", "torch.float32")
    assert ts._freeze(torch.device("cpu")) == ("device", "cpu")


def _norm(x):
    if isinstance(x, str):
        return x.replace("knaster_tpu_torch", "knaster_tpu")
    if isinstance(x, tuple):
        return tuple(_norm(y) for y in x)
    return x


def _bank(m, name):
    return getattr(m, name, None) or getattr(m, {"FusedSineVoiceBank": "PallasSineVoiceBank",
                                                 "FusedVoiceBank": "PallasVoiceBank"}[name])


# the same instance attributes in both packages: one value, module names mapped
SAME = {
    "SinWt": lambda m: m.SinWt(440.0),
    "SinWt_lookup": lambda m: m.SinWt(440.0, lookup=True),
    "SinNumeric": lambda m: m.SinNumeric(220.0),
    "Phasor": lambda m: m.Phasor(2.0),
    "Constant": lambda m: m.Constant(0.5),
    "MathUGen": lambda m: m.MathUGen("mul", 1),
    "PolyBlep": lambda m: m.PolyBlep(),
    "SvfFilter": lambda m: m.SvfFilter(),
    "OnePoleLpf": lambda m: m.OnePoleLpf(500.0),
    "Pan2": lambda m: m.Pan2(),
    "WhiteNoise": lambda m: m.WhiteNoise(seed=3),
    "PinkNoise": lambda m: m.PinkNoise(seed=3),
    "SampleDelay": lambda m: m.SampleDelay(0.1),
    "AllpassDelay": lambda m: m.AllpassDelay(0.1),
    "ModalResonator": lambda m: m.ModalResonator(),
    "PluckedString": lambda m: m.PluckedString(),
    "OscWt": lambda m: m.OscWt(m.Wavetable.sine(), 440.0),
    "Convolver": lambda m: m.Convolver(np.linspace(1, 0, 50, dtype=np.float32)),
    "Galactic": lambda m: m.Galactic(seed=1),
}


@pytest.mark.parametrize("name", sorted(SAME))
def test_signature_equals_the_jax_one(name):
    a, b = SAME[name](jk), SAME[name](kt)
    sj, st = js.ugen_signature(a), ts.ugen_signature(b)
    assert sj is not None and _norm(st) == sj


_VD = {"freq": np.full(128, 300.0, np.float32)}
_VD2 = {"freq": np.full(128, 500.0, np.float32)}
_H1 = np.linspace(1, 0, 64, dtype=np.float32)

# (config a, config b): the port's attributes differ from the JAX package's
# (the envelopes' prefix sum, FMCascade's kernel switch and superblock cap,
# the vmap bank's ``params``, the fused banks' tile rows and lazy caches),
# so the signatures are compared by what they tell apart
PAIRS = {
    "EnvAsr_defaults": (lambda m: m.EnvAsr(0.01, 0.05), lambda m: m.EnvAsr(0.02, 0.1)),
    "EnvAr_defaults": (lambda m: m.EnvAr(0.01, 0.05), lambda m: m.EnvAr(0.03, 0.05)),
    "FMCascade_stages": (lambda m: m.FMCascade(8), lambda m: m.FMCascade(16)),
    "FMCascade_same": (lambda m: m.FMCascade(8), lambda m: m.FMCascade(8)),
    "SinWt_defaults": (lambda m: m.SinWt(440.0), lambda m: m.SinWt(880.0)),
    "SinWt_lookup": (lambda m: m.SinWt(440.0), lambda m: m.SinWt(440.0, lookup=True)),
    "OscWt_table": (lambda m: m.OscWt(m.Wavetable.sine()), lambda m: m.OscWt(m.Wavetable.saw())),
    "OscWt_interp": (lambda m: m.OscWt(m.Wavetable.sine()),
                     lambda m: m.OscWt(m.Wavetable.sine(), interpolate=True)),
    "Convolver_ir": (lambda m: m.Convolver(_H1), lambda m: m.Convolver(_H1[::-1].copy())),
    "Convolver_len": (lambda m: m.Convolver(_H1), lambda m: m.Convolver(_H1[:32].copy())),
    "VoiceBank_defaults": (lambda m: m.VoiceBank(m.SineVoice(), 128, voice_defaults=_VD),
                           lambda m: m.VoiceBank(m.SineVoice(), 128, voice_defaults=_VD2)),
    "VoiceBank_voices": (lambda m: m.VoiceBank(m.SineVoice(), 128),
                         lambda m: m.VoiceBank(m.SineVoice(), 256)),
    "VoiceBank_attack": (lambda m: m.VoiceBank(m.SineVoice(attack=0.01), 128),
                         lambda m: m.VoiceBank(m.SineVoice(attack=0.02), 128)),
    "VoiceBank_modal": (lambda m: m.VoiceBank(m.ModalVoice(), 128),
                        lambda m: m.VoiceBank(m.ModalVoice(), 128, voice_defaults=_VD)),
    "VoiceBank_fm_sub": (lambda m: m.VoiceBank(m.FMVoice(), 128),
                         lambda m: m.VoiceBank(m.SubtractiveVoice(), 128)),
    "VoiceBank_plucked": (lambda m: m.VoiceBank(m.PluckedVoice(), 128),
                          lambda m: m.VoiceBank(m.PluckedVoice(), 128, voice_defaults=_VD)),
    "FusedSine_defaults": (lambda m: _bank(m, "FusedSineVoiceBank")(128, voice_defaults=_VD),
                           lambda m: _bank(m, "FusedSineVoiceBank")(128, voice_defaults=_VD2)),
    "FusedSine_voices": (lambda m: _bank(m, "FusedSineVoiceBank")(128),
                         lambda m: _bank(m, "FusedSineVoiceBank")(256)),
    "FusedEnvelope_defaults": (
        lambda m: _bank(m, "FusedVoiceBank")(m.EnvelopeVoice(), 128),
        lambda m: _bank(m, "FusedVoiceBank")(m.EnvelopeVoice(), 128, voice_defaults=_VD)),
    "Fused_voice": (lambda m: _bank(m, "FusedVoiceBank")(m.EnvelopeVoice(), 128),
                    lambda m: _bank(m, "FusedVoiceBank")(m.SineVoice(), 128)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signatures_tell_apart_what_the_jax_ones_do(name):
    fa, fb = PAIRS[name]
    j = [js.ugen_signature(f(jk)) for f in (fa, fb)]
    t = [ts.ugen_signature(f(kt)) for f in (fa, fb)]
    assert None not in j and None not in t
    assert (t[0] == t[1]) == (j[0] == j[1])


def test_tensor_or_foreign_callable_makes_a_ugen_unfreezable():
    c = kt.Constant(0.5)
    c.table = torch.zeros(4)
    assert ts.ugen_signature(c) is None
    c = kt.Constant(0.5)
    c.spec = KernelVoiceSpec(carry={"x": ("f32", 0.0)}, body=lambda i_f, c, P, T: (c, ()))
    assert ts.ugen_signature(c) is None
    c = kt.Constant(0.5)
    c.fn = np.cumsum  # a function, not one of the port's own
    assert ts.ugen_signature(c) is None

    class Keyed(kt.Constant):
        def program_key(self):
            return ("keyed", 2)

    k = Keyed(0.5)
    k.spec = c.fn
    assert ts.ugen_signature(k) == ("custom", __name__, "test_tensor_or_foreign_callable_"
                                    "makes_a_ugen_unfreezable.<locals>.Keyed",
                                    ("seq", ("keyed", 2)))


def test_value_attached_after_push_keeps_the_signature():
    """A fused bank attaches its kernel spec and constants at its first
    block: the UGen no longer freezes, but its node keeps the signature
    frozen at the push, and an identical bank pushed after the render is a
    program-cache hit."""
    tC.clear_program_cache()
    g, proc = kt.AudioProcessor.new(0, 2, kt.AudioProcessorOptions(block_size=16),
                                    device="cpu")
    bank = kt.FusedVoiceBank(kt.EnvelopeVoice(), 8)
    h = g.edit(lambda gg: gg.push(bank))
    g.edit(lambda gg: h.to_graph_out())
    sig = g._node(h.node_id).sig
    proc.render(frames=64)
    assert bank._specs and ts.ugen_signature(bank) is None
    assert g._node(h.node_id).sig == sig is not None
    g.edit(lambda gg: gg.free_node(h))
    h2 = g.edit(lambda gg: gg.push(kt.FusedVoiceBank(kt.EnvelopeVoice(), 8)))
    g.edit(lambda gg: h2.to_graph_out())
    assert g._node(h2.node_id).sig == sig
    proc.render(frames=64)
    assert proc.compiled.cache_hit
    tC.clear_program_cache()
