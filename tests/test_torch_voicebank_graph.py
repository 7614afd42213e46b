"""A ``VoiceBank`` of every library voice as a graph node, the port against the JAX package.

Each of ``SineVoice``, ``FMVoice``, ``SubtractiveVoice``, ``AdditiveVoice``,
``EnvelopeVoice``, ``ModalVoice``, ``PluckedVoice`` and the bare
``Envelope`` renders in a graph through the port under per-voice handles:
triggers across the first block, then in the next a smoothed float set, a
retrigger, an int set where the voice has an int param (``vseed``,
``jump_to_segment``) and an active flag; then an event-free run of eight
blocks, which the bounce renders as one superblock where the voice allows
it, as the JAX bounce does. The render matches the
JAX graph's on the same schedule within ``TOL`` at f32 and f64.

Tolerances: the JAX graphs are jitted at XLA's default level, where its CPU
backend contracts multiply-adds (a ramping param's trajectory among them)
and its sines are its own kernels, an ulp from torch's: 1e-6 at f32 and
1e-12 at f64. Two voices take more at f32 (``TOL_F32``): the port's
``ModalResonator`` takes its decay and rotation in f64 and rounds them,
where XLA's f32 exp, cos and sin differ by an ulp, and the modes drift
apart by it (ugens/modal.py); the plucked string's loop feeds each block
back through two affine scans, which the port takes in its Hillis-Steele
association and the JAX package in ``associative_scan``'s. The JAX
``PluckedVoice`` does not trace with 64-bit types on (its tile write mixes
an int32 pointer with an int64 index), so the plucked bank is compared at
f32 only; its f64 path is held in tests/test_torch_plucked.py.
"""

import jax
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu.models import PluckedVoice as JPluckedVoice

SR = 48000
B = 64
V = 4
TOL = {np.float32: 1e-6, np.float64: 1e-12}
TOL_F32 = {"modal": 5e-6, "plucked": 5e-6}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
HARMONICS = np.array([1.0, 0.5, 0.25], np.float32)

VOICES = {
    "sine": lambda m: m.SineVoice(),
    "fm": lambda m: m.FMVoice(),
    "subtractive": lambda m: m.SubtractiveVoice(),
    "additive": lambda m: m.AdditiveVoice(harmonics=HARMONICS),
    "envelope_voice": lambda m: m.EnvelopeVoice(),
    "modal": lambda m: m.ModalVoice(m.ModalResonator.bar(300.0), strike_ms=1.0),
    "plucked": lambda m: (kt.PluckedVoice if m is kt else JPluckedVoice)(seed=7),
    "envelope": lambda m: m.Envelope(0.0, [(0.002, 1.0), (0.004, 0.5, "sinusoidal"),
                                           (0.003, 0.0)]),
}
CASES = [(name, dt) for name in VOICES for dt in (np.float32, np.float64)
         if not (name == "plucked" and dt == np.float64)]


def _render(m, name, dtype):
    kw = {"device": "cpu"} if m is kt else {}
    g, proc = m.AudioProcessor.new(
        0, 1, m.AudioProcessorOptions(block_size=B, sample_rate=SR),
        dtype=TDT[dtype] if m is kt else dtype, **kw)
    voice = VOICES[name](m)
    vd = {"vseed": np.arange(V) * 5} if name == "plucked" else None
    bank = g.edit(lambda gg: gg.push(m.VoiceBank(voice, V, voice_defaults=vd, mix="sum")))
    if voice.outputs == 2:
        bank.out([0]).to_graph_out()
    else:
        bank.to_graph_out()
    g.commit()

    def at(n):
        return m.Seconds.from_samples(n, SR)

    names = [p.name for p in voice.params]
    trig = next(n for n in names if n.startswith("t_"))
    tp = bank.voice_param(trig)
    for v in range(V):
        tp.trig_at(v, at(7 * v))
    floats = [p.name for p in voice.params if p.ptype == "float"]
    fp = bank.voice_param(floats[0])
    fp.smooth(1, 0.002)
    fp.set_at(1, float(voice.pdefaults.get(floats[0], 1.0)) * 1.5, at(B + 5))
    tp.trig_at(0, at(B + 40))
    ints = [p.name for p in voice.params if p.ptype == "integer"]
    if ints:
        bank.voice_param(ints[0]).set_at(2, 1, at(B + 20))
    bank.set_voice_active(3, False, m.Time.at(at(B)))
    return np.asarray(proc.render(frames=10 * B))


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{'f32' if d == np.float32 else 'f64'}" for n, d in CASES])
def test_voice_bank_in_graph_matches_jax(name, dtype):
    port = _render(kt, name, dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = _render(jk, name, dtype)
    assert port.dtype == dtype and port.shape == ref.shape
    assert np.abs(ref).max() > 1e-3
    tol = TOL_F32.get(name, TOL[dtype]) if dtype == np.float32 else TOL[dtype]
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)
