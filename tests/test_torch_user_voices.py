"""User voices in the port's generic FusedVoiceBank: a voice that is not in
the library, with a torch body and a CUDA body (``cuda_source``) kept
together in tools/user_voices.py.

On the CPU the bank runs the torch body. Each is held against the JAX
PallasVoiceBank running the same voice's ``mosaic_voice`` body in the
Pallas interpreter (``OrganVoice`` from examples/custom_voice_bank.py,
``DetunedVoice`` from tests/test_generic_bank.py), through
tests/test_torch_sine_bank.py's ``lockstep``: jitted at XLA level 0 with
the algebraic simplifier off (``EXACT``; it folds the organ's ``freq * 3.0
* f2pi`` into ``freq * (3.0 * f2pi)`` and moves the third partial's u32
increment), the mix within 1e-5 (the sum's order), u32 phases, stage and
the ramp state exact, t within 1e-6. The CUDA body builds and runs only
on the card (``chip_smoke.py`` ``phase_extensions`` holds the hand body,
and ``phase_lowered`` the body lowered from torch, bit-equal to the torch
body); here the spec's contract and the translation unit the build writes
are checked.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from test_generic_bank import DetunedVoice as JaxDetunedVoice
from test_torch_envelope_modal_bank import EXACT
from test_torch_fm_bank import rich_schedule
from test_torch_sine_bank import lockstep

import knaster_tpu as jk

import knaster_tpu_torch as kt
from knaster_tpu_torch.kernels import build
from knaster_tpu_torch.kernels import generic_bank as tgb
from knaster_tpu_torch.kernels.lower import lower_body

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import user_voices  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _example():
    """examples/custom_voice_bank.py as a module (its OrganVoice)."""
    path = os.path.join(ROOT, "examples", "custom_voice_bank.py")
    spec = importlib.util.spec_from_file_location("custom_voice_bank_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B, torch_only", [(48, False), (64, False), (64, True)],
                         ids=["48", "64", "64-torch-only"])
def test_organ_voice_matches_the_jax_example_voice(B, torch_only):
    """The organ, with its hand CUDA source or torch-only (the card lowers
    its torch body, as the JAX example's organ reaches the TPU from its
    Python body alone): the same torch body on the CPU."""
    V = 256
    d = user_voices.organ_defaults(V, 7)
    pb = jk.PallasVoiceBank(_example().OrganVoice(), V, voice_defaults=d,
                            event_capacity=1024)
    organ = user_voices.OrganVoice()
    fb = kt.FusedVoiceBank(user_voices.torch_only(organ) if torch_only else organ, V,
                           voice_defaults=d, event_capacity=1024)
    spec = fb.spec(kt.AudioCtx(48000, B))
    assert (spec.cuda_source is None) == torch_only
    if torch_only:
        lowered = lower_body(spec, fb._float_names, fb._trig_names, 2)
        assert lowered.counts == (5, 1, 5, 2)
    sched = rich_schedule(fb, {"freq": 440.0, "bar2": 0.9, "pan": -0.6, "amp": 0.02}, B)
    mix, st = lockstep(pb, fb, B, sched, compiler_options=EXACT)
    assert mix.shape == (2, 8 * B) and np.abs(mix).max() > 1e-3
    assert bool((st["idle"]).any()) or bool((st["stage"] != 0).any())


def test_detuned_voice_matches_the_jax_user_voice():
    rng = np.random.default_rng(15)
    V = 256
    d = {"freq": rng.uniform(100, 900, V).astype(np.float32),
         "detune": rng.uniform(1.0, 1.01, V).astype(np.float32),
         "amp": np.full(V, 0.01, np.float32)}
    pb = jk.PallasVoiceBank(JaxDetunedVoice(), V, voice_defaults=d, event_capacity=1024)
    fb = kt.FusedVoiceBank(user_voices.DetunedVoice(), V, voice_defaults=d,
                           event_capacity=1024)
    sched = rich_schedule(fb, {"freq": 444.0, "detune": 1.02, "amp": 0.02}, 64)
    mix, _ = lockstep(pb, fb, 64, sched, compiler_options=EXACT)
    assert np.abs(mix).max() > 1e-3


def test_spec_takes_one_cuda_body():
    ctx = kt.AudioCtx(48000, 64)
    spec = user_voices.OrganVoice().kernel_voice(ctx)
    assert spec.cuda_body is None and "struct VoiceBody" in spec.cuda_source
    with pytest.raises(ValueError, match="OrganVoice: a KernelVoiceSpec takes cuda_body"):
        kt.KernelVoiceSpec(carry=spec.carry, body=spec.body, cuda_body="fm",
                           cuda_source=spec.cuda_source, voice_name="OrganVoice")
    # a user body's constants reach the kernel as they are
    np.testing.assert_array_equal(tgb.const_image(spec), spec.consts)


def test_user_translation_unit_wraps_the_source_in_the_harness():
    src = user_voices.DETUNED_SOURCE
    tu = build.user_translation_unit(src)
    assert tu.index('#include "generic_harness.cuh"') < tu.index(src)
    assert "launch_body<VoiceBody>" in tu and "int ktt_body_counts(int* out)" in tu
    assert "int ktt_generic_bank(int body, const float* ramps" in tu
    # the library is named by the harness headers, the source and the flags
    a, b = build.user_body_digest(src), build.user_body_digest(user_voices.ORGAN_SOURCE)
    assert a != b and a == build.user_body_digest(src)


def test_user_voice_off_the_cpu_launches_its_own_body():
    """On a non-CPU tensor the wrapper launches (here: the device check
    refuses the meta device), it never runs the torch body."""
    V = 64
    fb = kt.FusedVoiceBank(user_voices.DetunedVoice(), V)
    ctx = kt.AudioCtx(48000, 64)
    st = fb.init(ctx, device="cpu")
    ops, _ = fb.kernel_operands(ctx, st)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in ops.items()}
    with pytest.raises(ValueError, match="unsupported device meta"):
        tgb.generic_bank(**meta)


def test_user_ops_per_sample_counts_the_organ_pan_hoist():
    """chip_smoke's bound for the organ body counts the pan's angle, cosf
    and sinf only on the warps whose pan moves over the block (the harness
    takes the gains once a block where the pan ramp is flat)."""
    B, V = 64, 256
    fb = kt.FusedVoiceBank(user_voices.OrganVoice(), V,
                           voice_defaults=user_voices.organ_defaults(V, 7))
    ctx = kt.AudioCtx(48000, B)
    ops, _ = fb.kernel_operands(ctx, fb.init(ctx, device="cpu"))
    kind = "generic-user-organ"
    flat, moving = cs.USER_FLAT_PAN_OPS_PER_SAMPLE[kind], cs.OPS_PER_SAMPLE[kind]
    assert moving - flat == 9  # the pan's read (4), angle (3), cosf and sinf
    assert cs.user_ops_per_sample(torch, kind, ops, B) == (flat, 1.0)
    ramps = ops["ramps"].clone()
    pan = list(ops["float_names"]).index("pan")
    ramps[pan, 1, :32] = 1e-3  # one warp's pan glides through the block
    ramps[pan, 2, :32] = 0.0
    ramps[pan, 3, :32] = 4.0 * B
    per, share = cs.user_ops_per_sample(torch, kind, dict(ops, ramps=ramps), B)
    assert share == 7 / 8 and per == (7 * flat + moving) / 8
