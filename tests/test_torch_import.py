"""The PyTorch port imports without JAX, nvcc or triton, and dispatches by device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "knaster_tpu_torch"
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))


def test_import_leaves_jax_and_toolchain_out():
    """In a fresh interpreter (this test process already holds jax, which
    conftest imports), importing every module of the port pulls in neither
    jax, triton nor the JAX package, and needs no nvcc: PATH holds only the
    interpreter's directory and CUDA_HOME points nowhere."""
    mods = [p[:-3].replace(os.sep, ".").removesuffix(".__init__")
            for p in PORT_FILES]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'triton', 'knaster_tpu')]\n"
          "assert not bad, bad\n"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(ROOT / "no-such-cuda"))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_module_names_no_jax(path):
    """No module of the port imports jax or the JAX package, even lazily
    inside a function."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "knaster_tpu"), (
                f"{path}:{node.lineno} imports {name}")


def test_sine_bank_dispatch_by_device():
    """CPU tensors take the plain version; a device that is neither CPU nor
    CUDA raises instead of falling back."""
    from knaster_tpu_torch import AudioCtx, FusedSineVoiceBank
    from knaster_tpu_torch.kernels import sine_bank as sb

    ctx = AudioCtx(48000, 32, torch.float32)
    bank = FusedSineVoiceBank(40)
    ops, _ = bank.kernel_operands(ctx, bank.init(ctx, device="cpu"))
    before = sb.LAUNCHES
    mix, *_ = sb.sine_bank(**ops)
    assert mix.shape == (2, 32) and sb.LAUNCHES == before
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in ops.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        sb.sine_bank(**meta)


def test_sine_bank_rejects_bad_operands():
    """The wrapper checks dtype, shape, contiguity, the eventful pair and the
    act it takes in every block."""
    from knaster_tpu_torch import AudioCtx, FusedSineVoiceBank
    from knaster_tpu_torch.kernels import sine_bank as sb

    ctx = AudioCtx(48000, 64, torch.float32)
    bank = FusedSineVoiceBank(256)
    ops, _ = bank.kernel_operands(ctx, bank.init(ctx, device="cpu"))
    bad = [
        dict(phase=ops["phase"].float()),
        dict(stage=ops["stage"][:-1]),
        dict(ramps=ops["ramps"].transpose(0, 1).contiguous().transpose(0, 1)),
        dict(act=torch.ones(255)),
        dict(rounds=torch.zeros((3, 5, 1, 256))),  # rounds without words
        dict(block_size=2048),
    ]
    for change in bad:
        with pytest.raises(ValueError):
            sb.sine_bank(**{**ops, **change})
    with pytest.raises(TypeError, match="act must be a tensor"):
        sb.sine_bank(**{**ops, "act": None})


def test_bank_rejects_f64_and_large_blocks():
    from knaster_tpu_torch import AudioCtx, FusedSineVoiceBank

    bank = FusedSineVoiceBank(128)
    with pytest.raises(ValueError, match="float32"):
        bank.init(AudioCtx(48000, 64, torch.float64), device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        bank.init(AudioCtx(48000, 2048, torch.float32), device="cpu")
    assert np.isclose(AudioCtx(48000).nyquist, 24000.0)


def _small_bank(kind):
    """A 40-voice bank of each kernel (V not a multiple of 32 or 128)."""
    from knaster_tpu_torch import (
        FMVoice, FusedFMVoiceBank, FusedSubtractiveVoiceBank, FusedVoiceBank,
        FusedWavetableVoiceBank,
    )
    from knaster_tpu_torch.kernels import fm_bank, generic_bank, sub_bank, wt_bank

    if kind == "fm":
        return FusedFMVoiceBank(40), fm_bank
    if kind == "sub":
        return FusedSubtractiveVoiceBank(40), sub_bank
    if kind == "wt":
        return FusedWavetableVoiceBank(40, harmonics=[1.0, 0.5, 0.25]), wt_bank
    return FusedVoiceBank(FMVoice(), 40), generic_bank


NEW_KERNELS = ["fm", "sub", "wt", "generic"]


@pytest.mark.parametrize("kind", NEW_KERNELS)
def test_bank_kernel_dispatch_by_device(kind):
    """CPU tensors take the plain version without counting a launch; meta
    tensors (neither CPU nor CUDA) raise instead of falling back."""
    from knaster_tpu_torch import AudioCtx

    ctx = AudioCtx(48000, 32, torch.float32)
    bank, mod = _small_bank(kind)
    ops, _ = bank.kernel_operands(ctx, bank.init(ctx, device="cpu"))
    before = mod.LAUNCHES
    mix, *_ = bank.kernel(**ops)
    assert mix.shape == (bank.voice.outputs, 32) and mod.LAUNCHES == before
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in ops.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        bank.kernel(**meta)


@pytest.mark.parametrize("kind", NEW_KERNELS)
def test_bank_kernel_rejects_bad_operands(kind):
    """Each wrapper checks dtype, shape, contiguity, the eventful set and
    its own extra operands."""
    from knaster_tpu_torch import AudioCtx

    ctx = AudioCtx(48000, 64, torch.float32)
    bank, _ = _small_bank(kind)
    ops, _ = bank.kernel_operands(ctx, bank.init(ctx, device="cpu"))
    ramps = ops["ramps"]
    bad = [
        dict(ramps=ramps.transpose(0, 1).contiguous().transpose(0, 1)),
        dict(ramps=ramps[:-1]),
        dict(block_size=2048),
        dict(words=torch.zeros((2, 2, 40), dtype=torch.int32)),  # without rounds
    ]
    if kind == "generic":
        bad += [dict(carry=ops["carry"].float()), dict(carry=ops["carry"][:-1]),
                dict(act=None), dict(consts=ops["consts"][None])]
    else:
        state = [k for k in ops if ops[k] is not None and k not in
                 ("ramps", "coefs", "block_size") and isinstance(ops[k], torch.Tensor)]
        # act without rounds, or (a kernel that stages event-free blocks
        # itself) no act
        bad += [dict(act=torch.ones(40)) if bank.HOST_STAGING else dict(act=None)]
        bad += [{k: ops[k][:-1]} for k in state]
        bad += [{k: ops[k].double()} for k in state]
    if kind == "wt":
        bad += [dict(coefs=ops["coefs"][:2]), dict(coefs=ops["coefs"].T)]
    for change in bad:
        with pytest.raises((ValueError, TypeError)):
            bank.kernel(**{**ops, **change})


def test_fused_voice_bank_rejects_unsupported_voices():
    from knaster_tpu_torch import FMVoice, FusedVoiceBank, pinteger

    class IntVoice(FMVoice):
        params = FMVoice.params + (pinteger("mode", 0),)

    with pytest.raises(ValueError, match="integer params"):
        FusedVoiceBank(IntVoice(), 128)

    class Plain:  # a voice with no kernel body at all
        inputs, outputs, params = 0, 1, FMVoice.params

        def name(self):
            return "Plain"

    with pytest.raises(ValueError, match="kernel_voice"):
        FusedVoiceBank(Plain(), 128)

    class Blocky(FMVoice):
        block_invariant = False

    with pytest.raises(ValueError, match="block-invariant"):
        FusedVoiceBank(Blocky(), 128)


@pytest.mark.parametrize("name", ["sine_bank", "fm_bank", "sub_bank", "wt_bank",
                                  "generic_bank", "fm_cascade", "chain_kernel", "pink_noise",
                                  "buffer_reader", "svf_filter", "galactic",
                                  "env_asr"])
def test_ctypes_bindings_match_the_c_entry_points(name):
    """Each kernel module's ARGTYPES agree, argument by argument, with its
    library's extern "C" entry point (pointers, ints, floats), and
    build.py builds every source under csrc/."""
    import ctypes
    import re

    from knaster_tpu_torch.kernels import build

    assert sorted(build.KERNELS) == sorted(
        p.stem for p in (PORT / "csrc").glob("*.cu"))
    module = __import__(f"knaster_tpu_torch.kernels.{name}", fromlist=["x"])
    src = (PORT / "csrc" / f"{name}.cu").read_text()
    sig = re.search(rf"int ktt_{name}\(([^)]*)\)", src).group(1)
    kinds = []
    for arg in sig.split(","):
        arg = arg.strip()
        kinds.append(ctypes.c_void_p if "*" in arg
                     else ctypes.c_float if arg.startswith("float")
                     else ctypes.c_int)
    assert kinds == module.ARGTYPES


def _stage_operands(kind):
    """(wrapper, operands) of a stage-loop kernel on the CPU: the fm_cascade
    of 8 stages, or the chain kernel as a 10-stage graph cascade gives it."""
    import knaster_tpu_torch as kt
    from knaster_tpu_torch.kernels import chain_kernel as kck
    from knaster_tpu_torch.kernels import fm_cascade as kfc

    if kind == "fm_cascade":
        return kfc.fm_cascade, dict(
            params=torch.tensor([100.0, 200.0, 100.0, 0.1]),
            phases=torch.zeros(8, dtype=torch.int32), block_size=32,
            f2pi=22369.62109375, scale=0.0003834951)
    import knaster_tpu_torch.graph.chain_kernel as gck

    got = []
    real, mode = kck.chain_kernel, gck._MODE

    def spy(program, **ops):
        got.append((program, ops))
        return real(program, **ops)

    kck.chain_kernel = spy
    gck._MODE = "1"
    try:
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                        device="cpu")

        def build(gg):
            prev = None
            for i in range(10):
                s = gg.push(kt.SinWt(100.0 + i))
                if prev is not None:
                    mod = (prev * 100.0) + 200.0
                    gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
                prev = s
            (prev * 0.1).to_graph_out()

        g.edit(build)
        proc.render(frames=16)
    finally:
        kck.chain_kernel, gck._MODE = real, mode
    program, ops = got[0]
    return (lambda **kw: kck.chain_kernel(program, **kw)), ops


@pytest.mark.parametrize("kind", ["fm_cascade", "chain_kernel"])
def test_stage_kernel_dispatch_by_device(kind):
    """CPU tensors take the plain version without counting a launch; meta
    tensors (neither CPU nor CUDA) raise instead of falling back."""
    from knaster_tpu_torch.kernels import chain_kernel as kck
    from knaster_tpu_torch.kernels import fm_cascade as kfc

    mod = kfc if kind == "fm_cascade" else kck
    fn, ops = _stage_operands(kind)
    before = mod.LAUNCHES
    out = fn(**ops)
    assert mod.LAUNCHES == before
    assert (out.shape == (32,) if kind == "fm_cascade" else out[0].shape[1:] == (9, 16))
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in ops.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fn(**meta)


@pytest.mark.parametrize("kind", ["fm_cascade", "chain_kernel"])
def test_stage_kernel_rejects_bad_operands(kind):
    fn, ops = _stage_operands(kind)
    if kind == "fm_cascade":
        bad = [dict(phases=ops["phases"].float()), dict(params=ops["params"][:3]),
               dict(params=ops["params"].double()), dict(block_size=0),
               dict(phases=ops["phases"][None])]
    else:
        st, rows, planes = ops["state"], ops["rows"], ops["planes"]
        bad = [dict(state=st.float()), dict(state=st[:, :-1]), dict(rows=rows[:, :8]),
               dict(planes=planes.double()), dict(planes=planes[:, :, :8]),
               dict(planes=planes.transpose(1, 2).contiguous().transpose(1, 2)),
               dict(K=0)]
    for change in bad:
        with pytest.raises((ValueError, TypeError)):
            fn(**{**ops, **change})
    if kind == "chain_kernel":
        from knaster_tpu_torch.kernels import chain_kernel as kck

        with pytest.raises(TypeError):
            kck.chain_kernel(object(), **ops)


def test_processor_device_is_the_callers():
    """The CPU only when the caller names it: ``device="cpu"`` renders on
    the CPU; without a device the entry points take the card, and where
    there is none (this machine) they raise instead of falling back."""
    import knaster_tpu_torch as kt
    from knaster_tpu_torch.graph.compile import compile_graph

    for graph, proc in (kt.knaster(outputs=2, device="cpu"),
                        kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(),
                                              device="cpu")):
        graph.edit(lambda g: (g.push(kt.SinWt(440.0)) * 0.2).to_graph_out())
        audio = proc.render(frames=256)
        assert proc.device.type == "cpu" and isinstance(audio, np.ndarray)
        assert proc.state["pe"]["value"].device.type == "cpu"
        assert proc.render(frames=64, fetch=False).device.type == "cpu"
    if torch.cuda.is_available():
        assert kt.knaster(outputs=2)[1].device.type == "cuda"
        return
    for make in (lambda: kt.knaster(outputs=2),
                 lambda: kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions()),
                 lambda: kt.AudioProcessor(graph),
                 lambda: compile_graph(graph)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()


def test_default_device_asks_for_the_card(monkeypatch):
    """Where torch reports a card, the processors made without a device are
    on it (cuda:0), not on the CPU."""
    import knaster_tpu_torch as kt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for _graph, proc in (kt.knaster(outputs=2),
                         kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions())):
        assert proc.device == torch.device("cuda", 0)
