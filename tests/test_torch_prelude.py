"""The port's prelude: ``from knaster_tpu_torch.prelude import *`` gives the
port's counterpart of every name in the JAX package's prelude, imports no
JAX, and renders the README example.

The name sets agree but for the documented exceptions: the fused kernel
banks stand where the Pallas banks stood, and the port's prelude adds
``make_mesh``, its counterpart of ``jax.make_mesh``, which the JAX
prelude's users take from ``jax``.
"""

import os
import subprocess
import sys

import numpy as np

import knaster_tpu.prelude as jprelude

import knaster_tpu_torch.prelude as tprelude

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PALLAS_TO_FUSED = {
    "PallasVoiceBank": "FusedVoiceBank",
    "MosaicVoiceSpec": "KernelVoiceSpec",
    "PallasSineVoiceBank": "FusedSineVoiceBank",
    "PallasFMVoiceBank": "FusedFMVoiceBank",
    "PallasSubtractiveVoiceBank": "FusedSubtractiveVoiceBank",
    "PallasWavetableVoiceBank": "FusedWavetableVoiceBank",
}
PORT_ONLY = {"make_mesh"}


def _star(module):
    """The names ``from module import *`` binds (no ``__all__``: the public
    ones)."""
    names = getattr(module, "__all__", None)
    return set(names) if names is not None else {n for n in vars(module)
                                                 if not n.startswith("_")}


def test_prelude_names_match_the_jax_prelude():
    jax_names, port_names = _star(jprelude), _star(tprelude)
    want = {PALLAS_TO_FUSED.get(n, n) for n in jax_names} | PORT_ONLY
    assert port_names == want
    assert {"MeshVoiceBank", "ShardedVoiceBank"} <= port_names
    assert "make_mesh" in tprelude.__doc__


def test_prelude_names_are_the_port_s_own():
    for name in _star(tprelude):
        obj = getattr(tprelude, name)
        mod = getattr(obj, "__module__", None) or ""
        assert not mod.startswith("knaster_tpu."), (name, mod)


def test_prelude_imports_no_jax_and_renders():
    code = """
import sys
from knaster_tpu_torch.prelude import *
assert 'jax' not in sys.modules and 'knaster_tpu' not in sys.modules, sorted(
    m for m in sys.modules if m.startswith(('jax', 'knaster_tpu.')))
graph, proc = knaster(outputs=1, device="cpu")
h = graph.edit(lambda g: g.push(SinWt(440.0).wr_mul(0.5)))
h.to_graph_out()
graph.commit()
a = proc.render(frames=256)
print(a.shape, float(abs(a).max()))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    shape, peak = out.stdout.strip().rsplit(" ", 1)
    assert shape == "(1, 256)" and np.isclose(float(peak), 0.5, atol=1e-3)
