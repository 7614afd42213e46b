"""Ten of the JAX package's examples through both packages on the CPU.

``tools/port_examples.py`` rebuilds ``simple_sine``, ``visualize_graph``,
``many_sines``, ``voice_pool``, ``wavetable_orchestra``,
``plucked_strings`` (``main`` and ``shimmer``), ``granular_texture``
(``main`` and ``main_ensemble``, each from ``render_source``),
``ir_reverb``, ``buffer_player`` and ``live_edit`` over a package. Each
renders here through ``knaster_tpu`` and through ``knaster_tpu_torch`` on
the CPU from the same seed and score, with the scheduled events that fall
inside the cut, and the two bounces agree within
``1e-6 * max(1, peak)`` (``GATE``), every one of them above a peak floor
(the render sounds). One case states another gate (``GATES``):
``granular_ensemble`` within 1e-5: its eight players read with
``max_rate`` set, where the JAX graph's jitted block contracts the grain
position's multiply-add ``src0 + age * step`` (as
tests/test_torch_granular.py's ``GRAPH_TOL`` says), and an ulp of a
position moves a read on the plucked source's steep slopes: 2.2e-6 at a
peak of 0.035 here, 7.5e-7 with the JAX side at XLA's optimization level
0 (the other cases: 4.6e-14 to 3.6e-7).

Both packages render block by block (``render_chunk_blocks=1``), for the
CPU's time: the JAX package compiles a program for every superblock length
a score's event-free runs take, two programs block by block (the examples'
superblocked renders are held on the card, ``chip_smoke.py``
``phase_examples``, against the port's CPU render, and superblocks against
blocks by tests/test_torch_superblock.py). Size cuts (``CUTS``): every
render 0.1 s (the grain sources their full 1 s); ``wavetable_orchestra``
1,024 voices and 0.05 s (its first wave of restarts, at 0 s, falls in the
cut, the next at 0.25 s and its releases from 6 s do not);
``voice_pool`` the first 50 notes (its first piece and refresh) and 0.1 s
of tail; the shimmer 64 strings.

``visualize_graph``: equal ``to_dot`` text, and ``show_dot_svg`` returns
None in both packages without Graphviz's ``dot``; the patch renders with
its envelope started (the example renders nothing).

``live_edit``: a stream is not comparable sample by sample, so its graph
and live edit render offline at a fixed block through both packages
(``live_edit_offline``: the Galactic inserted after 12 blocks, the voice's
state carried into the new program, 34 blocks in all; the restart the
example queues 0.5 s after the edit falls past them); then the port's ``StreamBackend`` runs the example once on the CPU: it swaps
to the edit's revision and writes finite audio. Its underruns are not
gated on the CPU, which cannot keep up with it.
"""

import os
import shutil
import sys

import numpy as np
import pytest

import knaster_tpu as jk
import knaster_tpu_torch as kt
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import port_examples as pe  # noqa: E402

GATE = 1e-6  # x max(1, peak)
GATES = {"granular_ensemble": 1e-5}
PEAK_FLOOR = 1e-4
CUTS = {
    "simple_sine": dict(seconds=0.1),
    "visualize_graph": dict(seconds=0.1),
    "many_sines": dict(seconds=0.1),
    "voice_pool": dict(notes=50, tail=0.1),
    "wavetable_orchestra": dict(seconds=0.05, voices=1024),
    "plucked_strings": dict(seconds=0.1),
    "plucked_shimmer": dict(seconds=0.1, strings=64),
    "granular_texture": dict(seconds=0.1),
    "granular_ensemble": dict(seconds=0.1),
    "ir_reverb": dict(seconds=0.1),
    "buffer_player": dict(seconds=0.1),
    "live_edit_offline": dict(edit_at=12, blocks=34),
}


@pytest.mark.parametrize("name", list(CUTS))
def test_example_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda cmd: None)  # no Graphviz
    kw = dict(CUTS[name])
    if name == "visualize_graph":
        kw["svg_path"] = str(tmp_path / "graph.svg")
    j = pe.play(name, jk, None, chunk_blocks=1, **kw)
    t = pe.play(name, kt, "cpu", chunk_blocks=1, **kw)
    a, b = j.audio(), t.audio()
    assert a.shape == b.shape and np.isfinite(b).all()
    peak = float(np.abs(a).max())
    gap = float(np.abs(a - b).max())
    assert peak > PEAK_FLOOR, f"{name}: silent ({peak})"
    gate = GATES.get(name, GATE) * max(1.0, peak)
    assert gap <= gate, f"{name}: the port is {gap} from JAX (peak {peak})"
    assert j.info == t.info
    if name == "visualize_graph":
        assert t.info["svg"] is None and not os.path.exists(kw["svg_path"])
        assert "lpf" in t.info["dot"] and "color=red" in t.info["dot"]
    if name == "voice_pool":
        assert t.info["scheduled"] == 50


def test_live_edit_streams_and_swaps_on_the_cpu():
    run = pe.play("live_edit", kt, "cpu", before_s=0.5, after_s=0.5, release_s=0.25)
    info, audio = run.info, run.audio()
    assert info["swapped"] and info["swaps"][-1][0] == info["revision"]
    assert audio.shape[0] == 2 and audio.shape[1] > 0 and np.isfinite(audio).all()
    assert float(np.abs(audio).max()) > 0
