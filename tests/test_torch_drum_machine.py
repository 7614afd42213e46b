"""``examples/drum_machine.py`` through the port, against the JAX package.

Three ``VoiceBank(SamplerVoice(tiled=True, loop=False))`` nodes (kick,
snare, hat) over the example's procedural kit, triggered by its
``set_after`` pattern, render in a graph through the port as through the
JAX graph, both block by block, within ``GRAPH_TOL`` (the JAX block
program is jitted at XLA's default level; the tiled read at unit rate is a
copy of the kit's samples, the envelope and pan products round alike),
and the port's superblocked render equals its per-block one within
``PARTITION_TOL``. The kit and the pattern are ``chip_smoke.py``'s, which
renders the same configuration on the card.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from test_torch_sampler import GRAPH_TOL, PARTITION_TOL, SR, _proc, _sampler

import knaster_tpu as jk
import knaster_tpu_torch as kt

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import DRUM_GAINS, DRUM_PANS, DRUM_PATTERN, DRUM_STEP, drum_kit  # noqa: E402


def drum_machine(m, g, steps=16, n_voices=4):
    """examples/drum_machine.py's three banks and its ``set_after`` pattern,
    the first ``steps`` sixteenths of its bar, in graph ``g`` of package
    ``m``. Returns the seconds to render."""
    kits = drum_kit(np)

    def build(gg):
        banks = {}
        for name, data in kits.items():
            banks[name] = gg.push(m.VoiceBank(
                _sampler(m)(data, loop=False, tiled=True, attack=0.0005, release=0.01),
                n_voices, voice_defaults={
                    "amp": np.full(n_voices, DRUM_GAINS[name], np.float32),
                    "pan": np.full(n_voices, DRUM_PANS[name], np.float32)}))
            banks[name].to_graph_out()
        return banks

    banks = g.edit(build)
    hits = dict.fromkeys(kits, 0)
    for step in range(steps):
        for name, pat in DRUM_PATTERN.items():
            if pat[step % 16] == "x":
                banks[name].voice_param("t_restart").set_after(
                    hits[name] % n_voices, None, step * DRUM_STEP + 0.01)
                hits[name] += 1
    return steps * DRUM_STEP + 0.1


def _drums(m, dtype, chunk=None):
    g, proc = _proc(m, dtype, chunk)
    return np.asarray(proc.render(seconds=drum_machine(m, g, steps=4)))


@pytest.mark.parametrize("dtype", [np.float32], ids=["f32"])
def test_drum_machine_matches_jax_and_partitions(dtype):
    """Both packages block by block (one partition, and the JAX side
    compiles no superblock program), then the port's superblocked render
    against its per-block one."""
    per_block = _drums(kt, dtype, chunk=1)
    with jax.enable_x64(dtype == np.float64):
        ref = _drums(jk, dtype, chunk=1)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(per_block, ref, rtol=0, atol=GRAPH_TOL[dtype])
    np.testing.assert_allclose(_drums(kt, dtype), per_block, rtol=0, atol=PARTITION_TOL[dtype])


def test_one_shot_voices_end_and_round_robin():
    """The bar's first hit sounds from its exact frame (silence before it),
    and each bank's four voices take its hits in turn: over the first half
    bar, as many voices playing as the bank had hits, up to four."""
    steps = 8
    g, proc = _proc(kt, np.float32)
    audio = proc.render(seconds=drum_machine(kt, g, steps=steps))
    assert np.isfinite(audio).all()
    start = int(round(0.01 * SR))
    assert np.abs(audio[:, :start]).max() == 0.0
    assert np.abs(audio[:, start:start + 64]).max() > 1e-2
    lengths = {len(v): k for k, v in drum_kit(np).items()}
    for nid, entry in proc.compiled.entries.items():
        name = lengths[entry.ugen.voice._data.shape[0]]
        playing = proc.state["nodes"][proc.compiled.state_key(nid)]["voices"]["playing"]
        assert int(playing.sum()) == min(4, DRUM_PATTERN[name][:steps].count("x")), name
