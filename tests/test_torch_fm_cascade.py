"""The port's FMCascade and its kernel's plain version against the JAX package.

``FMCascade`` through both processors at tests/test_voicebank.py's sizes
(16 stages, B = 64, 640 frames), on the kernel path (JAX: the Pallas kernel
in interpret mode; port: ``fm_cascade_plain``) and on the scan path: within
1e-6 (measured 7.5e-9), since XLA's CPU ``sin`` and torch's differ by an
ulp at some table indices.

Block by block, ``FMCascade.process`` of both packages on the same params
and phases (jitted at ``xla_backend_optimization_level`` 0, where XLA's CPU
backend does not contract ``base + depth * x`` into a fused multiply-add;
see tests/test_torch_sine_bank.py): output within 1e-6, phases within 64
units of 2^32 (measured at most 6: an ulp of ``sin`` in one stage moves the
next stage's increment by one unit now and then), over param sets that
saturate a stage (96 kHz and up) and make one negative.
The two saturation rules are pinned: the kernel path advances a saturated
stage by 2^31 - 1 per sample (XLA's saturating f32 -> int32), the scan path
by 2^31 (f32 -> uint32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knaster_tpu as jk
import knaster_tpu_torch as kt
from knaster_tpu_torch.kernels import fm_cascade as kfc

SR = 48000
TOL = 1e-6
# u32 phase units (2^30 a cycle, 2^16 a table step); measured at most 6
PHASE_GAP = 64
NO_FMA = {"xla_backend_optimization_level": 0}


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "scan"])
def test_fm_cascade_renders_like_jax(kernel):
    gj, pj = jk.AudioProcessor.new(0, 1, jk.AudioProcessorOptions(block_size=64))
    gj.edit(lambda gg: gg.push(jk.FMCascade(16, use_pallas=kernel)).to_graph_out())
    gt, pt = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=64))
    gt.edit(lambda gg: gg.push(kt.FMCascade(16, use_kernel=kernel)).to_graph_out())
    a = np.asarray(pj.render(frames=640))
    b = pt.render(frames=640)
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    assert 0.05 < np.abs(b).max() <= np.float32(0.1)


# (freq, base, depth, amp): the defaults; stage 0 saturating and every
# later stage negative; every later stage saturating
PARAMS = [(100.0, 200.0, 100.0, 0.1), (1.0e5, -300.0, 100.0, 0.1),
          (100.0, 96500.0, 100.0, 0.1)]


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "scan"])
@pytest.mark.parametrize("vals", PARAMS, ids=["defaults", "saturating_negative",
                                              "saturating"])
def test_process_matches_jax_block_by_block(kernel, vals):
    N, B = 16, 64
    rng = np.random.default_rng(7)
    ph0 = rng.integers(2**32 - 2**26, 2**32, N, dtype=np.uint64).astype(np.uint32)
    jctx = jk.AudioCtx(SR, B, np.float32)
    tctx = kt.AudioCtx(SR, B, torch.float32)
    ju = jk.FMCascade(N, use_pallas=kernel)
    tu = kt.FMCascade(N, use_kernel=kernel)
    names = ("freq", "base", "depth", "amp")
    jp = {n: jnp.full((B,), v, jnp.float32) for n, v in zip(names, vals)}
    tp = {n: torch.full((B,), v, dtype=torch.float32) for n, v in zip(names, vals)}
    step = jax.jit(lambda s: ju.process(jctx, s, None, jp), compiler_options=NO_FMA)
    sj = {"phases": jnp.asarray(ph0)}
    st = {"phases": torch.from_numpy(ph0.view(np.int32).copy())}
    for blk in range(3):
        prev = st["phases"].numpy().view(np.uint32).astype(np.int64)
        sj, oj = step(sj)
        st, ot = tu.process(tctx, st, torch.zeros((0, B)), tp)
        gap = (st["phases"].numpy().view(np.uint32).astype(np.int64)
               - np.asarray(sj["phases"]).astype(np.int64)) % 2**32
        gap = np.minimum(gap, 2**32 - gap)
        assert gap.max() <= PHASE_GAP, f"block {blk}: phases {gap.max()} units apart"
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=TOL)
        adv = (st["phases"].numpy().view(np.uint32).astype(np.int64) - prev) % 2**32
        sat = (B * ((2**31 - 1) if kernel else 2**31)) % 2**32
        if vals[0] > 9.6e4:  # stage 0 saturates, the negative stages stand
            assert adv[0] == sat and not adv[1:].any()
        if vals[1] > 9.6e4:
            assert adv[-1] == sat


def test_plain_updates_phases_in_place():
    """The wrapper's contract: phases in place, the block returned; on the
    CPU no launch is counted."""
    f2pi = float(np.float32(2**30 / SR))
    scale = float(np.float32(2 * np.pi / 16384))
    params = torch.tensor([100.0, 200.0, 100.0, 0.1])
    ph = torch.zeros(8, dtype=torch.int32)
    before = kfc.LAUNCHES
    out = kfc.fm_cascade(params=params, phases=ph, block_size=32, f2pi=f2pi, scale=scale)
    assert out.shape == (32,) and kfc.LAUNCHES == before
    assert int(ph[0]) == 32 * int(np.float32(100.0) * np.float32(f2pi))
