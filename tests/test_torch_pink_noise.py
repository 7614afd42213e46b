"""PinkNoise's block kernel (``kernels/pink_noise.py``, ``csrc/pink_noise.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it
bit-equal to ``pink_noise_plain`` at the live path's shapes. Here:

- ``kernel_steps`` restates the kernel's steps in numpy scalars of the
  block's dtype, in its order: the draws from the plain version's noise
  stream, then the Voss-McCartney recurrence and the base-16 prefix sum
  sample by sample, as thread 0 runs them. It is bit-equal to
  ``pink_noise_plain`` (output and state) at lengths around the scan's rows
  of 16, at the live path's superblocks and at f32 and f64, from random
  states (counters at every phase, frames near the u32 wrap);
- on CPU tensors ``pink_noise`` runs the plain version and launches
  nothing, and ``launch`` refuses them;
- ``PinkNoise.process`` is ``pink_noise`` over a batched state.
"""

import numpy as np
import pytest
import torch

import knaster_tpu_torch as kt
import knaster_tpu_torch.kernels.pink_noise as pn
from knaster_tpu_torch.ugens.noise import block_uniforms

DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def random_state(n, dtype, seed):
    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.from_numpy(a.astype(np.int64).astype(np.uint32).view(np.int32))  # noqa: E731
    return {
        "seed": i32(rng.integers(0, 2**32, n)),
        "frame": i32(rng.integers(2**32 - 5000, 2**32, n)),
        "whites": torch.from_numpy(rng.uniform(-1, 1, (n, pn.OCTAVES))).to(dtype),
        "always_on": torch.from_numpy(rng.uniform(-1, 1, n)).to(dtype),
        "counter": torch.from_numpy(rng.integers(1, 257, n).astype(np.int32)),
        "pink": torch.from_numpy(rng.uniform(-3, 3, n)).to(dtype),
    }


def scan_base16(x, work_dtype):
    """The kernel's scan_base16 on a numpy array, in place."""
    z = work_dtype(0)
    n = len(x)
    if n <= 16:
        acc = x[0] + z
        x[0] = acc
        for c in range(1, n):
            acc = acc + x[c]
            x[c] = acc
        return
    rows = -(-n // 16)
    work = np.zeros(rows, work_dtype)
    for r in range(rows):
        c0 = r * 16
        acc = x[c0] + z
        x[c0] = acc
        for c in range(c0 + 1, c0 + 16):
            acc = acc + (x[c] if c < n else z)
            if c < n:
                x[c] = acc
        work[r] = acc
    scan_base16(work, work_dtype)
    for r in range(rows):
        before = work[r - 1] if r > 0 else z
        for c in range(r * 16, min(n, (r + 1) * 16)):
            x[c] = x[c] + before


def kernel_steps(state, B):
    """csrc/pink_noise.cu's block, instance by instance: (next state, out)."""
    tdt = state["pink"].dtype
    T = DTYPES[tdt]
    u = (block_uniforms(state["seed"], state["frame"], B, 2, tdt)).numpy()
    n = state["seed"].shape[0]
    outs, new = [], {k: [] for k in ("whites", "always_on", "counter", "pink")}
    for i in range(n):
        x0 = u[i, :, 0] * T(2) - T(1)
        x1 = u[i, :, 1] * T(2) - T(1)
        w = state["whites"][i].numpy().copy()
        x1_prev = T(state["always_on"][i].item())
        c0 = int(state["counter"][i])
        d = np.zeros(B, T)
        for t in range(B):
            c = ((c0 - 1 + t) & 255) + 1
            octave = (c & -c).bit_length() - 1
            removed = w[octave] + T(0)
            w[octave] = x0[t]
            d[t] = ((x0[t] - removed) + x1[t]) - x1_prev
            x1_prev = x1[t]
        scan_base16(d, T)
        p0 = T(state["pink"][i].item())
        pink = np.array([p0 + s for s in d], T)
        outs.append(pink * (T(1) / T(10)))
        new["whites"].append(w)
        new["always_on"].append(x1_prev)
        new["counter"].append(((c0 - 1 + B) & 255) + 1)
        new["pink"].append(pink[-1])
    return ({k: np.array(v) for k, v in new.items()},
            np.stack(outs)[:, None, :])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 16, 17, 64, 257, 1088])
def test_kernel_steps_match_the_plain_version(B, dtype):
    state = random_state(3, dtype, seed=B)
    want_state, want = pn.pink_noise_plain(state, B)
    got_state, got = kernel_steps(state, B)
    assert want.shape == (3, 1, B) and got.dtype == DTYPES[dtype]
    np.testing.assert_array_equal(got.view(np.uint8), want.numpy().view(np.uint8))
    for k, v in got_state.items():
        np.testing.assert_array_equal(v, want_state[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(want_state["frame"].numpy().astype(np.uint32),
                                  state["frame"].numpy().astype(np.uint32) + np.uint32(B))


def test_cpu_tensors_run_the_plain_version():
    state = random_state(2, torch.float32, seed=1)
    before = pn.LAUNCHES
    new, out = pn.pink_noise(state, 64)
    want_state, want = pn.pink_noise_plain(state, 64)
    assert pn.LAUNCHES == before
    assert torch.equal(out, want)
    assert all(torch.equal(new[k], want_state[k]) for k in want_state)
    with pytest.raises(ValueError, match="unsupported device"):
        pn.launch(state, 64)


def test_pink_noise_ugen_is_the_wrapper():
    ctx = kt.AudioCtx(48000, 64, torch.float32)
    ugen = kt.PinkNoise(seed=9)
    state = {k: torch.stack([v, v]) for k, v in ugen.init(ctx, "cpu").items()}
    state["seed"] = state["seed"] + torch.tensor([0, 1], dtype=torch.int32)
    for _ in range(3):
        new, out = ugen.process(ctx, state, None, {})
        want_state, want = pn.pink_noise(state, 64)
        assert out.shape == (2, 1, 64) and torch.equal(out, want)
        assert all(torch.equal(new[k], want_state[k]) for k in want_state)
        state = new
    assert not torch.equal(out[0], out[1]) and float(out.abs().max()) > 0
