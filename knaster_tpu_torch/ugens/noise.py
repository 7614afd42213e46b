"""Port of knaster_tpu/ugens/noise.py: ``WhiteNoise``, ``PinkNoise``, ``BrownNoise``, ``RandomLin``.

The JAX package draws its noise from ``jax.random``'s counter-based
Threefry-2x32, keyed per sample by (seed, absolute frame): the stream is a
pure function of (seed, frame), so any block partition renders the same
samples, and seeds come from a global counter in construction order
(reference noise.rs NEXT_SEED). The port restates that generator in torch,
word for word, so its noise is bit-identical to the JAX package's:

* ``fold_in(key, data)`` is Threefry over the key with the counter
  ``(0, data)``;
* ``random_bits`` of k draws on jax.random's *partitionable* path (the
  ``jax_threefry_partitionable`` flag, on in the JAX release the package
  is tested with) is Threefry over counters ``(0, i)``: 32-bit draws are
  ``b0 ^ b1``, 64-bit draws ``b0 << 32 | b1``;
* ``uniform`` puts the top mantissa bits under the exponent of 1.0 and
  subtracts 1;
* ``split`` returns the counters' ``(b0, b1)`` pairs as keys.

torch has no usable u32 arithmetic, so every u32 value is an int64 in
[0, 2^32): each add and shift left is masked, and every right shift is of a
non-negative int64, hence logical. State holds seeds and frames as the
int32 bit patterns of their u32 values, as ``convert`` carries them.

``WhiteNoise`` has a chain-kernel body (``kernel_stage``): the same two
Threefry evaluations per sample in ``csrc/chain_kernel.cu``.
"""

from __future__ import annotations

import itertools

import torch

from ..core.ugen import AudioCtx, UGen
from ..kernels.bank_common import i32_of, u32_of
from ..primitives.params import ParameterKind, pfloat
from .osc import recip_sample_rate

_NEXT_SEED = itertools.count()

PINK_NOISE_OCTAVES = 9
M32 = 0xFFFFFFFF
# Threefry-2x32's rotations (two alternating sets of four) and key parity
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def next_randomness_seed() -> int:
    """Deterministic per-construction-order seed (noise.rs:20 NEXT_SEED)."""
    return next(_NEXT_SEED)


def reset_randomness_seeds() -> None:
    global _NEXT_SEED
    _NEXT_SEED = itertools.count()


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter (x0, x1) under the key (k1,
    k2): int64 tensors (or ints) of u32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey`` of a u32 seed: the key (0, seed)."""
    return torch.zeros_like(seed), seed


def fold_in(key, data):
    """``jax.random.fold_in``: Threefry of the counter (0, data)."""
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def split(key, n: int = 2):
    """``jax.random.split`` on the partitionable path: the n keys Threefry
    gives for the counters (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(n)]


def uniform_of_bits(b0, b1, dtype):
    """``jax.random.uniform`` in [0, 1) from one draw's two Threefry words:
    f32 takes the top 23 bits of ``b0 ^ b1``, f64 the top 52 of ``b0 << 32 |
    b1``, each under the exponent of 1.0, minus 1."""
    if dtype == torch.float64:
        mant = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return mant.view(torch.float64) - 1.0
    mant = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform(key, k: int, dtype):
    """``jax.random.uniform(key, (k,), dtype)`` for keys of any leading
    shape: ``[..., k]``."""
    draws = [uniform_of_bits(*threefry2x32(key[0], key[1], 0, i), dtype) for i in range(k)]
    return torch.stack(draws, dim=-1)


def block_uniforms(seed_bits, frame_bits, B: int, k: int, dtype):
    """The noise stream of one block: ``[..., B, k]`` uniforms, sample t
    drawn from ``fold_in(PRNGKey(seed), frame + t)`` (the JAX package's
    ``_NoiseBase._block_uniforms``). Seeds and frames are int32 bit
    patterns of shape ``[...]``."""
    seed = u32_of(seed_bits).unsqueeze(-1)
    frames = (u32_of(frame_bits).unsqueeze(-1)
              + torch.arange(B, device=seed.device)) & M32
    return uniform(fold_in(prng_key(seed.expand_as(frames)), frames), k, dtype)


def advance_frame(frame_bits, n: int):
    """The frame counter ``n`` samples on, wrapping at 2^32 (bit patterns)."""
    return i32_of((u32_of(frame_bits) + n) & M32)


class _NoiseBase(UGen):
    inputs = 0
    outputs = 1
    params = ()

    def __init__(self, seed: int | None = None):
        self.seed = next_randomness_seed() if seed is None else int(seed)

    def batch_key(self):
        # the seed is state, not configuration: same-kind noise nodes batch
        # and WhiteNoise joins collapsed chains
        return (type(self),)

    def _seed_state(self, device):
        return {"seed": i32_of(torch.tensor(self.seed & M32, device=device)),
                "frame": torch.zeros((), dtype=torch.int32, device=device)}

    def init(self, ctx: AudioCtx, device="cpu"):
        return self._seed_state(device)

    def _uniforms(self, ctx, state, k=1):
        return block_uniforms(state["seed"], state["frame"], ctx.block_size, k, ctx.dtype)

    def _next_counters(self, ctx, state):
        return {"seed": state["seed"], "frame": advance_frame(state["frame"], ctx.block_size)}


def white_noise_block(seed_bits, frame_bits, B: int, dtype):
    """One block of WhiteNoise: uniforms mapped to (-1, 1), ``[..., B]``."""
    return block_uniforms(seed_bits, frame_bits, B, 1, dtype)[..., 0] * 2.0 - 1.0


class WhiteNoise(_NoiseBase):
    """Uniform white noise in (-1, 1) (noise.rs:25-50 WhiteNoise)."""

    def process(self, ctx: AudioCtx, state, inputs, params):
        out = white_noise_block(state["seed"], state["frame"], ctx.block_size, ctx.dtype)
        return self._next_counters(ctx, state), out.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        """Chain-kernel body: the same (seed, frame)-keyed stream, two
        Threefry evaluations per sample, bit-identical to ``process``."""
        from ..kernels.chain_kernel import BODIES

        return BODIES["white_noise"], 0


class PinkNoise(_NoiseBase):
    """Voss-McCartney pink noise (noise.rs:51-120 PinkNoise): white-noise
    octaves selected by the trailing zeros of a wrapping counter, plus an
    always-on white source; usually within +-0.75. Its block is
    ``kernels/pink_noise.py``."""

    def init(self, ctx: AudioCtx, device="cpu"):
        z = torch.zeros((), dtype=ctx.dtype, device=device)
        return {**self._seed_state(device),
                "whites": torch.zeros((PINK_NOISE_OCTAVES,), dtype=ctx.dtype, device=device),
                "always_on": z, "counter": torch.ones((), dtype=torch.int32, device=device),
                "pink": z.clone()}

    def process(self, ctx: AudioCtx, state, inputs, params):
        # one launch of csrc/pink_noise.cu a block on the card, its plain
        # torch version (the JAX package's vectorized recurrence) on the CPU
        from ..kernels.pink_noise import pink_noise

        return pink_noise(state, ctx.block_size)


class BrownNoise(_NoiseBase):
    """Integrated white noise, clamped to +-1 (noise.rs:122-160 BrownNoise)."""

    def init(self, ctx: AudioCtx, device="cpu"):
        return {**self._seed_state(device),
                "last": torch.zeros((), dtype=ctx.dtype, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        w = self._uniforms(ctx, state)[..., 0] * 2.0 - 1.0
        last, outs = state["last"], []
        for t in range(ctx.block_size):  # a clamped sum: no scan form
            last = torch.clamp(last + w[..., t] * 0.1, -1.0, 1.0)
            outs.append(last)
        return ({**self._next_counters(ctx, state), "last": last},
                torch.stack(outs, dim=-1).unsqueeze(-2))


class RandomLin(_NoiseBase):
    """Linearly interpolated random values in [0, 1) at a given frequency
    (noise.rs:163-230 RandomLin)."""

    params = (pfloat("freq", 1.0, kind=ParameterKind.FREQUENCY),)

    def __init__(self, freq: float = 1.0, seed: int | None = None):
        super().__init__(seed)
        self.pdefaults = {"freq": float(freq)}

    def init(self, ctx: AudioCtx, device="cpu"):
        key = (0, self.seed & M32)
        k0, k1 = split(key)
        first, second = (uniform((torch.tensor(k[0]), torch.tensor(k[1])), 1, ctx.dtype)[0]
                         for k in (k0, k1))
        z = torch.zeros((), dtype=ctx.dtype, device=device)
        return {**self._seed_state(device), "current": first.to(device),
                "width": (second - first).to(device), "phase": z}

    def process(self, ctx: AudioCtx, state, inputs, params):
        rand = self._uniforms(ctx, state)[..., 0]
        freq = params["freq"]
        step = freq * recip_sample_rate(ctx.sample_rate, freq)
        cur, width, phase = state["current"], state["width"], state["phase"]
        zero = torch.zeros((), dtype=ctx.dtype, device=freq.device)
        outs = []
        for t in range(ctx.block_size):  # the reference's per-sample wrap
            outs.append(cur + phase * width)
            phase = phase + step[..., t]
            wrap = phase >= 1.0
            target = cur + width
            cur = torch.where(wrap, target, cur)
            width = torch.where(wrap, rand[..., t] - target, width)
            phase = torch.where(wrap, zero, phase)
        new_state = {**self._next_counters(ctx, state), "current": cur, "width": width,
                     "phase": phase}
        return new_state, torch.stack(outs, dim=-1).unsqueeze(-2)
