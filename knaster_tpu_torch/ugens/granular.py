"""Port of knaster_tpu/ugens/granular.py: ``GrainPlayer``, a granular cloud over a shared buffer.

A deterministic scheduler spawns grains at ``density`` Hz into a fixed
pool of ``grains`` slots (round-robin reuse); every per-grain random
quantity comes from Threefry keyed by (seed, spawn counter), so a render
is a function of the seed alone, whatever the block partition.

The port takes the JAX package's closed-form ``process``: the only
recurrence is the two-scalar countdown scheduler, run sample by sample over
the block; everything else is ``[..., B, G]`` elementwise work. Spawn j of
the block lands in slot ``(counter0 + j) mod G``, so the last spawn
governing slot g at sample i is ``offs + G * floor((n_i - 1 - offs) / G)``
with ``offs = (g - g0) mod G`` and ``n_i`` the spawns applied by sample i.
The JAX package routes the event tables through a one-hot matmul and reads
the source through windowed tiles where ``max_rate`` is set; both are TPU
reformulations of a gather, held bit-identical to it by its tests, so the
port gathers. ``max_rate`` keeps its clamp on the grain step.

The per-grain draws are ``jax.random.uniform(fold_in(key(seed), counter),
(3,), minval=-1, maxval=1)``, taken from the port's Threefry restatement
(``noise.py``) in ``ctx.dtype``. The seed and the spawn counter are u32
state, held as int32 bit patterns; the seed is state, not configuration,
so same-config players over one Buffer batch into one plan item.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen
from ..kernels.bank_common import i32_of, u32_of
from ..primitives.params import pfloat, ptrigger
from .buffer import Buffer
from .noise import M32, fold_in, prng_key, threefry2x32, uniform_of_bits

_WINDOWS = ("hann", "triangle", "rect")
# f32 constants, as the JAX package writes them (np.float32 scalars keep
# their f32 value at f64 too)
_TWO_PI = float(np.float32(2 * np.pi))
_HALF_PI = float(np.float32(np.pi / 2))


class GrainPlayer(UGen):
    """Granular cloud over a shared source buffer (stereo out).

    Params (sampled at the spawn frame for per-grain frozen quantities):
    ``density`` grains/s (at most one spawn a frame), ``grain_dur`` s,
    ``rate`` (1.0 = natural speed, scaled by the buffer/server rate ratio),
    ``pos`` s, ``pos_jitter`` (uniform +- spread, s), ``rate_jitter``
    (octaves), ``pan_spread`` (0 = center, 1 = full field), ``amp`` (live,
    per sample), ``t_spawn`` (force a grain at this exact frame and
    re-anchor the scheduler). ``loop=True`` wraps reads around the buffer's
    end, else reads outside it are silent. Reads use channel ``channel``.
    ``max_rate`` clamps each grain's step to +-max_rate (natural-speed
    units)."""

    params = (
        pfloat("density", 10.0, range=(0.01, 48000.0), logarithmic=True),
        pfloat("grain_dur", 0.1, range=(0.0005, 10.0), logarithmic=True),
        pfloat("rate", 1.0, range=(-8.0, 8.0)),
        pfloat("pos", 0.0),
        pfloat("pos_jitter", 0.0),
        pfloat("rate_jitter", 0.0, range=(0.0, 4.0)),
        pfloat("pan_spread", 1.0, range=(0.0, 1.0)),
        pfloat("amp", 1.0),
        ptrigger("t_spawn"),
    )

    def __init__(self, buffer: Buffer, grains: int = 32, seed: int = 0,
                 window: str = "hann", loop: bool = True, channel: int = 0,
                 max_rate: float | None = None, **defaults):
        if window not in _WINDOWS:
            raise ValueError(f"window must be one of {_WINDOWS}")
        if not 1 <= grains <= 1024:
            raise ValueError("grains must be in [1, 1024]")
        if not 0 <= channel < buffer.channels:
            raise ValueError(f"channel {channel} out of range for "
                             f"{buffer.channels}-channel buffer")
        if max_rate is not None and not 0 < float(max_rate) <= 8.0:
            raise ValueError("max_rate must be in (0, 8]")
        self.buffer = buffer
        self.grains = int(grains)
        self.seed = int(seed)
        self.window = window
        self.loop = bool(loop)
        self.channel = int(channel)
        self.max_rate = None if max_rate is None else float(max_rate)
        self.inputs = 0
        self.outputs = 2
        self.pdefaults = dict(defaults)

    def batch_key(self):
        # the seed lives in state: same-config players over one Buffer
        # object run as one batched call
        return (type(self), self.grains, self.window, self.loop, self.channel,
                self.max_rate, id(self.buffer))

    def init(self, ctx: AudioCtx, device="cpu"):
        G, dtype = self.grains, ctx.dtype

        def zeros(shape=(), dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return {
            # u32 seed and spawn counter as int32 bit patterns
            "seed": i32_of(torch.tensor(self.seed & M32, device=device)),
            "countdown": zeros(),  # samples until the next natural spawn
            "counter": zeros(dt=torch.int32),
            # per-slot grain state; dur == 0 marks a free slot
            "age": zeros((G,), torch.int32),
            "dur": zeros((G,)), "src0": zeros((G,)), "step": zeros((G,)),
            "gl": zeros((G,)), "gr": zeros((G,)),
        }

    def _window(self, ph):
        if self.window == "hann":
            return 0.5 - 0.5 * torch.cos(_TWO_PI * ph)
        if self.window == "triangle":
            return 1.0 - torch.abs(2.0 * ph - 1.0)
        return torch.ones_like(ph)

    def _max_step(self, ctx):
        return self.max_rate * self.buffer.buf_rate_scale(ctx.sample_rate)

    def _read_source(self, src, active, dtype):
        """Linear-interpolated source read with loop or clip semantics; the
        sample is meaningful only where ``valid`` is set."""
        n = self.buffer.frames
        buf0 = self.buffer.on(src.device, dtype)[self.channel]
        idx = torch.floor(src)
        frac = src - idx
        idx = idx.to(torch.int32).long()
        if self.loop:
            i0, i1 = idx.remainder(n), (idx + 1).remainder(n)
            valid = active
        else:
            i0, i1 = idx.clamp(0, n - 1), (idx + 1).clamp(0, n - 1)
            valid = active & (idx >= 0) & (idx < n - 1)
        return buf0[i0] * (1.0 - frac) + buf0[i1] * frac, valid

    def _schedule(self, ctx, state, period, t_spawn):
        """The countdown scheduler, sample by sample: each sample's due flag
        and the final countdown."""
        cd, dues = state["countdown"], []
        for i in range(period.shape[-1]):
            cd = cd - 1.0
            p = period[..., i]
            due = cd <= 0.0
            if ctx.no_events:
                cd = torch.where(due, cd + p, cd)
            else:
                t = t_spawn[..., i]
                due = due | t
                cd = torch.where(due, torch.where(t, p, cd + p), cd)
            dues.append(due)
        return torch.stack(dues, dim=-1), cd

    def process(self, ctx: AudioCtx, state, inputs, params):
        G, dtype = self.grains, ctx.dtype
        sr = float(ctx.sample_rate)
        bsr = float(self.buffer.sample_rate)
        density = params["density"].clamp(0.01, sr)
        # a tensor numerator: torch takes ``scalar / tensor`` as a reciprocal
        # and a product, two roundings
        period = density.new_tensor(sr) / density
        dur_smp = (params["grain_dur"] * sr).clamp(min=1.0)
        pos_f = params["pos"] * bsr
        posj_f = params["pos_jitter"] * bsr
        rate_p = params["rate"] * float(np.float32(self.buffer.buf_rate_scale(ctx.sample_rate)))
        ratej, spread = params["rate_jitter"], params["pan_spread"]
        B = period.shape[-1]
        dev = period.device
        i_ar = torch.arange(B, device=dev)

        # phase 1: the scheduler, the only recurrence
        due, countdown = self._schedule(ctx, state, period, params["t_spawn"])
        due_i = due.long()
        n_applied = torch.cumsum(due_i, dim=-1)  # spawns applied by sample i
        e_local = n_applied - due_i  # spawns before sample i
        ctr0 = u32_of(state["counter"])

        # phase 2, parallel: event j of the block happens at sample
        # s_of_e[j] and lands in slot (counter0 + j) mod G
        lead = due.shape[:-1]
        slot = torch.where(due, e_local, torch.full_like(e_local, B))
        s_of_e = torch.zeros(lead + (B + 1,), dtype=torch.long, device=dev).scatter(
            -1, slot, i_ar.expand(lead + (B,)))[..., :B]

        # per-event draws: uniform(fold_in(key(seed), counter0 + j), (3,))
        # in [-1, 1)
        ev_ctr = (ctr0.unsqueeze(-1) + i_ar) & M32
        seed = u32_of(state["seed"]).unsqueeze(-1).expand(ev_ctr.shape)
        k0, k1 = fold_in(prng_key(seed), ev_ctr)
        draw = torch.arange(3, device=dev)
        b0, b1 = threefry2x32(k0.unsqueeze(-1), k1.unsqueeze(-1), torch.zeros_like(draw), draw)
        u = torch.clamp(uniform_of_bits(b0, b1, dtype) * 2.0 - 1.0, min=-1.0)  # [..., B, 3]

        def at_events(x):
            return torch.gather(x, -1, s_of_e)

        ev_dur = at_events(dur_smp)
        ev_src0 = at_events(pos_f) + at_events(posj_f) * u[..., 0]
        ev_step = at_events(rate_p) * torch.exp2(u[..., 1] * at_events(ratej))
        if self.max_rate is not None:
            ms = float(np.float32(abs(self._max_step(ctx))))
            ev_step = ev_step.clamp(-ms, ms)
        angle = ((u[..., 2] * at_events(spread)) * 0.5 + 0.5) * _HALF_PI
        ev_gl, ev_gr = torch.cos(angle), torch.sin(angle)

        # the last event governing slot g at sample i, in closed form
        g0 = (ctr0 % G).unsqueeze(-1)
        offs = (torch.arange(G, device=dev) - g0).remainder(G).unsqueeze(-2)  # [..., 1, G]
        n_bg = n_applied.unsqueeze(-1)  # [..., B, 1]
        has = n_bg > offs  # [..., B, G]
        j = (offs + G * torch.div(n_bg - 1 - offs, G, rounding_mode="floor")).clamp(0, B - 1)
        jf = j.reshape(lead + (B * G,))
        tab = torch.stack([ev_dur, ev_src0, ev_step, ev_gl, ev_gr], dim=-2)  # [..., 5, B]
        vals = torch.gather(tab, -1, jf.unsqueeze(-2).expand(lead + (5, B * G)))
        ev_dur_j, ev_src0_j, ev_step_j, ev_gl_j, ev_gr_j = (
            vals[..., k, :].reshape(lead + (B, G)) for k in range(5))
        s_of_e_j = torch.gather(s_of_e, -1, jf).reshape(lead + (B, G))

        def held(ev, key):
            return torch.where(has, ev, state[key].unsqueeze(-2))

        dur, src0, step = held(ev_dur_j, "dur"), held(ev_src0_j, "src0"), held(ev_step_j, "step")
        gl, gr = held(ev_gl_j, "gl"), held(ev_gr_j, "gr")
        i_col = i_ar.unsqueeze(-1)
        age = torch.where(has, i_col - s_of_e_j,
                          state["age"].unsqueeze(-2).long() + (i_col + 1)).to(torch.int32)

        a = age.to(dtype)
        active = a < dur
        zero = torch.zeros((), dtype=dtype, device=dev)
        w = torch.where(active, self._window(a / dur), zero)
        s, valid = self._read_source(src0 + a * step, active, dtype)
        sig = torch.where(valid, w * s, zero)
        amp = params["amp"]
        out = torch.stack([torch.sum(sig * gl, dim=-1) * amp,
                           torch.sum(sig * gr, dim=-1) * amp], dim=-2)
        new_state = {
            "seed": state["seed"], "countdown": countdown,
            "counter": i32_of((ctr0 + n_applied[..., -1]) & M32),
            "age": age[..., -1, :], "dur": dur[..., -1, :], "src0": src0[..., -1, :],
            "step": step[..., -1, :], "gl": gl[..., -1, :], "gr": gr[..., -1, :],
        }
        return new_state, out
