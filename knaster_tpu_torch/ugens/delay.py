"""Port of knaster_tpu/ugens/delay.py: the delays (reference delay.rs).

Ring buffers live in the state dict. Every read of a ring is an indexed
load, vectorised over the block: the samples a block can reach are its
history ``hist = [ring oldest-first | the block's input]``, and a sample
delayed by d (at most the ring's length) reads ``hist[L + t - d]``. That is
pure data movement, so it equals the JAX package's per-sample ``lax.scan``
bit for bit. Only the allpass interpolators' own recurrences (and the
feedback delay's writes, which depend on its outputs) keep a per-sample
loop where the JAX package has one. The ``long=True`` allpass path reads a
ring that the block cannot reach and runs its interpolator as an affine
scan (``core/dsp.affine_scan_1d``), as the JAX package's does.

``SampleDelay`` has a chain-kernel body (``kernel_stage``): its state, the
ring and the write position, is L + 1 state words per stage, and the
kernel reads ``hist`` as this module does (``sample_delay_block``).
"""

from __future__ import annotations

import torch

from ..core.dsp import affine_scan_1d
from ..core.ugen import AudioCtx, UGen
from ..primitives.params import ParameterKind, pfloat
from ..primitives.time import Seconds


def _as_seconds(x) -> Seconds:
    return x if isinstance(x, Seconds) else Seconds.from_secs_f64(float(x))


def _ring_oldest_first(buf, pos):
    """``buf[(pos + j) % L]`` for j in [0, L): ``[..., L]``; pos ``[...]``."""
    L = buf.shape[-1]
    idx = (pos.long().unsqueeze(-1) + torch.arange(L, device=buf.device)) % L
    return torch.gather(buf, -1, idx)


def _ring_from_oldest_first(tail, pos):
    """The ring whose oldest-first view from ``pos`` is ``tail``: slot s
    holds ``tail[(s - pos) % L]``."""
    L = tail.shape[-1]
    idx = (torch.arange(L, device=tail.device) - pos.long().unsqueeze(-1)) % L
    return torch.gather(tail, -1, idx)


def delay_history(buf, pos, x):
    """The samples a block can reach, ``[ring oldest-first | x]``:
    ``[..., L + B]``."""
    return torch.cat([_ring_oldest_first(buf, pos), x], dim=-1)


def advance_ring(hist, pos, B: int):
    """(the ring after a block whose history is ``hist``, the write
    position after it): the last L samples of ``hist``, anchored at ``(pos
    + B) % L`` as the per-sample scan leaves them."""
    L = hist.shape[-1] - B
    new_pos = (pos.long() + B) % L
    return _ring_from_oldest_first(hist[..., B:], new_pos), new_pos.to(torch.int32)


def delay_samples(delay_time, sample_rate, L: int):
    """clip(trunc(delay_time * sr), 0, L - 1) as int64 (NaN and negative
    times give 0)."""
    x = delay_time * float(sample_rate)
    return torch.where(x > 0, x, torch.zeros_like(x)).clamp(max=L - 1).long()


def sample_delay_block(buf, pos, x, d):
    """One block of SampleDelay over ``[..., B]`` rows: write before read,
    sample t reads ``hist[L + t - d[t]]`` (d = 0 passes the input
    through). Returns (new buf, new pos, out)."""
    L, B = buf.shape[-1], x.shape[-1]
    hist = delay_history(buf, pos, x)
    out = torch.gather(hist, -1, L + torch.arange(B, device=x.device) - d)
    new_buf, new_pos = advance_ring(hist, pos, B)
    return new_buf, new_pos, out


class SampleDelay(UGen):
    """Integer-sample delay, no interpolation (delay.rs:14-50 SampleDelay).

    Good for triggers. Delay time in seconds, truncated to whole samples.
    A delay of 0 passes the input through (write happens before read)."""

    inputs = 1
    outputs = 1
    params = (pfloat("delay_time", 0.0, kind=ParameterKind.SECONDS),)

    def __init__(self, max_delay_length):
        self.max_delay_length = _as_seconds(max_delay_length)

    def batch_key(self):
        # equal max length, equal ring: eligible for auto-batching and
        # chain collapse
        return (type(self), self.max_delay_length.to_secs_f64())

    def length(self, ctx: AudioCtx) -> int:
        """The ring's length L in samples."""
        return max(1, int(self.max_delay_length.to_secs_f64() * ctx.sample_rate))

    def init(self, ctx: AudioCtx, device="cpu"):
        return {"buf": torch.zeros((self.length(ctx),), dtype=ctx.dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}

    def process(self, ctx: AudioCtx, state, inputs, params):
        L = state["buf"].shape[-1]
        d = delay_samples(params["delay_time"], ctx.sample_rate, L)
        buf, pos, out = sample_delay_block(state["buf"], state["pos"], inputs[..., 0, :], d)
        return {"buf": buf, "pos": pos}, out.unsqueeze(-2)

    def kernel_stage(self, ctx: AudioCtx):
        """Chain-kernel body: the ring as L state words, read through the
        block's history as ``process`` reads it; ``arg`` is L."""
        from ..kernels.chain_kernel import BODIES

        return BODIES["sample_delay"], self.length(ctx)


def _delay_geometry(delay_frames, L: int, dtype):
    """Whole frames and the allpass coefficient with the 0.5-frame trick
    (delay.rs set_delay_in_frames:160-178): (nf int64, coeff)."""
    nf_f = torch.floor(delay_frames)
    delta = delay_frames - nf_f
    adjust = (delay_frames > 0.5) & (delta < 0.5)
    delta = torch.where(adjust, delta + 1.0, delta)
    nf = (nf_f.to(torch.int32) - adjust.to(torch.int32)).clamp(0, L - 1).long()
    one = torch.ones((), dtype=dtype, device=delay_frames.device)
    return nf, ((one - delta) / (one + delta)).to(dtype)


def _blockwise_read(state, nf, coeff):
    """The long path's ring read and allpass interpolation (nf >= B, so no
    read reaches this block's writes). Returns (raw [..., B], delayed [...,
    B]); the interpolator out[t] = -coeff*out[t-1] + (coeff*raw[t] +
    raw[t-1]) is an affine scan."""
    buf, wp = state["buf"], state["wp"].long().unsqueeze(-1)
    L, B = buf.shape[-1], nf.shape[-1]
    t = torch.arange(B, device=buf.device)
    raw = torch.gather(buf, -1, (wp + t + L - nf) % L)
    raw_prev = torch.cat([state["ap_in"].unsqueeze(-1), raw[..., :-1]], dim=-1)
    a = -coeff
    b = coeff * raw + raw_prev
    out_pre, _ = affine_scan_1d(a, b, state["ap_out"])
    return raw, a * out_pre + b


def _allpass_delay_init(ugen, ctx, device):
    n = max(2, int(ugen.max_delay_time.to_samples(ctx.sample_rate)))
    if ugen.long and ugen.min_delay_time is not None:
        # superblocks are safe up to the declared minimum delay: the
        # >= block clamp never engages below it
        ugen.superblock_cap = min(n, int(ugen.min_delay_time.to_samples(ctx.sample_rate)))
    one = torch.ones((), dtype=ctx.dtype, device=device)
    return {"buf": torch.zeros((n,), dtype=ctx.dtype, device=device),
            "wp": torch.zeros((), dtype=torch.int32, device=device),
            # the allpass interpolator's state; the reference inits both to 1
            "ap_in": one, "ap_out": one.clone()}


class AllpassDelay(UGen):
    """Fractional delay with Schroeder allpass interpolation
    (delay.rs:53-205 AllpassDelay + AllpassInterpolator).

    ``long=True`` declares that the delay stays at least one block (echoes,
    reverb lines): the ring read is blockwise and the interpolator an
    affine scan, the delay clamped to the block length. ``min_delay_time``
    (long mode only) declares a lower bound on the delay, which becomes the
    node's ``superblock_cap``; without it a long delay keeps its graph out
    of superblocks."""

    inputs = 1
    outputs = 1
    params = (pfloat("delay_time", 0.0, kind=ParameterKind.SECONDS),)

    def __init__(self, max_delay_time, long: bool = False, min_delay_time=None):
        self.max_delay_time = _as_seconds(max_delay_time)
        self.long = bool(long)
        # the long path clamps delays to >= one block: block-dependent
        self.block_invariant = not self.long
        self.min_delay_time = None if min_delay_time is None else _as_seconds(min_delay_time)

    def init(self, ctx: AudioCtx, device="cpu"):
        return _allpass_delay_init(self, ctx, device)

    def process(self, ctx: AudioCtx, state, inputs, params):
        L, B = state["buf"].shape[-1], ctx.block_size
        df = torch.clamp(params["delay_time"] * float(ctx.sample_rate), 0.0, float(L))
        nf, coeff = _delay_geometry(df, L, ctx.dtype)
        x = inputs[..., 0, :]
        if self.long and L >= B:
            raw, delayed = _blockwise_read(state, nf.clamp(min=B), coeff)
            buf, wp = advance_ring(delay_history(state["buf"], state["wp"], x), state["wp"], B)
            return ({"buf": buf, "wp": wp, "ap_in": raw[..., -1], "ap_out": delayed[..., -1]},
                    delayed.unsqueeze(-2))
        # read before write at wp - nf: a read may reach this block's own
        # writes, and a delay of 0 reads the sample written L steps before
        hist = delay_history(state["buf"], state["wp"], x)
        back = torch.where(nf > 0, nf, torch.full_like(nf, L))
        raw = torch.gather(hist, -1, L + torch.arange(B, device=x.device) - back)
        ap_in, ap_out, outs = state["ap_in"], state["ap_out"], []
        for t in range(B):  # the interpolator, sample by sample
            ap_out = coeff[..., t] * (raw[..., t] - ap_out) + ap_in
            ap_in = raw[..., t]
            outs.append(ap_out)
        buf, wp = advance_ring(hist, state["wp"], B)
        return ({"buf": buf, "wp": wp, "ap_in": ap_in, "ap_out": ap_out},
                torch.stack(outs, dim=-1).unsqueeze(-2))


class AllpassFeedbackDelay(UGen):
    """Schroeder allpass with feedback (delay.rs:210-305
    AllpassFeedbackDelay): delayed = read(); write(delayed*fb + x); out =
    delayed - fb*written. ``long`` and ``min_delay_time`` as in
    ``AllpassDelay``."""

    inputs = 1
    outputs = 1
    params = (
        pfloat("feedback", 0.0),
        pfloat("delay_time", 0.0, kind=ParameterKind.SECONDS),
    )

    def __init__(self, max_delay_time, feedback: float = 0.0, long: bool = False,
                 min_delay_time=None):
        self.max_delay_time = _as_seconds(max_delay_time)
        self.long = bool(long)
        self.block_invariant = not self.long
        self.min_delay_time = None if min_delay_time is None else _as_seconds(min_delay_time)
        # the default delay is the maximum (reference previous_delay_time)
        self.pdefaults = {"feedback": float(feedback),
                          "delay_time": self.max_delay_time.to_secs_f64()}

    def init(self, ctx: AudioCtx, device="cpu"):
        return _allpass_delay_init(self, ctx, device)

    def process(self, ctx: AudioCtx, state, inputs, params):
        L, B = state["buf"].shape[-1], ctx.block_size
        df = torch.clamp(params["delay_time"] * float(ctx.sample_rate), 0.0, float(L))
        nf, coeff = _delay_geometry(df, L, ctx.dtype)
        fb, x = params["feedback"], inputs[..., 0, :]
        if self.long and L >= B:
            raw, delayed = _blockwise_read(state, nf.clamp(min=B), coeff)
            write = delayed * fb + x
            buf, wp = advance_ring(delay_history(state["buf"], state["wp"], write),
                                   state["wp"], B)
            return ({"buf": buf, "wp": wp, "ap_in": raw[..., -1], "ap_out": delayed[..., -1]},
                    (delayed - fb * write).unsqueeze(-2))
        # the writes depend on the outputs: sample by sample
        buf, wp = state["buf"], state["wp"].long()
        ap_in, ap_out, outs = state["ap_in"], state["ap_out"], []
        for t in range(B):
            raw = torch.gather(buf, -1, ((wp + L - nf[..., t]) % L).unsqueeze(-1))[..., 0]
            ap_out = coeff[..., t] * (raw - ap_out) + ap_in
            ap_in = raw
            write = ap_out * fb[..., t] + x[..., t]
            buf = buf.scatter(-1, wp.unsqueeze(-1), write.unsqueeze(-1))
            outs.append(ap_out - fb[..., t] * write)
            wp = (wp + 1) % L
        return ({"buf": buf, "wp": wp.to(torch.int32), "ap_in": ap_in, "ap_out": ap_out},
                torch.stack(outs, dim=-1).unsqueeze(-2))


class StaticSampleDelay:
    """Fixed-length sample delay with functional state (delay.rs:308-416):
    a building block of the reverbs (Galactic), not a UGen. A sample comes
    out exactly ``length`` samples after it went in."""

    def __init__(self, delay_length_in_samples: int):
        if delay_length_in_samples <= 0:
            raise ValueError("delay_length_in_samples must be > 0")
        self.length = int(delay_length_in_samples)

    def make_state(self, dtype=torch.float32, device="cpu"):
        return {"buf": torch.zeros((self.length,), dtype=dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}

    def process_block(self, state, x):
        """Delay a block ``[..., B]``: returns (state', delayed block). Read
        before write: sample t reads ``hist[t]``."""
        B = x.shape[-1]
        hist = delay_history(state["buf"], state["pos"], x)
        buf, pos = advance_ring(hist, state["pos"], B)
        return {"buf": buf, "pos": pos}, hist[..., :B]

    def read_at_lin(self, state, index):
        """Linearly interpolated read at a fractional index."""
        L, buf = self.length, state["buf"]
        fl = torch.floor(index)
        low = fl.long() % L
        high = (low + 1) % L
        lo, hi = buf[low], buf[high]
        return lo + (hi - lo) * (index - fl)
