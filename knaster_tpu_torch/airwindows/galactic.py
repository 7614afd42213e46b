"""Port of knaster_tpu/airwindows/galactic.py: the Galactic stereo reverb (airwindows, galactic.rs).

Per channel: input -> a 256-sample vibrato (detune) delay read at a
drifting sine offset -> pre lowpass -> three cascaded banks of four delay
lines mixed by a Householder-like matrix (2 b[i] - sum b) -> feedback to
the other channel's first bank -> post lowpass -> wet/dry -> the airwindows
floating-point dither.

Two paths, as in the JAX package. ``blockwise=True`` (the default)
evaluates a whole block at once: every line is at least a block long, so
no read reaches the block's own writes (effective lengths are clamped to
B + 1 and ``bigness`` is read at block rate); the xorshift dither stream is
a GF(2) bit-matrix product (``_xorshift_columns``), the vibrato phase a
prefix sum with at most one 2 pi reset a block, and the two lowpasses
affine scans. ``blockwise=False`` runs the exact per-sample recurrence.

Numerics: the xorshift is on u32 values held as int64 (masked after every
shift left, as ``ugens/noise.py``); the dither converts the u32 value to
float; the vibrato phase's prefix sum is ``core/dsp.cumsum_base16``, the
association of ``jnp.cumsum`` on XLA's CPU backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dsp import affine_scan_1d, cumsum_base16, recip
from ..core.ugen import AudioCtx, UGen
from ..kernels.bank_common import i32_of, u32_of
from ..primitives.params import pfloat
from ..ugens.delay import advance_ring, delay_history
from ..ugens.noise import M32, next_randomness_seed

# the line lengths at 44.1 kHz (galactic.rs), scaled to the sample rate
GALACTIC_DELAY_TIMES = np.array(
    [6480, 3660, 1720, 680, 9700, 6000, 2320, 940, 15220, 8460, 4540, 3200], dtype=np.int64)
VIB_LEN = 256


def xorshift(x):
    """The 13/17/5 xorshift of u32 values (int64 in [0, 2^32))."""
    x = x ^ ((x << 13) & M32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & M32)


class Galactic(UGen):
    """Stereo 'galactic' reverb (galactic.rs:15-400).

    Params (galactic.rs order): replace, detune, brightness, bigness, wet,
    all 0..1."""

    inputs = 2
    outputs = 2
    params = (
        pfloat("replace", 0.5),
        pfloat("detune", 0.5),
        pfloat("brightness", 0.5),
        pfloat("bigness", 1.0),
        pfloat("wet", 1.0),
    )

    def __init__(self, replace=0.5, detune=0.5, brightness=0.5, bigness=1.0, wet=1.0,
                 seed: int | None = None, blockwise: bool = True):
        self.pdefaults = {"replace": float(replace), "detune": float(detune),
                          "brightness": float(brightness), "bigness": float(bigness),
                          "wet": float(wet)}
        self.seed = next_randomness_seed() if seed is None else int(seed)
        self.blockwise = bool(blockwise)
        # the blockwise path reads the previous block's lines: its result
        # depends on the block length
        self.block_invariant = not self.blockwise

    def _geometry(self, sample_rate):
        base = np.maximum(((GALACTIC_DELAY_TIMES / 44100.0) * sample_rate).astype(np.int64), 1)
        return base, int(base.max())

    def init(self, ctx: AudioCtx, device="cpu"):
        base, lmax = self._geometry(ctx.sample_rate)
        if self.blockwise:
            # superblocks up to the shortest line (below it the >= block
            # clamp would coarsen); the vectorised vibrato chain takes at
            # most 4096 samples
            self.superblock_cap = int(min(base.min(), 4096))
        rng = np.random.default_rng(self.seed)
        fpd = [int(np.uint32(rng.integers(16386, 2**32 - 1))) for _ in range(2)]

        def zeros(*shape, dtype=ctx.dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            "dbuf": zeros(2, 12, lmax),  # [channel, line, Lmax]
            "dpos": zeros(2, 12, dtype=torch.int32),
            "vib_buf": zeros(2, VIB_LEN),
            "vib_pos": zeros(2, dtype=torch.int32),
            "feedback": zeros(2, 4),
            "iir_a": zeros(2),
            "iir_b": zeros(2),
            "fpd": i32_of(torch.tensor(fpd, device=device)),
            "vib_m": zeros(),
            "oldfpd": torch.full((), 429496.7295, dtype=ctx.dtype, device=device),
        }

    def process(self, ctx: AudioCtx, state, inputs, params):
        base, _ = self._geometry(ctx.sample_rate)
        if self.blockwise and int(base.min()) >= ctx.block_size:
            return self._process_blockwise(ctx, state, inputs, params)
        return self._process_scan(ctx, state, inputs, params)

    # ------------------------------------------------------------------
    def _rates(self, ctx, params):
        """The block's derived parameter rows (galactic.rs:176-190)."""
        regen = 0.0625 + (1.0 - params["replace"]) * 0.0625
        attenuate = (1.0 - regen / 0.125) * 1.333
        bright = 1.00001 - (1.0 - params["brightness"])
        lowpass = (bright * bright) * recip(float(np.sqrt(ctx.sample_rate / 44100.0)), bright)
        det = params["detune"]
        drift = det * det * det * 0.001
        wet_in = 1.0 - params["wet"]
        wet = 1.0 - wet_in * wet_in * wet_in
        return regen, attenuate, lowpass, drift, wet

    _XS_COLS: dict = {}

    @classmethod
    def _xorshift_columns(cls, n: int) -> np.ndarray:
        """``cols[t, j] = xorshift^t(1 << j)`` for t in [0, n]: the xorshift
        is linear over GF(2), so the sequence from any seed is the XOR of
        the columns of its set bits."""
        cols = cls._XS_COLS.get(n)
        if cols is None:
            cols = np.empty((n + 1, 32), np.uint64)
            v = np.uint64(1) << np.arange(32, dtype=np.uint64)
            m32 = np.uint64(M32)
            for t in range(n + 1):
                cols[t] = v
                v = (v ^ (v << np.uint64(13))) & m32
                v = v ^ (v >> np.uint64(17))
                v = (v ^ (v << np.uint64(5))) & m32
            cls._XS_COLS[n] = cols = cols.astype(np.int64)
        return cols

    @staticmethod
    def _reset_rate(fpd0, dtype):
        return 0.4294967295 + fpd0.to(dtype) * 0.0000000000618

    @staticmethod
    def _offsets(vm):
        """The vibrato read offsets of both channels, ``[..., 2]``."""
        return torch.stack([(torch.sin(vm) + 1.0) * 127.0,
                            (torch.sin(vm + np.pi / 2.0) + 1.0) * 127.0], dim=-1)

    def _vib_fpd_vectorized(self, ctx, state, drift):
        """The vibrato phase and xorshift dither chain of one block, whole:
        the xorshift sequence as a GF(2) product, the phase as a prefix sum
        with at most one 2 pi reset (the fastest drift needs over 9000
        samples a cycle). Returns (offsets [B, 2], tiny [B, 2], dither fpd
        [B, 2], vib_m, oldfpd, fpd [2])."""
        dtype, B = ctx.dtype, drift.shape[0]
        dev = drift.device
        cols = self._on_device(("xorshift", B), lambda: self._xorshift_columns(B),
                               dev)  # [B+1, 32]
        x0 = u32_of(state["fpd"])  # [2]
        bits = (x0.unsqueeze(-1) >> torch.arange(32, device=dev)) & 1
        v = cols.unsqueeze(0) & (-bits).unsqueeze(1) & M32  # [2, B+1, 32]
        for s in (16, 8, 4, 2, 1):
            v = v[..., :s] ^ v[..., s:2 * s]
        seq = v[..., 0]
        pre, fpd_seq, fpd_out = seq[:, :B], seq[:, 1:], seq[:, B]
        tiny = pre.t().to(dtype) * 1.18e-17

        csum = cumsum_base16(drift)
        vm_naive = state["vib_m"] + state["oldfpd"] * csum
        crossed = vm_naive > float(np.float32(2.0 * np.pi) if dtype == torch.float32
                                   else 2.0 * np.pi)
        has = crossed.any()
        k = torch.argmax(crossed.to(torch.int8))
        oldfpd_new = self._reset_rate(pre[0, k], dtype)
        t = torch.arange(B, device=dev)
        vm = torch.where(has & (t > k), oldfpd_new * (csum - csum[k]), vm_naive)
        vm = torch.where(has & (t == k), torch.zeros((), dtype=dtype, device=dev), vm)
        oldfpd = torch.where(has, oldfpd_new, state["oldfpd"])
        return self._offsets(vm), tiny, fpd_seq.t(), vm[B - 1], oldfpd, fpd_out

    def _vib_fpd_scan(self, ctx, state, drift):
        """The same chain sample by sample (the per-sample reference)."""
        dtype = ctx.dtype
        two_pi = float(np.float32(2.0 * np.pi)) if dtype == torch.float32 else 2.0 * np.pi
        vib_m, oldfpd, fpd = state["vib_m"], state["oldfpd"], u32_of(state["fpd"])
        offs, tinys, fpds = [], [], []
        for t in range(drift.shape[0]):
            tinys.append(fpd.to(dtype) * 1.18e-17)
            vib_m = vib_m + oldfpd * drift[t]
            reset = vib_m > two_pi
            oldfpd = torch.where(reset, self._reset_rate(fpd[0], dtype), oldfpd)
            vib_m = torch.where(reset, torch.zeros_like(vib_m), vib_m)
            offs.append(self._offsets(vib_m))
            fpd = xorshift(fpd)
            fpds.append(fpd)
        return (torch.stack(offs), torch.stack(tinys), torch.stack(fpds), vib_m, oldfpd,
                fpd)

    @staticmethod
    def _dither(sig, fpd, dtype):
        """The airwindows floating-point dither of ``sig`` from the advanced
        fpd values (u32 as int64, converted to f32 as the reference does)."""
        _m, e = torch.frexp(sig)
        e = e.clamp(0, 64).to(dtype)
        f32 = torch.float32
        return sig + (((fpd.to(f32) - float(np.float32(0x7FFFFFFF))) * 5.5e-36)
                      * torch.exp2(e + 62.0)).to(dtype)

    @staticmethod
    def _mix4(x):
        """2 b[i] - (b0 + b1 + b2 + b3) over the line axis 1."""
        total = x[:, 0] + x[:, 1] + x[:, 2] + x[:, 3]
        return 2.0 * x - total.unsqueeze(1)

    _DEV_CONSTS: dict = {}

    @classmethod
    def _on_device(cls, key, make, dev, dtype=None):
        """A host array made by ``make()`` as a tensor on ``dev`` (of
        ``dtype``), copied there once per (key, device, dtype)."""
        k = (key, torch.device(dev), dtype)
        if k not in cls._DEV_CONSTS:
            cls._DEV_CONSTS[k] = torch.from_numpy(make()).to(dev, dtype)
        return cls._DEV_CONSTS[k]

    def _process_blockwise(self, ctx, state, inputs, params):
        dtype, B = ctx.dtype, ctx.block_size
        dev = inputs.device
        base, lmax = self._geometry(ctx.sample_rate)
        regen, attenuate, lowpass, drift, wet = self._rates(ctx, params)
        size = params["bigness"][0] * 0.9 + 0.1  # block rate on this path
        # clamp to B + 1: every read lands strictly before this block's writes
        base_dev = self._on_device(("base", ctx.sample_rate), lambda: base, dev, dtype)
        eff = (base_dev * size).to(torch.int32).clamp(B + 1, lmax)
        eff = eff.long()  # [12]

        vib_chain = self._vib_fpd_vectorized if B <= 4096 else self._vib_fpd_scan
        off, tiny, fpd_seq, vib_m, oldfpd, fpd = vib_chain(ctx, state, drift)

        # the rest of the block: one launch of csrc/galactic.cu on the card,
        # its plain torch version (blockwise_rest) on the CPU
        from ..kernels.galactic import galactic_block

        rest, sig = galactic_block(state, inputs, attenuate, lowpass, regen, wet, off, tiny,
                                   fpd_seq, eff)
        return {**rest, "fpd": i32_of(fpd), "vib_m": vib_m, "oldfpd": oldfpd}, sig

    def _process_scan(self, ctx, state, inputs, params):
        dtype, B = ctx.dtype, ctx.block_size
        dev = inputs.device
        base, lmax = self._geometry(ctx.sample_rate)
        regen, attenuate, lowpass, drift, wet = self._rates(ctx, params)
        size = params["bigness"] * 0.9 + 0.1
        eff_lens = (torch.from_numpy(base).to(dev, dtype).unsqueeze(0) * size.unsqueeze(1)
                    ).to(torch.int32).clamp(1, lmax).long()  # [B, 12]
        two_pi = float(np.float32(2.0 * np.pi)) if dtype == torch.float32 else 2.0 * np.pi
        ch = torch.arange(2, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)

        dbuf, dpos = state["dbuf"].clone(), state["dpos"].long().clone()
        vib_buf, vib_pos = state["vib_buf"].clone(), state["vib_pos"].long()
        feedback, iir_a, iir_b = state["feedback"], state["iir_a"], state["iir_b"]
        fpd, vib_m, oldfpd = u32_of(state["fpd"]), state["vib_m"], state["oldfpd"]

        def bank(first, eff, values):
            """Write ``values`` [2, 4] into lines first..first+3, then read
            each line one step on."""
            rows = torch.arange(first, first + 4, device=dev)
            pos = dpos[:, rows]
            dbuf[ch[:, None], rows[None, :], pos] = values
            new_pos = (pos + 1) % eff[rows]
            dpos[:, rows] = new_pos
            return dbuf[ch[:, None], rows[None, :], new_pos]

        outs = []
        for t in range(B):
            lp = lowpass[t]
            inp = inputs[:, t]
            inp = torch.where(inp.abs() < 1.18e-23, fpd.to(dtype) * 1.18e-17, inp)
            dry = inp
            vib_m = vib_m + oldfpd * drift[t]
            reset = vib_m > two_pi
            oldfpd = torch.where(reset, self._reset_rate(fpd[0], dtype), oldfpd)
            vib_m = torch.where(reset, zero, vib_m)
            # the detune delay: write, then read at the drifting offset
            vib_buf[ch, vib_pos] = inp * attenuate[t]
            vib_pos = (vib_pos + 1) % VIB_LEN
            working = vib_pos.to(dtype) + self._offsets(vib_m)
            fl = torch.floor(working)
            low = fl.long() % VIB_LEN
            v_lo, v_hi = vib_buf[ch, low], vib_buf[ch, (low + 1) % VIB_LEN]
            inp = v_lo + (v_hi - v_lo) * (working - fl)
            iir_a = iir_a * (1.0 - lp) + inp * lp
            # the banks, each channel's first fed by the other's feedback
            eff = eff_lens[t]
            b0 = bank(0, eff, feedback.flip(0) * regen[t] + iir_a.unsqueeze(1))
            b1 = bank(4, eff, self._mix4(b0.unsqueeze(-1))[..., 0])
            b2 = bank(8, eff, self._mix4(b1.unsqueeze(-1))[..., 0])
            feedback = self._mix4(b2.unsqueeze(-1))[..., 0]
            inp = (b2[:, 0] + b2[:, 1] + b2[:, 2] + b2[:, 3]) * 0.125
            iir_b = iir_b * (1.0 - lp) + inp * lp
            w = wet[t]
            inp = torch.where(w < 1.0, iir_b * w + dry * (1.0 - w), iir_b)
            fpd = xorshift(fpd)
            outs.append(self._dither(inp, fpd, dtype))
        new_state = {"dbuf": dbuf, "dpos": dpos.to(torch.int32), "vib_buf": vib_buf,
                     "vib_pos": vib_pos.to(torch.int32), "feedback": feedback,
                     "iir_a": iir_a, "iir_b": iir_b, "fpd": i32_of(fpd), "vib_m": vib_m,
                     "oldfpd": oldfpd}
        return new_state, torch.stack(outs, dim=1)


def blockwise_rest(state, inputs, attenuate, lowpass, regen, wet, off, tiny, fpd_seq, eff):
    """The blockwise block after its vibrato and dither streams
    (``_vib_fpd_vectorized``): the detune delay, the pre lowpass, the three
    banks, the post lowpass, the wet/dry mix and the dither, for the
    state's ``[2, ...]`` leaves and the ``[2, B]`` input. The plain version
    of ``kernels/galactic.py``. Returns (the new dbuf, dpos, vib_buf,
    vib_pos, feedback, iir_a and iir_b; the output ``[2, B]``)."""
    dtype, B = inputs.dtype, inputs.shape[-1]
    dev = inputs.device

    # silence replaced by the dither's tiny values
    inp = torch.where(inputs.abs() < 1.18e-23, tiny.t(), inputs)
    dry = inp

    # the detune delay: the ring from its position, then this block's writes
    writes = inp * attenuate.unsqueeze(0)  # [2, B]
    hist = delay_history(state["vib_buf"], state["vib_pos"], writes)  # [2, 256 + B]
    t = torch.arange(B, device=dev)
    fl = torch.floor(off.t())  # [2, B]
    k = fl.long()
    low = torch.gather(hist, -1, t + 1 + k)
    high = torch.gather(hist, -1, t + 2 + k)
    sig = low + (high - low) * (off.t() - fl)
    vib_buf, vib_pos = advance_ring(hist, state["vib_pos"], B)

    # pre lowpass (iirA)
    a = (1.0 - lowpass).expand(2, B)
    b = sig * lowpass.unsqueeze(0)
    y_pre, iir_a = affine_scan_1d(a, b, state["iir_a"])
    sig = a * y_pre + b

    # the three banks (eff > B: no read reaches this block's writes)
    dbuf, dpos = state["dbuf"], state["dpos"].long()
    read_idx = (dpos.unsqueeze(-1) + 1 + t) % eff[:, None]  # [2, 12, B]
    reads = torch.gather(dbuf, -1, read_idx)
    b0, b1, b2 = reads[:, 0:4], reads[:, 4:8], reads[:, 8:12]
    mix4 = Galactic._mix4
    fb_now = mix4(b2)  # the feedback each sample produces [2, 4, B]
    fb_prev = torch.cat([state["feedback"].unsqueeze(-1), fb_now[..., :-1]], dim=-1)
    w0 = fb_prev.flip(0) * regen + sig.unsqueeze(1)
    writes_all = torch.cat([w0, mix4(b0), mix4(b1)], dim=1)
    write_idx = (dpos.unsqueeze(-1) + t) % eff[:, None]
    dbuf = dbuf.scatter(-1, write_idx, writes_all)
    dpos = ((dpos + B) % eff).to(torch.int32)
    sig = (b2[:, 0] + b2[:, 1] + b2[:, 2] + b2[:, 3]) * 0.125

    # post lowpass (iirB)
    b6 = sig * lowpass.unsqueeze(0)
    y_pre, iir_b = affine_scan_1d(a, b6, state["iir_b"])
    sig = a * y_pre + b6

    sig = torch.where(wet < 1.0, sig * wet + dry * (1.0 - wet), sig)
    sig = Galactic._dither(sig, fpd_seq.t(), dtype)
    rest = {"dbuf": dbuf, "dpos": dpos, "vib_buf": vib_buf, "vib_pos": vib_pos,
            "feedback": fb_now[..., B - 1], "iir_a": iir_a, "iir_b": iir_b}
    return rest, sig
