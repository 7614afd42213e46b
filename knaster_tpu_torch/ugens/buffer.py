"""Port of knaster_tpu/ugens/buffer.py: sample buffers and buffer playback
(reference dsp/buffer.rs + ugens/buffer.rs).

``Buffer`` keeps its samples in host numpy, as in the JAX package; the
UGens that read it take a device copy for their context's device and
dtype once (``Buffer.on``), not every block. ``BufferReader``'s pointer
recurrence has ``floor`` and ``where`` in it and no affine scan form, so it
runs sample by sample over the block, as the JAX package's ``lax.scan``
does: on the card in one launch a block (``kernels/buffer_reader.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen
from ..primitives.params import pbool, pfloat, ptrigger
from ..primitives.time import Seconds


class Buffer:
    """Multichannel sample storage (dsp/buffer.rs:38-332 Buffer): host numpy
    ``[channels, frames]`` f32."""

    def __init__(self, data: np.ndarray, sample_rate: int):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data[None, :]
        self.data = data
        self.sample_rate = int(sample_rate)
        self._on = {}

    @property
    def channels(self) -> int:
        return self.data.shape[0]

    @property
    def frames(self) -> int:
        return self.data.shape[1]

    def length_seconds(self) -> float:
        return self.frames / self.sample_rate

    def buf_rate_scale(self, server_sample_rate: int) -> float:
        """Playback step per output sample at rate 1.0: buffer_sr /
        server_sr, so the buffer plays at its natural speed."""
        return self.sample_rate / float(server_sample_rate)

    def on(self, device, dtype) -> torch.Tensor:
        """The samples as a ``[channels, frames]`` tensor of ``dtype`` on
        ``device``, copied there once and kept."""
        key = (torch.device(device), dtype)
        if key not in self._on:
            self._on[key] = torch.from_numpy(self.data).to(device=device, dtype=dtype)
        return self._on[key]

    def remove_dc(self) -> None:
        self.data = self.data - self.data.mean(axis=1, keepdims=True)
        self._on = {}

    @staticmethod
    def from_sound_file(path: str) -> "Buffer":
        """Load wav/ogg/flac/mp3 (dsp/buffer.rs:154 from_sound_file) through
        ``utils/codec.py``."""
        from ..utils.codec import read_sound_file

        data, sr = read_sound_file(path)
        return Buffer(data, sr)

    def save_to_disk(self, path: str, subtype: str = "float32") -> None:
        from ..utils.wav import write_wav

        write_wav(path, self.data, self.sample_rate, subtype)


def _snap(x):
    """Seconds to frames through the f32 param bus quantizes frame boundaries
    (f32(0.0005) * 48000 = 24.000002, one sample late past a 24-frame
    buffer): snap to the nearest frame inside the f32 ulp band, as the
    reference's exact f64 conversion lands (buffer.rs:110-120). Fractional
    ends sit far outside the band."""
    r = torch.round(x)
    return torch.where(torch.abs(x - r) <= 5e-7 * torch.abs(x), r, x)


class BufferReader(UGen):
    """Plays a Buffer with variable rate, looping, start/duration/end windows
    and a restart trigger; flags done at the end (ugens/buffer.rs:21-190).

    The read pointer is an int32 frame plus a fractional part, so long
    buffers keep their precision in f32 (the reference uses an f64
    pointer). Leading batch axes are taken as everywhere in the port."""

    may_set_done = True

    params = (
        pfloat("rate", 1.0),
        pbool("looping", False),
        pfloat("start_s", 0.0),
        pfloat("duration_s", -1.0),
        pfloat("end_s", -1.0),
        ptrigger("t_restart"),
    )

    def __init__(self, buffer: Buffer, rate: float = 1.0, looping: bool = False,
                 start_at: Optional[Seconds] = None):
        self.buffer = buffer
        self.inputs = 0
        self.outputs = buffer.channels
        start = start_at.to_secs_f64() if start_at is not None else 0.0
        self.pdefaults = {
            "rate": float(rate),
            "looping": bool(looping),
            "start_s": start,
            "duration_s": buffer.length_seconds() - start,
        }

    def init(self, ctx: AudioCtx, device="cpu"):
        start_frame = self.pdefaults["start_s"] * self.buffer.sample_rate
        return {
            "ptr_int": torch.tensor(int(start_frame), dtype=torch.int32, device=device),
            "ptr_frac": torch.tensor(start_frame - int(start_frame), dtype=ctx.dtype,
                                     device=device),
            "finished": torch.zeros((), dtype=torch.bool, device=device),
        }

    def process(self, ctx: AudioCtx, state, inputs, params):
        dtype = ctx.dtype
        buf = self.buffer.on(state["ptr_frac"].device, dtype)  # [ch, frames]
        n_frames = self.buffer.frames
        bsr = float(self.buffer.sample_rate)
        step = params["rate"] * self.buffer.buf_rate_scale(ctx.sample_rate)

        # the block's windows, in frames
        start = _snap(params["start_s"] * bsr)
        dur = params["duration_s"]
        end_from_dur = start + torch.where(dur < 0, torch.full_like(dur, float(n_frames)),
                                           _snap(dur * bsr))
        end_s = params["end_s"]
        end = torch.where(end_s < 0, end_from_dur, _snap(end_s * bsr))
        s_int = torch.floor(start).to(torch.int32)
        s_frac = start - s_int.to(dtype)
        looping = params["looping"] > 0
        # the walk over the block: one launch of csrc/buffer_reader.cu on
        # the card, its plain torch version (buffer_reader_block) on the CPU
        from ..kernels.buffer_reader import buffer_reader

        return buffer_reader(buf, state, s_int, s_frac, end, step, looping,
                             params["t_restart"])


def buffer_reader_block(buf, state, s_int, s_frac, end, step, looping, restart):
    """BufferReader's walk over a block in plain torch, on whatever device
    the state is on (the plain version of ``kernels/buffer_reader.py``, whose
    ``buffer_reader`` documents the arguments): the JAX package's scan body (``knaster_tpu/ugens/buffer.py:138-164``)
    sample by sample over the block (``floor`` and ``where`` leave the
    recurrence no scan form)."""
    n_frames = buf.shape[1]
    dtype = state["ptr_frac"].dtype
    pi, pf, finished = state["ptr_int"], state["ptr_frac"], state["finished"]
    outs, dones = [], []
    for t in range(restart.shape[-1]):
        r = restart[..., t]
        pi = torch.where(r, s_int[..., t], pi)
        pf = torch.where(r, s_frac[..., t], pf)
        finished = finished & ~r
        idx = pi.clamp(0, n_frames - 1).long()
        idx1 = (pi + 1).clamp(0, n_frames - 1).long()
        a, b = buf[:, idx], buf[:, idx1]  # [ch, ...]
        frame = (a + (b - a) * pf).movedim(0, -1)
        outs.append(torch.where(finished.unsqueeze(-1), torch.zeros_like(frame), frame))

        pf = pf + step[..., t]
        adv = torch.floor(pf).to(torch.int32)
        pi = pi + adv
        pf = pf - adv.to(dtype)
        hit = ((pi.to(dtype) + pf) >= end[..., t]) & ~finished
        do_loop = hit & looping[..., t]
        pi = torch.where(do_loop, s_int[..., t], pi)
        pf = torch.where(do_loop, s_frac[..., t], pf)
        done = hit & ~looping[..., t]
        finished = finished | done
        dones.append(done)
    new_state = {"ptr_int": pi, "ptr_frac": pf, "finished": finished}
    return new_state, torch.stack(outs, dim=-1), torch.stack(dones, dim=-1)
