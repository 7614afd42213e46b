"""Port of knaster_tpu/utils/wav.py: WAV file IO with no external dependencies.

A copy of the JAX package's module (numpy only), kept here so that the
port imports nothing of that package.

The reference loads sound files via symphonia and writes via hound
(knaster_core_dsp/src/dsp/buffer.rs:154,317). This module reads and writes
RIFF/WAVE directly: PCM 8/16/24/32-bit and IEEE float32/float64, mono or
multichannel. Other formats raise with a clear message (the compressed
ones go through ``codec.py``).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (data [channels, frames] float32 in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize)
            if csize % 2:
                f.read(1)  # chunks are word-aligned
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        (tag, channels, sample_rate, _brate, _balign, bits) = struct.unpack(
            "<HHIIHH", fmt[:16]
        )
        if tag == WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 40:
            tag = struct.unpack("<H", fmt[24:26])[0]
        if tag == WAVE_FORMAT_PCM:
            if bits == 16:
                x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
            elif bits == 24:
                raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
                x = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                x = (x << 8 >> 8).astype(np.float32) / 8388608.0
            elif bits == 32:
                x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
            elif bits == 8:
                x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"unsupported PCM bit depth {bits}")
        elif tag == WAVE_FORMAT_IEEE_FLOAT:
            if bits == 32:
                dt = "<f4"
            elif bits == 64:
                dt = "<f8"
            else:
                raise ValueError(f"unsupported IEEE-float bit depth {bits}")
            x = np.frombuffer(data, dtype=dt).astype(np.float32)
        else:
            raise ValueError(
                f"unsupported WAV format tag {tag}; only PCM and IEEE float "
                f"are supported (compressed formats: utils/codec.py)"
            )
        frames = len(x) // channels
        return x[: frames * channels].reshape(frames, channels).T.copy(), sample_rate


def write_wav(path: str, data: np.ndarray, sample_rate: int, subtype: str = "float32"):
    """Write [channels, frames] (or [frames]) audio to a WAV file.

    subtype: 'float32' (default, lossless for our renders) or 'pcm16'/'pcm24'.
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    channels, frames = data.shape
    interleaved = data.T.reshape(-1)
    if subtype == "float32":
        payload = interleaved.astype("<f4").tobytes()
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
    elif subtype == "pcm16":
        clipped = np.clip(interleaved, -1.0, 1.0)
        payload = (clipped * 32767.0).astype("<i2").tobytes()
        tag, bits = WAVE_FORMAT_PCM, 16
    elif subtype == "pcm24":
        clipped = np.clip(interleaved, -1.0, 1.0)
        ints = (clipped * 8388607.0).astype(np.int32)
        raw = np.zeros((len(ints), 3), dtype=np.uint8)
        raw[:, 0] = ints & 0xFF
        raw[:, 1] = (ints >> 8) & 0xFF
        raw[:, 2] = (ints >> 16) & 0xFF
        payload = raw.tobytes()
        tag, bits = WAVE_FORMAT_PCM, 24
    else:
        raise ValueError(f"unknown subtype {subtype!r}")
    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(
            struct.pack(
                "<4sIHHIIHH", b"fmt ", 16, tag, channels, sample_rate, byte_rate,
                block_align, bits,
            )
        )
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)
        if len(payload) % 2:
            f.write(b"\x00")
