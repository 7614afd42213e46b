"""Port of knaster_tpu/utils/codec.py: compressed sound-file IO.

The reference reads wav/ogg/flac/mp3 through symphonia
(knaster_core_dsp/src/dsp/buffer.rs:154 Buffer::from_sound_file). The
system's canonical C codec libraries are bound straight to their stable C
ABIs with ctypes: libmpg123 (mp3 decode), libvorbisfile (ogg/vorbis
decode), libmp3lame (mp3 encode) and libvorbis/enc/ogg (ogg encode). A
codec whose library is missing raises by name. FLAC goes through the
repository's own C++ codec, ``native/knaster_flac.cpp`` (full-spec decode,
a fixed/LPC-predictor lossless encoder), used as it is: built with the
host's C++ compiler at first use into ``build/knaster_tpu_torch/`` beside
the CUDA kernels, under a name that hashes the source and the flags.

All decoders return ``(data [channels, frames] float32 in ±1, sample_rate)``
— the same planar layout as ``wav.read_wav``. numpy only: the module is a
copy of the JAX package's, apart from where the FLAC library is built.
"""

from __future__ import annotations

import ctypes as C
import ctypes.util
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _load(*names) -> Optional[C.CDLL]:
    for n in names:
        try:
            return C.CDLL(n)
        except OSError:
            continue
    found = ctypes.util.find_library(names[0].split(".")[0].replace("lib", ""))
    if found:
        try:
            return C.CDLL(found)
        except OSError:
            pass
    return None


# --------------------------------------------------------------------------
# mp3 decode: libmpg123 (fully opaque handle API)
# --------------------------------------------------------------------------
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200

_mpg123 = None


def _get_mpg123():
    global _mpg123
    if _mpg123 is None:
        lib = _load("libmpg123.so.0", "libmpg123.so")
        if lib is None:
            raise RuntimeError("libmpg123 not available: mp3 decode needs it")
        lib.mpg123_init()
        lib.mpg123_new.restype = C.c_void_p
        lib.mpg123_new.argtypes = [C.c_char_p, C.POINTER(C.c_int)]
        lib.mpg123_open.argtypes = [C.c_void_p, C.c_char_p]
        lib.mpg123_getformat.argtypes = [
            C.c_void_p, C.POINTER(C.c_long), C.POINTER(C.c_int),
            C.POINTER(C.c_int),
        ]
        lib.mpg123_format_none.argtypes = [C.c_void_p]
        lib.mpg123_format.argtypes = [C.c_void_p, C.c_long, C.c_int, C.c_int]
        lib.mpg123_read.argtypes = [
            C.c_void_p, C.c_void_p, C.c_size_t, C.POINTER(C.c_size_t),
        ]
        lib.mpg123_close.argtypes = [C.c_void_p]
        lib.mpg123_delete.argtypes = [C.c_void_p]
        _mpg123 = lib
    return _mpg123


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    lib = _get_mpg123()
    err = C.c_int(0)
    h = lib.mpg123_new(None, C.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"cannot open mp3 file {path!r}")
        rate, ch, enc = C.c_long(0), C.c_int(0), C.c_int(0)
        lib.mpg123_getformat(h, C.byref(rate), C.byref(ch), C.byref(enc))
        # the output format table is locked once a track is open: probe the
        # native rate/channels, then re-open with ONLY float32 registered
        lib.mpg123_close(h)
        lib.mpg123_format_none(h)
        if lib.mpg123_format(
            h, rate.value, ch.value, _MPG123_ENC_FLOAT_32
        ) != _MPG123_OK:
            raise RuntimeError("mpg123 refused float32 output")
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"cannot reopen mp3 file {path!r}")
        chunks = []
        buf = (C.c_char * 65536)()
        done = C.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), C.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, C.byref(rate), C.byref(ch), C.byref(enc))
                continue
            if rc != _MPG123_OK:
                raise RuntimeError(f"mpg123_read error {rc} in {path!r}")
        interleaved = np.frombuffer(b"".join(chunks), dtype=np.float32)
        n_ch = max(ch.value, 1)
        frames = len(interleaved) // n_ch
        data = interleaved[: frames * n_ch].reshape(frames, n_ch).T.copy()
        return data, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# --------------------------------------------------------------------------
# ogg/vorbis decode: libvorbisfile
# --------------------------------------------------------------------------
class _VorbisInfo(C.Structure):
    _fields_ = [
        ("version", C.c_int),
        ("channels", C.c_int),
        ("rate", C.c_long),
        ("bitrate_upper", C.c_long),
        ("bitrate_nominal", C.c_long),
        ("bitrate_lower", C.c_long),
        ("bitrate_window", C.c_long),
        ("codec_setup", C.c_void_p),
    ]


_vorbisfile = None


def _get_vorbisfile():
    global _vorbisfile
    if _vorbisfile is None:
        lib = _load("libvorbisfile.so.3", "libvorbisfile.so")
        if lib is None:
            raise RuntimeError("libvorbisfile not available: ogg decode needs it")
        lib.ov_fopen.argtypes = [C.c_char_p, C.c_void_p]
        lib.ov_info.restype = C.POINTER(_VorbisInfo)
        lib.ov_info.argtypes = [C.c_void_p, C.c_int]
        lib.ov_pcm_total.restype = C.c_int64
        lib.ov_pcm_total.argtypes = [C.c_void_p, C.c_int]
        lib.ov_read_float.argtypes = [
            C.c_void_p,
            C.POINTER(C.POINTER(C.POINTER(C.c_float))),
            C.c_int,
            C.POINTER(C.c_int),
        ]
        lib.ov_clear.argtypes = [C.c_void_p]
        _vorbisfile = lib
    return _vorbisfile


def read_ogg(path: str) -> Tuple[np.ndarray, int]:
    lib = _get_vorbisfile()
    vf = C.create_string_buffer(2048)  # OggVorbis_File is ~720 B on x86-64
    if lib.ov_fopen(path.encode(), vf) != 0:
        raise RuntimeError(f"cannot open ogg file {path!r}")
    try:
        vi = lib.ov_info(vf, -1).contents
        n_ch, rate = int(vi.channels), int(vi.rate)
        out = []
        pcm = C.POINTER(C.POINTER(C.c_float))()
        section = C.c_int(0)
        while True:
            n = lib.ov_read_float(vf, C.byref(pcm), 4096, C.byref(section))
            if n == 0:
                break
            if n < 0:  # hole/bad link: symphonia-style skip
                continue
            frame = np.empty((n_ch, n), np.float32)
            for c in range(n_ch):
                frame[c] = np.ctypeslib.as_array(pcm[c], shape=(n,))
            out.append(frame)
        data = (
            np.concatenate(out, axis=1)
            if out
            else np.zeros((n_ch, 0), np.float32)
        )
        return data, rate
    finally:
        lib.ov_clear(vf)


# --------------------------------------------------------------------------
# mp3 encode: libmp3lame (for tests and exports)
# --------------------------------------------------------------------------
_lame = None


def _get_lame():
    global _lame
    if _lame is None:
        lib = _load("libmp3lame.so.0", "libmp3lame.so")
        if lib is None:
            raise RuntimeError("libmp3lame not available: mp3 encode needs it")
        lib.lame_init.restype = C.c_void_p
        for fn in ("lame_set_num_channels", "lame_set_in_samplerate",
                   "lame_set_brate", "lame_set_quality"):
            getattr(lib, fn).argtypes = [C.c_void_p, C.c_int]
        lib.lame_init_params.argtypes = [C.c_void_p]
        lib.lame_encode_buffer_ieee_float.argtypes = [
            C.c_void_p, C.POINTER(C.c_float), C.POINTER(C.c_float),
            C.c_int, C.c_void_p, C.c_int,
        ]
        lib.lame_encode_flush.argtypes = [C.c_void_p, C.c_void_p, C.c_int]
        lib.lame_close.argtypes = [C.c_void_p]
        _lame = lib
    return _lame


def write_mp3(path: str, data: np.ndarray, sample_rate: int,
              bitrate_kbps: int = 192) -> None:
    """Encode ``data [channels, frames]`` (float32 ±1) to MP3."""
    lib = _get_lame()
    data = np.atleast_2d(np.asarray(data, np.float32))
    n_ch, frames = data.shape
    if n_ch > 2:
        raise ValueError("mp3 supports at most 2 channels")
    gfp = lib.lame_init()
    try:
        lib.lame_set_num_channels(gfp, n_ch)
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_quality(gfp, 2)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")
        left = np.ascontiguousarray(data[0])
        right = np.ascontiguousarray(data[1] if n_ch == 2 else data[0])
        out = (C.c_char * (frames + 7200 + frames // 2))()
        lp = left.ctypes.data_as(C.POINTER(C.c_float))
        rp = right.ctypes.data_as(C.POINTER(C.c_float))
        n = lib.lame_encode_buffer_ieee_float(gfp, lp, rp, frames, out, len(out))
        if n < 0:
            raise RuntimeError(f"lame encode error {n}")
        with open(path, "wb") as f:
            f.write(bytes(out[:n]))
            n = lib.lame_encode_flush(gfp, out, len(out))
            f.write(bytes(out[:n]))
    finally:
        lib.lame_close(gfp)


# --------------------------------------------------------------------------
# ogg/vorbis encode: libvorbisenc + libogg (encoder_example.c flow)
# --------------------------------------------------------------------------
class _OggPage(C.Structure):
    _fields_ = [
        ("header", C.POINTER(C.c_ubyte)),
        ("header_len", C.c_long),
        ("body", C.POINTER(C.c_ubyte)),
        ("body_len", C.c_long),
    ]


def write_ogg(path: str, data: np.ndarray, sample_rate: int,
              quality: float = 0.6) -> None:
    """Encode ``data [channels, frames]`` (float32 ±1) to Ogg Vorbis."""
    vorbis = _load("libvorbis.so.0", "libvorbis.so")
    venc = _load("libvorbisenc.so.2", "libvorbisenc.so")
    ogg = _load("libogg.so.0", "libogg.so")
    if not (vorbis and venc and ogg):
        raise RuntimeError("vorbis/ogg encoder libraries not available")
    data = np.atleast_2d(np.asarray(data, np.float32))
    n_ch, frames = data.shape

    vorbis.vorbis_analysis_buffer.restype = C.POINTER(C.POINTER(C.c_float))
    venc.vorbis_encode_init_vbr.argtypes = [
        C.c_void_p, C.c_long, C.c_long, C.c_float,
    ]

    # opaque structs: generously sized caller-allocated buffers
    vi = C.create_string_buffer(256)
    vc = C.create_string_buffer(256)
    vd = C.create_string_buffer(4096)
    vb = C.create_string_buffer(4096)
    os_ = C.create_string_buffer(1024)
    op = C.create_string_buffer(128)
    h1, h2, h3 = (C.create_string_buffer(128) for _ in range(3))
    og = _OggPage()

    vorbis.vorbis_info_init(vi)
    try:
        if venc.vorbis_encode_init_vbr(vi, n_ch, sample_rate,
                                       C.c_float(quality)) != 0:
            raise RuntimeError("vorbis_encode_init_vbr failed")
        vorbis.vorbis_comment_init(vc)
        vorbis.vorbis_analysis_init(vd, vi)
        vorbis.vorbis_block_init(vd, vb)
        ogg.ogg_stream_init(os_, 1)
        vorbis.vorbis_analysis_headerout(vd, vc, h1, h2, h3)
        for h in (h1, h2, h3):
            ogg.ogg_stream_packetin(os_, h)

        def pages(f, flush):
            fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
            while fn(os_, C.byref(og)) != 0:
                f.write(C.string_at(og.header, og.header_len))
                f.write(C.string_at(og.body, og.body_len))

        with open(path, "wb") as f:
            pages(f, flush=True)
            CHUNK = 4096
            pos = 0
            while pos <= frames:
                n = min(CHUNK, frames - pos)
                if n > 0:
                    buf = vorbis.vorbis_analysis_buffer(vd, CHUNK)
                    for c in range(n_ch):
                        C.memmove(
                            buf[c],
                            np.ascontiguousarray(
                                data[c, pos : pos + n]
                            ).ctypes.data,
                            n * 4,
                        )
                vorbis.vorbis_analysis_wrote(vd, n)  # n == 0 marks EOS
                while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                    vorbis.vorbis_analysis(vb, None)
                    vorbis.vorbis_bitrate_addblock(vb)
                    while vorbis.vorbis_bitrate_flushpacket(vd, op) == 1:
                        ogg.ogg_stream_packetin(os_, op)
                        pages(f, flush=False)
                if n == 0:
                    break
                pos += n
            pages(f, flush=True)
    finally:
        ogg.ogg_stream_clear(os_)
        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        vorbis.vorbis_info_clear(vi)


# --------------------------------------------------------------------------
# flac: the repository's native codec (native/knaster_flac.cpp, built on demand)
# --------------------------------------------------------------------------
_flac = None
_flac_lock = threading.Lock()
FLAC_SOURCE = Path(__file__).resolve().parents[2] / "native" / "knaster_flac.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def flac_library_path() -> Path:
    """Where the FLAC library of this source and these flags is built."""
    from ..kernels.build import BUILD_DIR

    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(FLAC_SOURCE.read_bytes())
    return BUILD_DIR / f"libknaster_flac_{h.hexdigest()[:16]}.so"


def build_flac() -> Path:
    """Compile ``native/knaster_flac.cpp`` if its library is missing ($CXX,
    else c++ or g++, else nvcc driving its own host compiler); raises with
    the compiler's output if it fails."""
    so = flac_library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is not None:
        cmd = [cxx, *CXX_FLAGS]
    else:
        from ..kernels.build import nvcc_path

        cmd = [nvcc_path(), *(f for f in CXX_FLAGS if f != "-fPIC"), "-Xcompiler", "-fPIC"]
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(FLAC_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("failed to build native/knaster_flac.cpp:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _get_flac():
    global _flac
    with _flac_lock:
        if _flac is None:
            lib = C.CDLL(str(build_flac()))
            lib.kn_flac_open.restype = C.c_void_p
            lib.kn_flac_open.argtypes = [C.c_char_p, C.c_size_t]
            for fn in ("kn_flac_channels", "kn_flac_rate", "kn_flac_bits"):
                getattr(lib, fn).restype = C.c_int
                getattr(lib, fn).argtypes = [C.c_void_p]
            lib.kn_flac_frames.restype = C.c_longlong
            lib.kn_flac_frames.argtypes = [C.c_void_p]
            lib.kn_flac_read.argtypes = [C.c_void_p, C.POINTER(C.c_int32)]
            lib.kn_flac_close.argtypes = [C.c_void_p]
            lib.kn_flac_encode.restype = C.POINTER(C.c_uint8)
            lib.kn_flac_encode.argtypes = [
                C.POINTER(C.c_int32), C.c_longlong, C.c_int, C.c_int, C.c_int,
                C.POINTER(C.c_size_t),
            ]
            lib.kn_flac_free_buf.argtypes = [C.POINTER(C.c_uint8)]
            _flac = lib
    return _flac


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file with the native codec. Lossless: int samples are
    scaled by 2^(bits-1) into float32 ±1 exactly like read_wav's int paths."""
    lib = _get_flac()
    with open(path, "rb") as f:
        raw = f.read()
    h = lib.kn_flac_open(raw, len(raw))
    if not h:
        raise RuntimeError(f"cannot decode FLAC file {path!r}")
    try:
        n_ch = lib.kn_flac_channels(h)
        rate = lib.kn_flac_rate(h)
        bits = lib.kn_flac_bits(h)
        frames = lib.kn_flac_frames(h)
        data = np.zeros((n_ch, frames), np.int32)
        if frames:
            lib.kn_flac_read(h, data.ctypes.data_as(C.POINTER(C.c_int32)))
        return data.astype(np.float32) / np.float32(2 ** (bits - 1)), rate
    finally:
        lib.kn_flac_close(h)


def write_flac(path: str, data: np.ndarray, sample_rate: int,
               bits: int = 16) -> None:
    """Encode ``data [channels, frames]`` (float32 ±1) to FLAC (lossless at
    the chosen bit depth; 16 or 24)."""
    if bits not in (8, 16, 24):
        raise ValueError("write_flac supports 8/16/24-bit depths")
    lib = _get_flac()
    data = np.atleast_2d(np.asarray(data, np.float32))
    n_ch, frames = data.shape
    if n_ch > 8:
        raise ValueError("flac supports at most 8 channels")
    scale = float(2 ** (bits - 1))
    quant = np.clip(np.rint(data * scale), -scale, scale - 1).astype(np.int32)
    interleaved = np.ascontiguousarray(quant.T)  # [frames, ch]
    out_len = C.c_size_t(0)
    p = lib.kn_flac_encode(
        interleaved.ctypes.data_as(C.POINTER(C.c_int32)),
        frames, n_ch, int(sample_rate), bits, C.byref(out_len),
    )
    if not p:
        raise RuntimeError("flac encode failed")
    try:
        with open(path, "wb") as f:
            f.write(C.string_at(p, out_len.value))
    finally:
        lib.kn_flac_free_buf(p)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------
def read_sound_file(path: str) -> Tuple[np.ndarray, int]:
    """Read wav/ogg/flac/mp3 into ``([channels, frames] float32,
    sample_rate)`` (Buffer::from_sound_file parity, dsp/buffer.rs:154).
    Dispatch is by magic bytes with the extension as fallback."""
    with open(path, "rb") as f:
        magic = f.read(4)
    ext = os.path.splitext(path)[1].lower()
    if magic[:4] == b"RIFF" or ext == ".wav":
        from .wav import read_wav

        return read_wav(path)
    if magic[:4] == b"OggS" or ext in (".ogg", ".oga"):
        return read_ogg(path)
    if magic[:4] == b"fLaC" or ext == ".flac":
        return read_flac(path)
    if magic[:3] == b"ID3" or (len(magic) >= 2 and magic[0] == 0xFF
                               and (magic[1] & 0xE0) == 0xE0) or ext == ".mp3":
        return read_mp3(path)
    raise ValueError(f"unrecognized sound file format: {path!r}")
