"""The port's sound-file codecs (``knaster_tpu_torch/utils/codec.py``, ``wav.py``) against the JAX package's.

- Every golden fixture (``tests/golden/*.flac``) decodes bit-equal through
  the port's codec and the JAX package's.
- Ports of tests/test_codec.py: the mp3 and ogg round trips (through the
  system's libmp3lame/libmpg123 and libvorbis/libvorbisfile, skipped where
  they are missing, as there), lossless FLAC at 16 and 24 bits with a short
  last frame, FLAC compression over its subframe types, the bad stream, WAV
  dispatch, and a ``BufferReader`` playing a decoded FLAC and mp3 in a
  graph. The port writes byte-equal files and decodes the JAX package's
  bit-equal (the same libraries, the same native FLAC source).
- The FLAC library builds into ``build/knaster_tpu_torch/`` under a hash of
  its source; a codec whose system library is missing raises by name.
"""

import os
from pathlib import Path

import numpy as np
import pytest

import knaster_tpu_torch as kt
from knaster_tpu.utils import codec as jcodec
from knaster_tpu_torch.utils import codec

SR = 44100
GOLDEN = sorted(Path(__file__).resolve().parent.joinpath("golden").glob("*.flac"))


def _sig(frames=SR * 2):
    t = np.arange(frames) / SR
    return np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                     0.3 * np.sin(2 * np.pi * 660 * t)]).astype(np.float32)


def _freq(x):
    return np.sum((x[:-1] < 0) & (x[1:] >= 0))


def _have(loader):
    try:
        loader()
        return True
    except RuntimeError:
        return False


@pytest.mark.parametrize("path", GOLDEN, ids=[p.stem for p in GOLDEN])
def test_golden_fixture_reads_bit_equal(path):
    data, rate = codec.read_sound_file(str(path))
    ref, ref_rate = jcodec.read_sound_file(str(path))
    assert rate == ref_rate == 48000 and data.dtype == np.float32
    np.testing.assert_array_equal(data, ref)


def test_flac_builds_into_the_build_directory():
    so = codec.build_flac()
    root = Path(codec.__file__).resolve().parents[2]
    assert so.parent == root / "build" / "knaster_tpu_torch"
    assert so.name.startswith("libknaster_flac_") and so.exists()


@pytest.mark.skipif(not _have(codec._get_lame) or not _have(codec._get_mpg123),
                    reason="mp3 libraries unavailable")
def test_mp3_roundtrip(tmp_path):
    path = str(tmp_path / "t.mp3")
    codec.write_mp3(path, _sig(), SR)
    data, rate = codec.read_sound_file(path)
    assert rate == SR and data.shape[0] == 2
    mid = data[0][SR // 2: SR // 2 + SR]  # past the encoder's delay and padding
    assert abs(_freq(mid) - 440) <= 3
    assert abs(float(np.sqrt((mid ** 2).mean())) - 0.5 / np.sqrt(2)) < 0.02
    buf = kt.Buffer.from_sound_file(path)
    assert buf.sample_rate == SR and buf.channels == 2
    ref, _ = jcodec.read_sound_file(path)
    np.testing.assert_array_equal(data, ref)


@pytest.mark.skipif(not _have(codec._get_vorbisfile), reason="vorbis libraries unavailable")
def test_ogg_roundtrip(tmp_path):
    path = str(tmp_path / "t.ogg")
    sig = _sig()
    codec.write_ogg(path, sig, SR)
    data, rate = codec.read_sound_file(path)
    assert rate == SR and data.shape[0] == 2
    n = min(data.shape[1], sig.shape[1])
    assert abs(n - sig.shape[1]) < 128
    assert np.abs(data[:, 1000:n - 1000] - sig[:, 1000:n - 1000]).max() < 0.05
    assert abs(_freq(data[0][SR // 2: SR // 2 + SR]) - 440) <= 3
    ref, _ = jcodec.read_sound_file(path)
    np.testing.assert_array_equal(data, ref)


def test_flac_roundtrip_lossless(tmp_path):
    """16 and 24 bits, stereo and mono, a short last frame; the file is
    byte-equal to the JAX package's and decodes bit-equal through both."""
    rng = np.random.default_rng(7)
    t = np.arange(int(SR * 1.3) + 61) / SR
    sig = np.stack([0.5 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(len(t)),
                    0.5 * np.sin(2 * np.pi * 440 * t + 0.2)
                    + 0.1 * np.sin(2 * np.pi * 880 * t)]).astype(np.float32)
    for bits, data in ((16, sig), (24, sig), (16, sig[:1])):
        path = str(tmp_path / f"t{bits}_{data.shape[0]}.flac")
        ref_path = str(tmp_path / f"ref{bits}_{data.shape[0]}.flac")
        codec.write_flac(path, data, SR, bits=bits)
        jcodec.write_flac(ref_path, data, SR, bits=bits)
        assert Path(path).read_bytes() == Path(ref_path).read_bytes()
        dec, rate = codec.read_sound_file(path)
        assert rate == SR and dec.shape == data.shape
        scale = 2.0 ** (bits - 1)
        q = (np.clip(np.rint(data * scale), -scale, scale - 1) / scale).astype(np.float32)
        np.testing.assert_array_equal(dec, q)
        np.testing.assert_array_equal(dec, jcodec.read_sound_file(path)[0])


def test_flac_compresses_and_covers_subframe_types(tmp_path):
    t = np.arange(SR) / SR
    tonal = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 330 * t)
             ).astype(np.float32)
    sig = np.concatenate([np.zeros(4096, np.float32), np.full(4096, 0.125, np.float32),
                          tonal])[None]
    path = str(tmp_path / "t.flac")
    codec.write_flac(path, sig, SR, bits=16)
    assert os.path.getsize(path) < 0.5 * sig.shape[1] * 2
    dec, _ = codec.read_sound_file(path)
    q = np.clip(np.rint(sig * 32768.0), -32768, 32767) / 32768.0
    np.testing.assert_array_equal(dec, q.astype(np.float32))


def test_flac_bad_stream_and_bad_depth_raise(tmp_path):
    path = str(tmp_path / "t.flac")
    with open(path, "wb") as f:
        f.write(b"fLaC" + b"\x00" * 64)
    with pytest.raises(RuntimeError, match="FLAC|decode"):
        codec.read_sound_file(path)
    with pytest.raises(ValueError):
        codec.write_flac(path, np.zeros((1, 8), np.float32), SR, bits=12)
    junk = str(tmp_path / "t.xyz")
    with open(junk, "wb") as f:
        f.write(b"nope")
    with pytest.raises(ValueError, match="unrecognized"):
        codec.read_sound_file(junk)


def test_missing_library_raises_by_name(monkeypatch):
    """No fallback: a codec whose system library is missing raises naming
    it."""
    monkeypatch.setattr(codec, "_load", lambda *names: None)
    monkeypatch.setattr(codec, "_mpg123", None)
    monkeypatch.setattr(codec, "_vorbisfile", None)
    monkeypatch.setattr(codec, "_lame", None)
    for loader, name in ((codec._get_mpg123, "libmpg123"),
                         (codec._get_vorbisfile, "libvorbisfile"),
                         (codec._get_lame, "libmp3lame")):
        with pytest.raises(RuntimeError, match=name):
            loader()
    with pytest.raises(RuntimeError, match="vorbis"):
        codec.write_ogg("unused.ogg", np.zeros((1, 8), np.float32), SR)


def test_wav_dispatch(tmp_path):
    from knaster_tpu_torch.utils.wav import write_wav

    path = str(tmp_path / "t.wav")
    sig = _sig(SR // 4)
    write_wav(path, sig, SR)
    data, rate = codec.read_sound_file(path)
    assert rate == SR
    np.testing.assert_allclose(data, sig, atol=1e-6)
    np.testing.assert_array_equal(data, jcodec.read_sound_file(path)[0])


def _play(path, frames=SR // 8):
    buf = kt.Buffer.from_sound_file(path)
    g, proc = kt.AudioProcessor.new(0, 2, kt.AudioProcessorOptions(block_size=64,
                                                                   sample_rate=SR),
                                    device="cpu")
    g.edit(lambda gg: gg.push(kt.BufferReader(buf)).to_graph_out())
    return buf, proc.render(frames=frames)


def test_buffer_reader_plays_flac(tmp_path):
    path = str(tmp_path / "t.flac")
    codec.write_flac(path, _sig(), SR, bits=16)
    buf, audio = _play(path)
    assert buf.sample_rate == SR and buf.channels == 2
    np.testing.assert_array_equal(audio, buf.data[:, :SR // 8])  # lossless: no delay


@pytest.mark.skipif(not _have(codec._get_mpg123), reason="mp3 libraries unavailable")
def test_buffer_reader_plays_mp3(tmp_path):
    path = str(tmp_path / "t.mp3")
    codec.write_mp3(path, _sig(), SR)
    _, audio = _play(path)
    assert np.abs(audio[:, 3000:]).max() > 0.2  # the encoder's delay first, then sound
