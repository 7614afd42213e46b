"""The port's native ring and audio backends (ports of tests/test_backends.py:14-286).

On the CPU (``device="cpu"``), block 64, with small lookaheads; each
streaming test keeps under a few seconds of wall. Besides the ports: the
port's ``NativeRing`` (built from native/knaster_rt.cpp into
build/knaster_tpu_torch/) against the JAX package's binding, the same
writes and reads giving equal data and equal counters; the duplex stream's
output against the JAX package's offline render over the same effective
input (within 1e-6: the one-pole's scan reassociates nothing, its
coefficients are computed alike); a failing thread stops the stream and
``stop()`` raises it.
"""

import threading
import time

import numpy as np
import pytest

import knaster_tpu as jk
from knaster_tpu.backends.native import NativeRing as JaxRing

import knaster_tpu_torch as kt
from knaster_tpu_torch.backends import OfflineBackend, StreamBackend
from knaster_tpu_torch.backends.native import NativeRing, library_path

B = 64


def _proc(inputs=0, outputs=1, m=kt):
    kw = {} if m is jk else {"device": "cpu"}
    return m.AudioProcessor.new(inputs, outputs, m.AudioProcessorOptions(block_size=B), **kw)


def test_native_ring_basic():
    r = NativeRing(256, 2)
    assert r.capacity >= 256
    blk = np.arange(2 * 64, dtype=np.float32).reshape(2, 64)
    assert r.write(blk) == 64
    assert r.available_read() == 64
    np.testing.assert_array_equal(r.read(64), blk)
    assert r.underruns == 0
    assert library_path().exists()
    assert library_path().parent.name == "knaster_tpu_torch"


def test_native_ring_underrun_zero_fill():
    r = NativeRing(128, 1)
    r.write(np.ones((1, 10), np.float32))
    out = r.read(20)
    np.testing.assert_array_equal(out[0, :10], 1.0)
    np.testing.assert_array_equal(out[0, 10:], 0.0)
    assert r.underruns == 1


def test_native_ring_wraparound_and_overrun():
    r = NativeRing(64, 1)
    cap = r.capacity
    assert r.write(np.zeros((1, cap), np.float32)) == cap
    assert r.write(np.ones((1, 8), np.float32)) == 0
    assert r.overruns == 1
    r.read(cap)
    seq = np.arange(cap // 2, dtype=np.float32)[None, :]
    r.write(seq)
    np.testing.assert_array_equal(r.read(cap // 2), seq)


def test_native_ring_threaded_spsc():
    """100 blocks through a producer and a consumer thread, losslessly."""
    r = NativeRing(1024, 1)
    n_blocks = 100
    src = np.arange(n_blocks * B, dtype=np.float32)
    got = []

    def producer():
        for i in range(n_blocks):
            blk = src[i * B:(i + 1) * B][None, :]
            while r.write(blk) < B:
                time.sleep(0.0001)

    def consumer():
        read = 0
        while read < n_blocks * B:
            avail = r.available_read()
            if avail:
                n = min(avail, B)
                got.append(r.read(n)[0])
                read += n
            else:
                time.sleep(0.0001)

    tp, tc = threading.Thread(target=producer), threading.Thread(target=consumer)
    tp.start()
    tc.start()
    tp.join(timeout=10)
    tc.join(timeout=10)
    np.testing.assert_array_equal(np.concatenate(got), src)
    assert r.underruns == 0


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_native_ring_matches_jax_binding(channels):
    """One script of writes and reads through both bindings: equal data,
    equal underrun, overrun and frame counters after every call."""
    rng = np.random.default_rng(channels)
    rings = (NativeRing(100, channels), JaxRing(100, channels))
    assert rings[0].capacity == rings[1].capacity == 128
    for step in range(60):
        if rng.random() < 0.5:
            blk = rng.standard_normal((channels, int(rng.integers(1, 90)))).astype(np.float32)
            w = [r.write(blk) for r in rings]
            assert w[0] == w[1], step
        else:
            n = int(rng.integers(1, 90))
            a, b = (r.read(n) for r in rings)
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        for attr in ("underruns", "overruns", "frames_written", "frames_read"):
            assert getattr(rings[0], attr) == getattr(rings[1], attr), (step, attr)
        assert rings[0].available_read() == rings[1].available_read()
        assert rings[0].available_write() == rings[1].available_write()
    assert rings[0].underruns > 0 and rings[0].overruns > 0


def test_offline_backend_wav(tmp_path):
    g, proc = _proc(outputs=2)
    g.edit(lambda gg: (gg.push(kt.SinWt(440.0)) * 0.2).out([0, 0]).to_graph_out())
    be = OfflineBackend(48000, 64)
    be.start_processing(proc)
    path = str(tmp_path / "out.wav")
    audio = be.render_to_wav(path, seconds=0.25)
    assert audio.shape == (2, 12000)
    from knaster_tpu_torch.utils.wav import read_wav

    back, sr = read_wav(path)
    np.testing.assert_allclose(back, audio, atol=0)


def test_stream_backend_live_edit():
    """The control thread sets a param while the stream runs."""
    g, proc = _proc()
    amp = g.edit(lambda gg: (lambda c: (c.to_graph_out(), c.param("value"))[1])(
        gg.push(kt.Constant(0.25))))
    captured = []
    be = StreamBackend(48000, 64, lookahead_blocks=4, chunk_blocks=2,
                       consumer=lambda blk: captured.append(blk.copy()))
    be.start_processing(proc)
    time.sleep(0.25)
    amp.set(0.75)
    time.sleep(0.25)
    be.stop()
    data = np.concatenate(captured, axis=1)[0]
    vals = set(np.round(np.unique(data), 3).tolist())
    assert 0.25 in vals and 0.75 in vals
    # paced at the audio rate: ~0.5 s of wall gives about that much audio
    assert 0.2 * 48000 < data.shape[0] < 1.5 * 48000


def test_stream_backend_structural_edit_glitch_free():
    """A structural edit while streaming: the old program plays on while
    the worker compiles and warms, then the new node sounds, without a
    dropout."""
    g, proc = _proc()
    g.edit(lambda gg: gg.push(kt.Constant(0.25)).to_graph_out())
    captured = []
    # the ring covers the worker's compile and warm (~0.27 s of lookahead)
    be = StreamBackend(48000, 64, lookahead_blocks=200, chunk_blocks=8,
                       consumer=lambda blk: captured.append(blk.copy()))
    be.start_processing(proc)
    time.sleep(0.3)
    g.edit(lambda gg: gg.push(kt.Constant(0.5)).to_graph_out())
    for _ in range(100):
        time.sleep(0.02)
        if captured and np.any(np.round(captured[-1], 3) == 0.75):
            break
    time.sleep(0.1)
    be.stop()
    data = np.concatenate(captured, axis=1)[0]
    vals = set(np.round(np.unique(data), 3).tolist())
    assert 0.25 in vals and 0.75 in vals
    assert proc.swaps and proc.swaps[-1][0] == g.revision
    first_nz = int(np.argmax(np.abs(data) > 0))
    running = data[first_nz:]
    assert running.size > 0
    assert np.all(np.abs(running) > 0.2), "dropout during the program swap"


def _lowpass(m):
    def build(gg):
        n = gg.push(m.OnePoleLpf(2000.0))
        gg.from_inputs(0).to(n)
        n.to_graph_out()

    return build


def test_stream_backend_duplex_input():
    """Input pushed through ``push_input`` reaches the graph in order: the
    consumer's output equals the offline render over the effective input
    (a prefill chunk of zeros, then the pushed input) in the producer's
    chunks, bit for bit, and the JAX package's offline render within 1e-6."""
    CB = 4
    g, proc = _proc(inputs=1)
    g.edit(_lowpass(kt))
    src = (np.random.default_rng(42).standard_normal((1, 24 * B)) * 0.5).astype(np.float32)
    captured = []
    gate = threading.Event()

    def consumer(blk):
        gate.wait()  # hold the drain until every chunk is rendered
        captured.append(blk.copy())

    be = StreamBackend(48000, B, lookahead_blocks=1000, chunk_blocks=CB, consumer=consumer)
    be.start_processing(proc)
    assert be.in_ring is not None and be.in_ring.channels == 1
    assert be.push_input(src) == src.shape[1]
    total = CB * B + src.shape[1]
    deadline = time.time() + 20
    while be.ring.frames_written < total and time.time() < deadline:
        time.sleep(0.005)
    assert be.ring.frames_written >= total, "the producer never consumed the input"
    assert be.input_underruns == 0
    gate.set()
    while be.ring.frames_read < total and time.time() < deadline:
        time.sleep(0.005)
    be.stop()
    got = np.concatenate(captured, axis=1)[:, :total]

    eff = np.concatenate([np.zeros((1, CB * B), np.float32), src], axis=1)
    refs = []
    for m in (kt, jk):
        g2, p2 = _proc(inputs=1, m=m)
        g2.edit(_lowpass(m))
        refs.append(np.concatenate(
            [np.asarray(p2.render(frames=CB * B, inputs=eff[:, i:i + CB * B]))
             for i in range(0, total, CB * B)], axis=1))
    np.testing.assert_array_equal(got, refs[0])
    np.testing.assert_allclose(got, refs[1], rtol=0, atol=1e-6)


def test_stream_backend_duplex_no_wait_zero_fills():
    g, proc = _proc(inputs=1)
    g.edit(lambda gg: gg.from_inputs(0).to_graph_out())
    be = StreamBackend(48000, B, lookahead_blocks=16, chunk_blocks=4, input_wait=False,
                       consumer=lambda blk: None)
    be.start_processing(proc)
    time.sleep(0.3)
    be.stop()
    assert be.ring.frames_written >= 2 * 4 * B
    assert be.input_underruns > 0


def test_stream_thread_failure_stops_and_raises():
    """A consumer that raises stops the stream; stop() raises its error."""
    g, proc = _proc()
    g.edit(lambda gg: gg.push(kt.Constant(0.25)).to_graph_out())
    calls = []

    def consumer(blk):
        calls.append(1)
        if len(calls) == 20:
            raise ValueError("device callback failed")

    be = StreamBackend(48000, B, lookahead_blocks=16, chunk_blocks=4, consumer=consumer)
    be.start_processing(proc)
    deadline = time.time() + 5
    while be.error is None and time.time() < deadline:
        time.sleep(0.01)
    n = len(calls)
    time.sleep(0.05)
    assert len(calls) == n, "the consumer kept reading after a failure"
    with pytest.raises(RuntimeError, match="knaster-consumer") as info:
        be.stop()
    assert isinstance(info.value.__cause__, ValueError)


def test_stream_producer_failure_raises():
    """A graph edit whose warm fails in the compile worker kills the
    producer where it would swap; the stream stops and stop() raises."""
    g, proc = _proc()
    g.edit(lambda gg: gg.push(kt.Constant(0.25)).to_graph_out())
    be = StreamBackend(48000, B, lookahead_blocks=16, chunk_blocks=4, consumer=None)
    be.start_processing(proc)

    def broken(cg, state):
        raise ValueError("warm failed")

    proc._warm_programs = broken
    g.edit(lambda gg: gg.push(kt.Constant(0.5)).to_graph_out())
    deadline = time.time() + 5
    while be.error is None and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="knaster-producer"):
        be.stop()


def test_async_recompile_worker_warms_new_program():
    """The worker publishes a warmed program from a snapshot while the old
    program renders on (tests/test_backends.py:247)."""
    g, proc = _proc()
    g.edit(lambda gg: gg.push(kt.Constant(0.25)).to_graph_out())
    proc._ensure_compiled()
    proc._warm_scan_lengths = (16,)
    proc.enable_async_recompile()
    proc.render(frames=64 * 16)
    g.edit(lambda gg: gg.push(kt.Constant(0.5)).to_graph_out())
    proc._kick_async_compile()
    while proc._compile_thread.is_alive():
        proc.render(frames=64 * 16)
    proc._compile_thread.join(timeout=60)
    ready = proc._compiled_next or proc.compiled
    assert ready.revision == g.root().revision
    assert 16 in ready.super_fns and 16 in ready.full_scan_warm
    assert 16 in ready.evchunk_fns and ("full", 16) in ready.super_fns
