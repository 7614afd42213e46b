"""Port of knaster_tpu/backends/stream.py: the audio backends.

Parity with knaster_graph/src/audio_backend.rs (the AudioBackend trait and
its CPAL/JACK backends). The card renders blocks ahead of the consumer
through the native SPSC ring (``backends/native.py``), so an edit's compile
or the host's jitter does not glitch the stream while the ring holds
enough lookahead: the role of a device buffer in the reference.

* :class:`OfflineBackend` — the non-realtime bounce to an array or a WAV.
* :class:`StreamBackend` — streaming on three threads: a producer renders
  chunks on the processor's device (``render(fetch=False)``: the audio stays
  on the card), a fetcher makes the only device-to-host copy and writes the
  ring, and a consumer drains it at the audio rate into a callback (a
  stand-in for a device callback). Graph edits stay live from the control
  thread: the stream turns on the processor's async recompile.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..graph.processor import AudioProcessor


class AudioBackend:
    """Backend trait (audio_backend.rs:23-42)."""

    def sample_rate(self) -> int:
        raise NotImplementedError

    def block_size(self) -> Optional[int]:
        raise NotImplementedError

    def start_processing(self, processor: AudioProcessor) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass


class OfflineBackend(AudioBackend):
    """Non-realtime rendering backend."""

    def __init__(self, sample_rate: int = 48000, block_size: int = 64):
        self._sr = sample_rate
        self._block = block_size
        self.processor: Optional[AudioProcessor] = None

    def sample_rate(self) -> int:
        return self._sr

    def block_size(self) -> Optional[int]:
        return self._block

    def start_processing(self, processor: AudioProcessor) -> None:
        self.processor = processor

    def render(self, seconds=None, frames=None, inputs=None) -> np.ndarray:
        return self.processor.render(seconds=seconds, frames=frames, inputs=inputs)

    def render_to_wav(self, path: str, seconds=None, frames=None,
                      subtype: str = "float32") -> np.ndarray:
        from ..utils.wav import write_wav

        audio = self.render(seconds=seconds, frames=frames)
        write_wav(path, audio, self._sr, subtype)
        return audio


class StreamBackend(AudioBackend):
    """Streaming backend over the native lock-free ring.

    ``consumer``: callable(block [channels, frames]) invoked at the audio
    rate from the consumer thread (the device callback); None paces a null
    sink. ``lookahead_blocks`` is the ring's capacity (at least three
    chunks): how far the producer renders ahead, and so the longest delay
    from an asap control change to its sound. ``chunk_blocks``: blocks
    rendered per producer iteration; scheduled events stay sample-accurate
    (``render`` splits eventful chunks), and control latency is up to one
    chunk.

    **Duplex** (audio_backend/jack.rs:25-250): when the graph has input
    channels a second ring carries capture input. Its writer calls
    :meth:`push_input`; the producer takes exactly one chunk per rendered
    chunk, in order. ``input_wait=True`` paces the producer on input;
    ``input_wait=False`` zero-fills missing input and counts
    ``input_underruns``. The prefill chunk renders with zero input.

    A thread that raises stops the stream; :meth:`stop` raises it (and a
    failure of the async-recompile worker, which the producer raises where
    it would swap the program in). ``error`` is the first one, or None.
    """

    def __init__(
        self,
        sample_rate: int = 48000,
        block_size: int = 64,
        lookahead_blocks: int = 192,
        consumer: Optional[Callable[[np.ndarray], None]] = None,
        chunk_blocks: int = 32,
        input_wait: bool = True,
    ):
        self._sr = sample_rate
        self._block = block_size
        # at least three chunks: one draining, one in flight, one margin
        self.lookahead = max(int(lookahead_blocks), 3 * int(chunk_blocks))
        self.chunk_blocks = int(chunk_blocks)
        self.consumer = consumer
        self.input_wait = bool(input_wait)
        self.processor: Optional[AudioProcessor] = None
        self.ring = None
        self.in_ring = None
        self._threads = []
        self._running = threading.Event()
        self._errors = []
        self._switch_interval = None

    def sample_rate(self) -> int:
        return self._sr

    def block_size(self) -> Optional[int]:
        return self._block

    @property
    def error(self) -> Optional[BaseException]:
        return self._errors[0][1] if self._errors else None

    # -- the three-thread engine -----------------------------------------
    def start_processing(self, processor: AudioProcessor) -> None:
        from .native import NativeRing

        self.processor = processor
        device = processor.device
        # the ring's capacity IS the lookahead
        self.ring = NativeRing(self._block * max(self.lookahead, 4), processor.graph.outputs)
        if processor.graph.inputs > 0:
            self.in_ring = NativeRing(self._block * max(self.lookahead, 4),
                                      processor.graph.inputs)

        # every program the producer can take, built and run once; edits
        # while live compile and warm on a worker and swap between blocks
        processor.warm_for_stream(self.chunk_blocks)
        processor.enable_async_recompile()

        chunk_frames = self._block * self.chunk_blocks
        # the threads share the GIL, which Python hands over every switch
        # interval (5 ms by default, several blocks of audio): while the
        # stream runs, a quarter of a block, so the consumer and the
        # control thread are not starved by the producer
        self._switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(min(self._switch_interval, self._block / self._sr / 4))
        # prefill: one chunk in the ring before the consumer drains
        self.ring.write(processor.render(frames=chunk_frames))
        self._running.set()

        # the producer only enqueues (the audio stays on the device); the
        # fetcher's copy to the host waits for it, overlapping the next chunk
        inflight: "queue.Queue" = queue.Queue(maxsize=2)
        # chunks the fetcher holds but has not yet written: neither in
        # ``inflight`` nor in the ring, and the producer must count them
        held = [0]

        ready = threading.Event()

        def producer():
            try:
                if device.type == "cuda":
                    # this thread's cuBLAS handle (a convolver's products)
                    # before the consumer drains, not inside the first chunk
                    x = torch.zeros((8, 8), device=device)
                    torch.mm(x, x)
                    torch.cuda.synchronize(device)
            finally:
                ready.set()
            while self._running.is_set():
                input_ready = (self.in_ring is None or not self.input_wait
                               or self.in_ring.available_read() >= chunk_frames)
                if (input_ready and not inflight.full()
                        and self.ring.available_write()
                        >= chunk_frames * (1 + inflight.qsize() + held[0])):
                    inp = None if self.in_ring is None else self.in_ring.read(chunk_frames)
                    inflight.put(processor.render(frames=chunk_frames, fetch=False,
                                                  inputs=inp))
                else:
                    time.sleep(self._block / self._sr / 4)

        def fetcher():
            while self._running.is_set() or not inflight.empty():
                try:
                    dev = inflight.get(timeout=0.05)
                except queue.Empty:
                    continue
                held[0] = 1
                arr = dev.cpu().numpy()
                # never drop frames: write what fits, then wait for the
                # consumer (backpressure, not loss)
                written = self.ring.write(arr)
                while written < arr.shape[1] and self._running.is_set():
                    time.sleep(self._block / self._sr / 4)
                    written += self.ring.write(arr[:, written:])
                held[0] = 0

        def consume():
            period = self._block / self._sr
            next_t = time.monotonic()
            while self._running.is_set():
                block = self.ring.read(self._block)
                if self.consumer is not None:
                    self.consumer(block)
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_t = time.monotonic()  # fell behind; resync

        def guarded(name, body, cuda):
            def run():
                try:
                    if cuda and device.type == "cuda":
                        torch.cuda.set_device(device)
                    body()
                except BaseException as exc:
                    self._errors.append((name, exc))
                    self._running.clear()  # stop the stream: no silent zeros
            return threading.Thread(target=run, daemon=True, name=name)

        self._threads = [
            guarded("knaster-producer", producer, True),
            guarded("knaster-fetcher", fetcher, True),
            guarded("knaster-consumer", consume, False),
        ]
        self._threads[0].start()
        ready.wait()
        for t in self._threads[1:]:
            t.start()

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the threads and wait for them (and the compile worker);
        raise the first failure of any of them."""
        self._running.clear()
        for t in self._threads:
            t.join(timeout=timeout)
        alive = [t.name for t in self._threads if t.is_alive()]
        self._threads = []
        if self._switch_interval is not None:
            sys.setswitchinterval(self._switch_interval)
            self._switch_interval = None
        try:
            if self.processor is not None:
                self.processor.join_background()
        except BaseException as exc:
            self._errors.append(("knaster-compile", exc))
        if self._errors:
            name, exc = self._errors[0]
            raise RuntimeError(f"the stream's {name} thread failed") from exc
        if alive:
            raise RuntimeError(f"stream threads did not stop: {alive}")

    # -- duplex input ------------------------------------------------------
    def push_input(self, block) -> int:
        """Feed capture input (the device's input callback side).

        ``block``: [input_channels, frames]. Returns the frames accepted (0
        when the input ring is full: the producer is behind). Call from ONE
        thread (SPSC ring)."""
        if self.in_ring is None:
            raise RuntimeError(
                "graph has no input channels (push_input needs "
                "AudioProcessor.new(inputs=n, ...))"
            )
        block = np.asarray(block, dtype=np.float32)
        if block.ndim != 2 or block.shape[0] != self.in_ring.channels:
            raise ValueError(
                f"expected [{self.in_ring.channels}, frames] input block, "
                f"got {block.shape}"
            )
        return self.in_ring.write(block)

    def input_space(self) -> int:
        """Frames the input ring can accept right now."""
        return self.in_ring.available_write() if self.in_ring else 0

    @property
    def input_underruns(self) -> int:
        """Chunks rendered with zero-filled missing input (input_wait=False)."""
        return self.in_ring.underruns if self.in_ring else 0

    @property
    def underruns(self) -> int:
        return self.ring.underruns if self.ring else 0
