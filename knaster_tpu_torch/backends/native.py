"""Port of knaster_tpu/backends/native.py: the ctypes binding of the native SPSC ring.

``NativeRing`` binds ``native/knaster_rt.cpp`` (a lock-free single-producer
single-consumer ring of interleaved f32 frames with underrun and overrun
counters, the reference's rtrb analog). The library is built at first use
into ``build/knaster_tpu_torch/`` (git-ignored), named by a hash of the
source and the flags, so that an edit rebuilds; a failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

RT_SOURCE = Path(__file__).resolve().parents[2] / "native" / "knaster_rt.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the ring library of this source and these flags is built."""
    from ..kernels.build import BUILD_DIR

    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(RT_SOURCE.read_bytes())
    return BUILD_DIR / f"libknaster_rt_{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile ``native/knaster_rt.cpp`` if its library is missing ($CXX,
    else c++ or g++); raises with the compiler's output if it fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, c++ or g++) to build "
                           "native/knaster_rt.cpp")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(RT_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("failed to build native/knaster_rt.cpp:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_native():
    """Build (if needed) and load the ring library once."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native()))
        u32, u64, fp = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p
        lib.kn_ring_new.restype = fp
        lib.kn_ring_new.argtypes = [u32, u32]
        lib.kn_ring_destroy.argtypes = [fp]
        for name in ("kn_ring_capacity", "kn_ring_channels",
                     "kn_ring_available_read", "kn_ring_available_write"):
            getattr(lib, name).restype = u32
            getattr(lib, name).argtypes = [fp]
        lib.kn_ring_write.restype = u32
        lib.kn_ring_write.argtypes = [fp, ctypes.POINTER(ctypes.c_float), u32]
        lib.kn_ring_read.restype = u32
        lib.kn_ring_read.argtypes = [fp, ctypes.POINTER(ctypes.c_float), u32]
        for name in ("kn_ring_underruns", "kn_ring_overruns",
                     "kn_ring_frames_written", "kn_ring_frames_read"):
            getattr(lib, name).restype = u64
            getattr(lib, name).argtypes = [fp]
        _lib = lib
        return lib


class NativeRing:
    """SPSC audio ring (the reference's rtrb analog), interleaved f32.

    The producer (``write``) and the consumer (``read``) may run on two
    threads; neither side waits. A read always fills the frames it asks
    for, zero-padding and counting an underrun when the ring runs dry
    (realtime callback semantics); a write that does not fit writes what
    fits and counts an overrun."""

    def __init__(self, capacity_frames: int, channels: int):
        self._lib = load_native()
        self._ptr = self._lib.kn_ring_new(int(capacity_frames), int(channels))
        if not self._ptr:
            raise MemoryError("kn_ring_new failed")
        self.channels = int(channels)

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.kn_ring_destroy(ptr)

    @property
    def capacity(self) -> int:
        return self._lib.kn_ring_capacity(self._ptr)

    def available_read(self) -> int:
        return self._lib.kn_ring_available_read(self._ptr)

    def available_write(self) -> int:
        return self._lib.kn_ring_available_write(self._ptr)

    def write(self, block: np.ndarray) -> int:
        """block: [channels, frames] (planar, as graph outputs); returns the
        frames written."""
        inter = np.ascontiguousarray(np.asarray(block, dtype=np.float32).T)
        ptr = inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return self._lib.kn_ring_write(self._ptr, ptr, inter.shape[0])

    def read(self, frames: int) -> np.ndarray:
        """Read ``frames``, zero-filled on underrun; returns [channels, frames]."""
        out = np.empty((frames, self.channels), np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.kn_ring_read(self._ptr, ptr, frames)
        return out.T.copy()

    @property
    def underruns(self) -> int:
        return self._lib.kn_ring_underruns(self._ptr)

    @property
    def overruns(self) -> int:
        return self._lib.kn_ring_overruns(self._ptr)

    @property
    def frames_written(self) -> int:
        return self._lib.kn_ring_frames_written(self._ptr)

    @property
    def frames_read(self) -> int:
        return self._lib.kn_ring_frames_read(self._ptr)
