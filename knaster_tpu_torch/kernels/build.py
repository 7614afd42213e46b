"""Build and load the port's CUDA kernels: nvcc into a shared library, ctypes to call it.

``load_library()`` compiles ``csrc/sine_bank.cu`` for sm_90a at first use
into ``build/knaster_tpu_torch/`` at the repository root (git-ignored), named
by a hash of the source and flags so that an edited source rebuilds, then
loads it with ``ctypes``. The library has a plain C interface, so the build
needs neither torch's headers nor ninja and takes seconds. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR / "csrc" / "sine_bank.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "knaster_tpu_torch"

# no fast math: the kernel's state must round like the plain torch version
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"sine_bank_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless the current source's build exists;
    returns its path. The compiler's log (with ptxas register counts) is
    kept beside it as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    so.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {_SRC.name}:\n{log}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, declare the C entry points."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ktt_sine_bank.restype = i32
        lib.ktt_sine_bank.argtypes = [vp] * 13 + [i32] * 4 + [f32] * 3 + [vp]
        lib.ktt_error_string.restype = ctypes.c_char_p
        lib.ktt_error_string.argtypes = [i32]
        _lib = lib
        return lib
