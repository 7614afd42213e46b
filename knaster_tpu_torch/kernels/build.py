"""Build and load the port's CUDA kernels: nvcc into shared libraries, ctypes to call them.

Every ``csrc/<name>.cu`` is one kernel library with a plain C interface
(entry point ``ktt_<name>``, plus ``ktt_error_string``). ``build_all()``
compiles them for sm_90a at first use into ``build/knaster_tpu_torch/`` at
the repository root (git-ignored), one ``nvcc`` process per source, all
started together. Each library is named by a hash of every source and
header in ``csrc/`` and the flags, so that any edit rebuilds. The build
needs neither torch's headers nor ninja and takes seconds. A failed build
raises with the compiler's output. ``load_library(name)`` builds what is
missing and loads the library with ``ctypes``, its entry point declared from
the kernel module's ``ARGTYPES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "knaster_tpu_torch"
KERNELS = ("sine_bank", "fm_bank", "sub_bank", "wt_bank", "generic_bank", "fm_cascade",
           "chain_kernel")

# no fast math: the kernels' state must round like the plain torch versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs = {}
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


def source_digest() -> str:
    """A hash of every source and header in ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}_{source_digest()}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every named kernel library whose current build is missing,
    one nvcc per source, all at once; returns {name: path}. The compiler's
    log (with ptxas register counts) is kept beside each as
    ``<name>_<hash>.log``."""
    if unknown := [n for n in names if n not in KERNELS]:
        raise ValueError(f"unknown kernels {unknown}; known: {KERNELS}")
    paths = {name: library_path(name) for name in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    running = []
    for name in todo:
        so = paths[name]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, so, tmp, cmd, proc))
    failed = []
    for name, so, tmp, cmd, proc in running:
        out, _ = proc.communicate()
        log = f"$ {' '.join(cmd)}\n{out}"
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, load ``csrc/<name>.cu``'s library once, declare its
    entry point ``ktt_<name>`` from ``kernels/<name>.py``'s ARGTYPES."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        module = importlib.import_module(f"{__package__}.{name}")
        fn = getattr(lib, f"ktt_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = module.ARGTYPES
        lib.ktt_error_string.restype = ctypes.c_char_p
        lib.ktt_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib
