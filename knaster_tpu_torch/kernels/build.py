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

A user voice's CUDA body (``KernelVoiceSpec.cuda_source``, or the source
``lower.lower_body`` writes from a voice's torch body) is built the same
way into a library of its own: ``user_translation_unit`` wraps the
source in a translation unit that includes ``csrc/generic_harness.cuh``
and exports ``ktt_generic_bank`` (the library harness's arguments) and
``ktt_body_counts`` (the body's NF, NT, NC and C). ``load_user_body``
writes it into ``build/knaster_tpu_torch/``, names the library by a hash of
the harness headers, the source and the flags, builds it at first use with
the same flags (the compiler's log beside it) and loads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "knaster_tpu_torch"
KERNELS = ("sine_bank", "fm_bank", "sub_bank", "wt_bank", "generic_bank", "fm_cascade",
           "chain_kernel", "pink_noise", "buffer_reader", "svf_filter", "galactic",
           "env_asr")

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


def build_all(names=KERNELS, user_sources=()) -> dict:
    """Compile every named kernel library, and every user body of
    ``user_sources`` (hand-written or lowered sources), whose current build
    is missing, one nvcc per source,
    all at once; returns {name: path} for the kernels. The compiler's log
    (with ptxas register counts) is kept beside each as ``<name>_<hash>.log``."""
    if unknown := [n for n in names if n not in KERNELS]:
        raise ValueError(f"unknown kernels {unknown}; known: {KERNELS}")
    paths = {name: library_path(name) for name in names}
    jobs = [(f"{n}.cu", paths[n], CSRC / f"{n}.cu") for n in names if not paths[n].exists()]
    for source in user_sources:
        so = user_body_path(source)
        if not so.exists() and all(j[1] != so for j in jobs):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so.with_suffix(".cu").write_text(user_translation_unit(source))
            jobs.append((f"a user voice body ({so.with_suffix('.cu')})", so,
                         so.with_suffix(".cu")))
    _compile(jobs)
    return paths


def _compile(jobs):
    """Run one nvcc per (label, library, source) job, all at once; raise with
    the compiler's output of every job that failed. Each job's log (its
    command, the compiler's output and its wall seconds, ``build_seconds``)
    is kept beside its library."""
    if not jobs:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    running = []
    t0 = time.monotonic()
    for label, so, src in jobs:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        out = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True)
        running.append([label, so, tmp, cmd, proc, out, None])
    while any(job[6] is None for job in running):
        for job in running:
            if job[6] is None and job[4].poll() is not None:
                job[6] = time.monotonic() - t0
        time.sleep(0.05)
    failed = []
    for label, so, tmp, cmd, proc, out, secs in running:
        with out:
            out.seek(0)
            log = f"$ {' '.join(cmd)}\n{out.read()}\n# nvcc: {secs:.1f} s\n"
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {label}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_seconds(so: Path):
    """The wall seconds nvcc took for a library, from the log beside it
    (None for a library built before the log kept them)."""
    for line in so.with_suffix(".log").read_text().splitlines():
        if line.startswith("# nvcc: "):
            return float(line.split()[2])
    return None


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


# the headers a user body's translation unit includes
HARNESS_HEADERS = ("generic_harness.cuh", "bank_common.cuh", "env_asr.cuh", "scan_base16.cuh")
USER_BODY_STRUCT = "VoiceBody"


def user_translation_unit(source: str) -> str:
    """The translation unit of a user voice's CUDA body: the harness header,
    the user's source (which defines ``struct VoiceBody`` in the harness's
    body contract, csrc/generic_harness.cuh) in the harness's namespace, and
    the two exported functions."""
    return f"""// A user voice's body for the generic fused voice-bank harness,
// generated by knaster_tpu_torch/kernels/build.py user_translation_unit.
#include "generic_harness.cuh"

namespace {{

// ---- the voice's cuda_source ----
{source}
// ---- end of the voice's cuda_source ----

}}  // namespace

extern "C" {{

// the body's NF, NT, NC and C, checked against the voice before a launch
int ktt_body_counts(int* out) {{
  out[0] = {USER_BODY_STRUCT}::NF;
  out[1] = {USER_BODY_STRUCT}::NT;
  out[2] = {USER_BODY_STRUCT}::NC;
  out[3] = {USER_BODY_STRUCT}::C;
  return 0;
}}

// ktt_generic_bank's arguments (csrc/generic_bank.cu); the body id must be 0
int ktt_generic_bank(int body, const float* ramps, const float* rounds, const float* act,
                     const uint32_t* words, const uint32_t* carry_in, const float* consts,
                     const float* image, float* work, float* mix, unsigned* tickets,
                     uint32_t* carry_out, int V, int B, int D, int eventful, int n_consts,
                     int n_image, void* stream) {{
  if (body != 0 || V < 1 || B < 1 || (eventful && D < 1) || image == nullptr) {{
    return static_cast<int>(cudaErrorInvalidValue);
  }}
  const Launch L{{ramps, rounds, act, words, carry_in, consts, image, work, mix, tickets,
                 carry_out, V, B, D, eventful, n_consts, n_image,
                 static_cast<cudaStream_t>(stream)}};
  return static_cast<int>(launch_body<{USER_BODY_STRUCT}>(L));
}}

}}  // extern "C"
"""


def user_body_digest(source: str) -> str:
    """A hash of the harness headers, the user's source and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HARNESS_HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(user_translation_unit(source).encode())
    return h.hexdigest()[:16]


def user_body_path(source: str) -> Path:
    return BUILD_DIR / f"user_body_{user_body_digest(source)}.so"


def build_user_body(source: str) -> Path:
    """Compile a user body's translation unit into
    ``build/knaster_tpu_torch/user_body_<hash>.so`` unless it is there; the
    translation unit and the compiler's log are kept beside it. Raises with
    nvcc's output if the build fails."""
    build_all((), (source,))
    return user_body_path(source)


def load_user_body(source: str) -> ctypes.CDLL:
    """Build if needed and load a user body's library once, its entry point
    declared as ``ktt_generic_bank``'s and ``ktt_body_counts`` beside it."""
    key = user_body_path(source).stem
    with _lock:
        if key in _libs:
            return _libs[key]
        lib = ctypes.CDLL(str(build_user_body(source)))
        from .generic_bank import ARGTYPES

        lib.ktt_generic_bank.restype = ctypes.c_int
        lib.ktt_generic_bank.argtypes = ARGTYPES
        lib.ktt_body_counts.restype = ctypes.c_int
        lib.ktt_body_counts.argtypes = [ctypes.c_void_p]
        lib.ktt_error_string.restype = ctypes.c_char_p
        lib.ktt_error_string.argtypes = [ctypes.c_int]
        _libs[key] = lib
        return lib


def user_body_counts(lib: ctypes.CDLL) -> tuple:
    """(NF, NT, NC, C) of a loaded user body's library."""
    out = (ctypes.c_int * 4)()
    lib.ktt_body_counts(ctypes.cast(out, ctypes.c_void_p))
    return tuple(out)
