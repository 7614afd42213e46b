"""Helpers of the port's tests: torch on one CPU thread, and a CUDA
kernel's element steps built with the host C++ compiler.

``one_torch_thread`` is an autouse module fixture: a test module that
imports it runs torch on one intra-op thread. The port's plain CPU paths
are many small ops, which gain nothing from more threads, and several
test workers on one machine, each with a thread per core, contend.

The port's block kernels keep their arithmetic in headers under
``knaster_tpu_torch/csrc`` (``*.cuh``) that compile as plain C++ too. The
tests that hold a kernel bit-equal to its plain torch version on the CPU
compile a small C++ source around such a header with ``-ffp-contract=off``
(as nvcc's ``--fmad=false``: every add and multiply rounds on its own) and
call it through ctypes.
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "knaster_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for the module, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def compiler():
    """$CXX, g++, c++ or clang++: the first on the PATH, else None."""
    return next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                 if c and shutil.which(c)), None)


def build_host_library(tmp_path_factory, name, source, entries):
    """Compile the C++ source ``source`` (which includes csrc headers) into
    a library in a new temporary directory and load it; each entry point
    of ``entries`` ({symbol: argtypes}) returns nothing. Skips the test
    where there is no host C++ compiler."""
    cxx = compiler()
    if cxx is None:
        pytest.skip("no host C++ compiler (g++, c++, clang++) to build the kernel's steps")
    d = tmp_path_factory.mktemp(name)
    src, so = d / f"{name}.cpp", d / f"{name}.so"
    src.write_text(source)
    cmd = [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I", CSRC,
           "-o", str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for symbol, argtypes in entries.items():
        fn = getattr(lib, symbol)
        fn.restype = None
        fn.argtypes = argtypes
    return lib
