"""Build and load the port's hand-written kernels (K1, K2).

The sources under ``csrc/`` are compiled at first use (one compiler
process per source, all started together, then one link) into a shared
library with a plain C interface, kept under ``_build/`` by a digest of the
sources and flags, and loaded with ctypes.

* ``load_library()``: ``nvcc`` for Hopper (``sm_90a``), ``-O3`` and
  ``--fmad=false``, so that no float multiply and add are contracted behind
  the code's back: the kernels round their cost expressions exactly where
  the reference does (an explicit fused multiply-add where XLA fuses,
  separate operations elsewhere).  A failed build raises; nothing falls
  back.
* ``load_host_library()``: the same sources as plain C++ with ``g++``
  (``-ffp-contract=off``), one thread per block; the CPU tests use it to
  hold the kernels' arithmetic against the plain torch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_DIR, "csrc")
_BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
#: compiler output of the last build (``-Xptxas -v`` register/smem report)
BUILD_LOG = ""


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _build(compiler: list, flags: list, tag: str) -> str:
    """Compile every source to an object file, all compilers started
    together, then link the shared library."""
    global BUILD_LOG
    srcs = _sources()
    h = hashlib.sha256(" ".join(compiler + flags).encode())
    for s in srcs + sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(_BUILD_DIR, f"x265_kernels_{tag}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen(compiler + flags + ["-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    BUILD_LOG = "".join(logs)
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError(f"{compiler[0]} failed:\n" + BUILD_LOG[-8000:])
        r = subprocess.run(compiler + ["-shared", "-o", tmp] + objs,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{compiler[0]} link failed:\n"
                               + (r.stdout + r.stderr)[-8000:])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, so)
    return so


def _bind(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k1_ctu_step.argtypes = [ctypes.POINTER(vp), ci, ci, ci, ci, ci, ci,
                                ci, ctypes.c_float, vp]
    lib.k1_ctu_step.restype = ci
    lib.k1_smem_bytes.argtypes = []
    lib.k1_smem_bytes.restype = ci
    lib.k2_subpel_refine.argtypes = [vp] * 9 + [ci, ci, ci, ci, ci, vp]
    lib.k2_subpel_refine.restype = ci
    lib.k_error_string.argtypes = [ci]
    lib.k_error_string.restype = ctypes.c_char_p
    return lib


def _load(tag: str, make):
    with _LOCK:
        if tag not in _LIBS:
            _LIBS[tag] = _bind(make())
        return _LIBS[tag]


def load_library():
    """The CUDA kernel library (built with nvcc on first call)."""
    def make():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels need the "
                               "CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
        return _build([nvcc], NVCC_FLAGS + ["-Xptxas", "-v"], "sm90a")
    return _load("cuda", make)


def load_host_library():
    """The kernel sources built as host C++ (g++), one thread per block."""
    return _load("host", lambda: _build(["g++"], HOST_FLAGS, "host"))
