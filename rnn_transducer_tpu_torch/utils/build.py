"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`) into one shared
library with a plain C interface; the counterpart of `utils/hostio.py` in
the JAX package, which loads its C++ host library the same way. The
library is built at first use into `csrc/build/` (listed in .gitignore),
under a name keyed by a hash of the sources and flags, so a changed source
builds anew and an unchanged one loads what is there. The build holds a
lock because the serving engine launches kernels from its worker thread;
the library is written to a temporary name and renamed into place, so a
second process never loads a half-written file.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the library's entry points: name -> (restype, argtypes).
# Every pointer and the stream are c_void_p: ctypes would otherwise pass a
# Python int as a 32-bit C int and cut the address.
_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # x_proj, w_hh, w_is_bf16, h0, c0, hs, c, B, T, H, device, stream
    "lstm_fwd": (_I, [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "lstm_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    with open(path[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)


def build_log() -> str:
    """The compiler's output (with ptxas register/shared-memory lines) of
    the build behind the current library, or '' if it was not built."""
    log = library_path()[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library, with signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib
