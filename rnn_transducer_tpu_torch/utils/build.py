"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`), one nvcc per
source, all started together, and the objects are linked into one shared
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the library's entry points: name -> (restype, argtypes).
# Every pointer and the stream are c_void_p: ctypes would otherwise pass a
# Python int as a 32-bit C int and cut the address.
_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
SIGNATURES = {
    # x_proj, w_hh, w_is_bf16, h0, c0, hs, c, acts, cs, xbuf, B, T, H,
    # units, rows, stage_rows, stage_cols, device, stream
    "lstm_fwd": (_I, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P]),
    # acts, cs_prev, dhs, dcT, w_hh, w_is_bf16, dgates, dh0, dc0, xbuf, B,
    # T, H, units, rows, stage_rows, stage_cols, device, stream
    "lstm_bwd": (_I, [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P]),
    # device -> SMs, opt-in shared bytes a block, cooperative launch
    "lstm_bwd_limits": (_I, [_I, _IP, _IP, _IP]),
    # f, g, labels, w, w_is_bf16, b, lp_blank, lp_y, base, B, T, U1, J, V,
    # blank, device, stream
    "joint_fwd": (_I, [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _P]),
    # w, wt, J, V, wt_rows, smem_bytes, device, stream
    "joint_fwd_wt": (_I, [_P, _P, _I, _I, _LL, _LL, _I, _P]),
    # f, g, labels, wt, b, lp_blank, lp_y, base, B, T, U1, J, V, blank,
    # wt_rows, smem_bytes, device, stream
    "joint_fwd_ring": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _LL, _LL, _I, _P]),
    # f, g, labels, w, w_is_bf16, b, gb, gy, base, gbar, df, dg_part, B, T,
    # U1, J, V, blank, frames_per_tile, device, stream
    "joint_bwd_a": (_I, [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _I, _I, _I, _P]),
    # w, wt, J, V, wt_rows, device, stream
    "joint_bwd_a_wt": (_I, [_P, _P, _I, _I, _LL, _I, _P]),
    # f, g, labels, wt, b, gb, gy, base, gbar, dz, B, T, U1, J, V, blank,
    # wt_rows, smem_bytes, device, stream
    "joint_bwd_a_ring": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _LL, _LL, _I, _P]),
    # f, g, labels, w, w_is_bf16, b, gb, gy, base, gbar, dw_part, db_part,
    # B, T, U1, J, V, blank, n_split, device, stream
    "joint_bwd_b": (_I, [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _I, _I, _I, _P]),
    # f, g, zb, B, T, U1, J, device, stream
    "joint_bwd_b_zb": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # zb, labels, w, b, gb, gy, base, gbar, dw_out, db_out, B, T, U1, J, V,
    # blank, grid_x, n_split, split_rows, smem_bytes, device, stream
    "joint_bwd_b_ring": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _I,
                              _P]),
    # a_part, df, dg, dw_part, dw, db_part, db, B, T, U1, J, V, n_tiles,
    # n_split, device, stream
    "joint_bwd_sums": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P]),
    # lp_blank_m, lp_y_m, alpha, B, T, U1, device, stream
    "lattice_alpha": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    # lp_blank_m, lp_y_m, accept, alpha, frame_lens, beta, g_blank, g_y,
    # B, T, U1, device, stream
    "lattice_beta": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P]),
    # logits, logits_is_bf16, labels, lp_blank, lp_y, B, T, U1, V, blank,
    # device, stream
    "extract_lp": (_I, [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # logits, logits_is_bf16, labels, occ, g_blank, g_y, grad, B, T, U1, V,
    # blank, device, stream
    "assemble_grad": (_I, [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P]),
    # x_proj, x_is_bf16, wq, scale, h0, c0, hs, c, xbuf, B, T, H, BT,
    # units, rows, stage_rows, stage_cols, device, stream
    "lstm_fwd_q": (_I, [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P]),
    # f, lens, embed, w_ih, w_hh, b, wp, bp, wo, bo, tokens, steps, B, T, E,
    # H, J, V, U_max, blank, cd_is_bf16, device, stream
    "greedy_fused": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # x, g, b, y, mu, rstd, N, D, silu, device, stream
    "fused_ln_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # N, D, rows_per_block -> rows of the backward's partial sums
    "fused_ln_bwd_parts": (_I, [_I, _I, _I]),
    # x, g, b, mu, rstd, dy, dx, dg, db, dg_part, db_part, N, D,
    # rows_per_block, silu, device, stream
    "fused_ln_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _I, _I, _P]),
    # f, g_w, lab_w, w, w_is_bf16, b, lp_blank, lp_y, base, B, T, S, J, V,
    # blank, device, stream
    "band_fwd": (_I, [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _P]),
    # w, wt, J, V, wt_rows, smem_bytes, device, stream
    "band_fwd_wt": (_I, [_P, _P, _I, _I, _LL, _LL, _I, _P]),
    # f, g_w, lab_w, wt, b, lp_blank, lp_y, base, B, T, S, J, V, blank,
    # wt_rows, smem_bytes, device, stream
    "band_fwd_ring": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _LL, _LL, _I, _P]),
    # f, g_w, lab_w, w, w_is_bf16, b, base, cb, cy, df, dg_w, B, T, S, J,
    # V, blank, device, stream
    "band_bwd_a": (_I, [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _I, _I, _P]),
    # w, wt, J, V, wt_rows, device, stream
    "band_bwd_a_wt": (_I, [_P, _P, _I, _I, _LL, _I, _P]),
    # f, g_w, lab_w, wt, b, base, cb, cy, df, dg_w, B, T, S, J, V, blank,
    # wt_rows, smem_bytes, device, stream
    "band_bwd_a_ring": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _LL, _LL, _I, _P]),
    # f, g_w, lab_w, w, w_is_bf16, b, base, cb, cy, dw, db, dw_part,
    # db_part, B, T, S, J, V, blank, n_split, device, stream
    "band_bwd_b": (_I, [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # f, g_w, zb, B, T, S, J, device, stream
    "band_bwd_b_zb": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # zb, lab_w, w, b, base, cb, cy, dw, db, dw_part, db_part, B, T, S, J,
    # V, blank, grid_x, n_split, split_rows, smem_bytes, device, stream
    "band_bwd_b_ring": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _LL, _LL, _I,
                             _P]),
    "kernel_error_string": (ctypes.c_char_p, [_I]),
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


def _run_all(cmds: list[list[str]]) -> tuple[list[int], str]:
    """Run the commands side by side; their exit codes and joint log."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
    return [p.returncode for p in procs], log


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{path[:-3]}.{os.getpid()}"
    objs = [f"{stem}.{os.path.basename(src)}.o" for src in sources()]
    nvcc = _nvcc()
    rcs, log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                         for src, obj in zip(sources(), objs)])
    if not any(rcs):
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{stem}.tmp", *objs]
        rcs2, log2 = _run_all([link])
        rcs, log = rcs + rcs2, log + log2
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(path[:-3] + ".log", "w") as f:
        f.write(log)
    if any(rcs):
        raise RuntimeError(f"nvcc failed ({rcs}):\n{log}")
    os.replace(f"{stem}.tmp", path)


def build_log() -> str:
    """The compiler's output (with ptxas register/shared-memory lines) of
    the build behind the current library, or '' if it was not built."""
    log = library_path()[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def stream_args(device) -> tuple[int, int]:
    """(device index, CUDA stream handle) of the current stream on
    `device`: the last two arguments of every entry point."""
    import torch

    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return index, torch.cuda.current_stream(device).cuda_stream


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point returned a cudaError_t other than 0."""
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.kernel_error_string(err).decode()} ({err})")


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
