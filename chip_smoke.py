#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rnn_transducer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--requests 24] [--profile-dir DIR]

Drives the port's main paths at the full width and depth of the libri100
config (4x512 LSTM encoder, 1x512 predictor, joint 512, vocab 1024, bf16)
and of libri100_conformer (8 conformer blocks of d=512, 8 heads, FFN x4,
conv kernel 15, 4x input stacking, the same predictor and joint) with
random weights from --seed, through the entry points a user calls:
serving (BatchingEngine behind http_server, with serve.py's CLI
defaults, and serve.py's CLI itself for the conformer) and training
(init_train_state + make_train_step at bench.py's headline shape, B=32,
T=400, U=40, through the default fused loss, and at U=80 through the
two-pass loss, loss_impl="pallas"; the conformer at bench.py's B=64,
T=400, U=40; the pruned two-pass loss at libri100 with a vocabulary of
8192, U=100, and the alignment-restricted band at U=40; and the training
CLI); int8 serving (serve.py --quantize int8) and the greedy decode in one
program (recognize_greedy_fused).
Phases, in order:

  1. card   require CUDA; print the card's name and power limit
  2. build  build the kernel library from csrc/ with nvcc
  3. kernel each kernel against its plain PyTorch version on the card, at
            the main paths' shapes, in f32 and bf16 (max error, kernel ms
            and plain ms from CUDA events, in turns plain, kernel, kernel,
            plain); lstm_fwd (one persistent launch a layer, with and
            without activations, with its tile, two runs giving identical
            bits, and a line through its time against T: µs a step and
            the fixed cost of a launch) and lstm_bwd (one persistent
            launch a layer, at the
            encoder's and the predictor's training shapes, with its tile,
            its barrier count and cuDNN's backward beside it) and
            joint_bwd run twice must give identical bits, joint_bwd with
            kernel A, kernel B's zb pass and ring kernel and the ordered
            sums timed apart, kernel A's W^T pass and ring kernel apart
            by torch.profiler, and kernel B's ring plan; the
            lattice (alpha, beta and the occupancies) at U+1 = 41 and 81
            with ragged lengths and a zero-frame row; the W8A8 recurrence
            (lstm_int8: one persistent launch a layer, with its tile,
            two runs giving identical bits, one lstm_q_persistent_kernel a
            call by the profiler and its step fit) at the serving shapes
            and at batch tiles of 16 and 32 rows; the fused greedy decode
            (greedy_fused) on one served batch against its plain version
            and the lock-step loop;
            the fused LayerNorm (fused_ln fwd and bwd, act none and silu)
            at the conformer's serving and training rows, N = 1600 and
            6400, D = 512, against the plain LayerNorm and its autograd,
            dg / db identical over two runs; the band joint (band_fused:
            band_fwd, band_bwd_a, band_bwd_b) at the pruned step's band,
            B=32, T'=200, S=8, J=512, V=8192, lp_blank / lp_y / base,
            df / dg_w and dW / db identical over two runs, with the
            forward's and kernel A's W^T pass and main launch and kernel
            B's plan, zb pass and main launch timed apart
  4. e2e    concurrent HTTP /recognize requests; every serving kernel
            must have launched while they were served; the f32 tokens of
            the kernel path and the plain path must be identical
  4b. e2e_int8  the same requests to an engine holding quantize_params:
            the W8A8 kernel launched and lstm_fwd did not; the f32 tokens
            of the kernel path and the plain path identical; a served
            batch's encode runs one lstm_q_persistent_kernel a layer
            (their names and device ms by the profiler)
  4c. fused recognize_greedy_fused on that batch with float and int8
            params: greedy_fused launched; the f32 tokens equal to
            recognize_greedy's
  4d. e2e_conformer  the same requests to an engine on libri100_conformer:
            fused_ln_fwd launched 48 times a batch (6 LNs x 8 blocks),
            lstm_fwd never; the f32 tokens of the kernel path and the
            plain path identical, and recognize_greedy_fused's equal to
            recognize_greedy's; then serve.py's CLI with --config
            libri100_conformer, float and --quantize int8, answering a
            request each
  5. train  training steps: finite loss and grad norm on every step, no
            skipped update, the params move, every training kernel
            launched; ms/step by the slope of bench.py and utt/s; one
            torch.profiler step split by layer, with one lstm_fwd and one
            lstm_bwd kernel per LSTM layer call (every training phase:
            5 of each at libri100) and, in the fused
            steps (this one and the conformer's), K2's kernels A and B
            as their two ring kernels each and no K6 kernel; an f32 loss
            and gradient
            through the kernels against the plain versions; the CLI for
            a few steps with a checkpoint round trip
  5b. train_pallas  the same for loss_impl="pallas" at U=80 (extract_lp,
            assemble_grad and the lattice kernels launched), the same
            batch through the fused route for comparison, and the CLI
            with --loss-impl pallas
  5c. train_conformer  libri100_conformer at B=64, T=400, U=40 through the
            default (fused) loss: 48 fused_ln_bwd launches a step, ms/step
            and utt/s, peak memory, a profiled step, the f32 check of the
            kernels against the plain versions, the CLI for 3 steps
  5d. train_pruned  loss_impl="pruned" at libri100 with V=8192, S=8, B=32,
            T=400, U=100: each K6 kernel once a step, K3 three times, no
            K1 / K2; ms/step, a profiled step (K6-A and K6-B two kernels
            a call each, their tensor-core forms), the full lattice's fused
            step on the same batch for context, the f32 check, the CLI
            with --pruned-range 8 on a JSON config
  5e. train_ar  ar_range 8 (self-aligned) at libri100, B=32, T=400, U=40:
            each K6 kernel once a step, K3 once; ms/step, a profiled step
            (K6-A and K6-B two kernels a call each), the f32 check, the
            CLI with --ar-range 8
  6. the kernels' JSON line (sixteen kernels) (each kernel with its bound, the least time
     the card could take: bytes over 3.35 TB/s or operations over the
     peak for the operands' type, whichever is larger; and the time of one
     PyTorch call computing the same function where there is one), the
     card line, then {"ok": true, ...} last

TF32 is off for matmuls and cuDNN: every float32 product runs in float32.
Any failed check exits non-zero; with no CUDA device it exits before any
result is printed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

from rnn_transducer_tpu_torch.bench_band_bwd_b import step_fit
from rnn_transducer_tpu_torch.decode import greedy_fused as gf
from rnn_transducer_tpu_torch.decode.greedy import greedy_decode, recognize_greedy
from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import (TrainConfig,
                                                    config_libri100,
                                                    config_libri100_conformer)
from rnn_transducer_tpu_torch.ops import fused_ln as fl
from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as jf
from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat
from rnn_transducer_tpu_torch.ops import rnnt_loss as rl
from rnn_transducer_tpu_torch.ops import rnnt_loss_cuda as lc
from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.ops.quant import (quantize_params,
                                                quantize_tensor,
                                                quantized_bytes)
from rnn_transducer_tpu_torch.serve import BatchingEngine, http_server
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tl
from rnn_transducer_tpu_torch.train.__main__ import main as train_cli
from rnn_transducer_tpu_torch.utils import build
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

# serve.py CLI defaults (rnn_transducer_tpu/serve.py and the port's serve.py)
MAX_BATCH, WINDOW_MS, BUCKETS, MAX_SYMBOLS = 8, 5.0, (200, 400, 800), 100
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Kernel-vs-plain shapes: (name, B, T, I, nonzero h0/c0). libri100 at the
# 800- and 400-frame buckets: layer 0 sees T frames of 80 features, layers
# 1-3 see T/2 frames of 1024 (2x frame stacking), H = 512 everywhere.
CASES = (("l0_b800", 8, 800, 80, False), ("l0_b400", 8, 400, 80, False),
         ("l1_b800", 8, 400, 1024, False), ("l1_b400", 8, 200, 1024, False),
         ("ragged_b1", 1, 37, 80, True), ("ragged_b3", 3, 37, 80, True))
MAIN_CASE = ("l0_b800", torch.bfloat16)  # the kernel line's ms / plain_ms
# The training path's shapes: bench.py's headline batch, B=32, T=400
# frames (layer 0), T'=200 after 2x stacking (layers 1-3 and the joint),
# U+1=41, J=512, V=1024; the predictor (E=512) sees U+1=41 steps at the
# libri100 batch and at the conformer's B=64.
TRAIN_B, TRAIN_T, TRAIN_U = 32, 400, 40
TRAIN_LSTM_CASES = (("l0_train", 32, 400, 80, False),
                    ("l1_train", 32, 200, 1024, False),
                    ("pred_b32", 32, 41, 512, False),
                    ("pred_b64", 64, 41, 512, False),
                    ("ragged_b3", 3, 37, 80, True))
TRAIN_MAIN = ("l0_train", torch.bfloat16)
# Backward outputs and gradients: max |kernel - plain| over max |plain|.
# f32: summation order only. bf16: both sides round the same operands, but
# a 1-ulp difference before a rounding can flip one bf16 value (2^-8).
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The f32 training step through the kernels against the plain versions:
# the loss within 1e-5 relative, every gradient leaf within 1e-3 of its
# largest value (400 steps of BPTT and lattice sums in another order).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# The two-pass route's label length: bench.py's batch at the U where the
# JAX package's auto turns from fused to two-pass on the TPU.
PALLAS_U = 80
# Lattice kernel vs plain: alpha and beta on reachable cells within
# 1e-5 max(1, |plain|) (float32 sums of up to T + U terms, in the same
# order on both sides), the occupancies within 1e-5 absolute.
LATTICE_RTOL, OCC_ATOL = 1e-5, 1e-5
SLOPE_STEPS, SLOPE_REPEATS = (3, 8), 2  # bench.py's slope method, shorter
# The W8A8 recurrence against its plain version: (name, B, T, I, nonzero
# h0/c0). libri100 serving at the 800-frame bucket (B = 8: one 8-row batch
# tile, as every served batch), and batch tiles of 32 and 16 rows.
INT8_CASES = (("l0_b800", 8, 800, 80, False), ("l1_b800", 8, 400, 1024, False),
              ("b32_l1", 32, 200, 1024, True),
              ("b16_l1", 16, 200, 1024, True))
INT8_MAIN = ("l0_b800", torch.bfloat16)
# The conformer's training shape: bench.py's B=64, T=400 (T'=100 after 4x
# stacking), U=40. The fused LayerNorm's rows: a served batch of 8 at the
# 800-frame bucket (T'=200) and that training batch, D = 512; 6 LNs in
# each of the 8 blocks.
CONF_B, CONF_T, CONF_U = 64, 400, 40
LN_CASES = (("serve", 8 * 200), ("train", CONF_B * CONF_T // 4))
LN_D, LN_PER_ENCODE = 512, 6 * 8
LN_MAIN = ("train", "none")  # the kernels line's ms / plain_ms / bound
# K8 against the plain LayerNorm and its autograd: y within 1e-5 absolute;
# dx within 1e-5 of its largest value; dg and db, sums over every row in
# another order, within 1e-4 of theirs.
LN_Y_ATOL, LN_DX_RTOL, LN_DGB_RTOL = 1e-5, 1e-5, 1e-4
# The pruned loss's card shape (docs/PERFORMANCE.md:294-298): libri100 with
# a vocabulary of 8192 and a band of S=8 at bench.py's B=32, T=400, U=100;
# and the AR band, libri100 (V=1024) at B=32, T=400, U=40, S=8, centred.
PRUNED_V, PRUNED_S, PRUNED_U = 8192, 8, 100
# band_bwd_b's bf16 time at the pruned band with the 32-column design that
# rebuilt z per tile (H100 80GB HBM3, 700 W): context for the ring design
BWD_B_PREV_MS = 65.826
# band_fwd's bf16 time at the pruned band with the design that staged W by
# thread loads, 32 rows of J a step, and parked the logits in shared memory
# (H100 80GB HBM3, 700 W): context for the W^T ring design
FWD_PREV_MS = 12.072
# band_bwd_a's bf16 time at the pruned band with the design that kept dz in
# shared memory and read W from L2 per 64 rows (H100 80GB HBM3, 700 W):
# context for the W^T ring design
BWD_A_PREV_MS = 27.478
# joint_bwd's kernel A's bf16 time at libri100's joint with the design that
# took a frame tile a block and read W's fragments from L2 (H100 80GB
# HBM3, 700 W): context for its W^T ring design
JOINT_A_PREV_MS = 17.213
# joint_fwd's bf16 time at libri100's joint with the design that staged W
# by thread loads, 32 rows of J a step, and parked the logits in shared
# memory (H100 80GB HBM3, 700 W): context for its W^T ring design
JOINT_FWD_PREV_MS = 4.942
AR_S = 8
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory bytes/s and operations/s by operand type. A bound is the larger of
# the bytes a function must move (inputs read once, outputs written once)
# over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50_000_000
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
                  torch.float16: 989e12, torch.int8: 1979e12}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def max_abs(got, want) -> float:
    return float((got - want).abs().max())


def timed_pair(kernel_fn, plain_fn) -> tuple[float, float]:
    """Mean kernel ms and plain ms from CUDA events, in turns plain,
    kernel, kernel, plain."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(cuda_ms(kernel_fn if which == "kernel"
                                    else plain_fn))
    return statistics.mean(times["kernel"]), statistics.mean(times["plain"])


def nbytes(*tensors) -> int:
    """Bytes of the tensors, nested in tuples and lists; None counts 0."""
    total = 0
    for a in tensors:
        if isinstance(a, (tuple, list)):
            total += nbytes(*a)
        elif isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
    return total


def bound(n_bytes: int, ops: float, dtype) -> dict:
    """The least time the card could take for work that moves n_bytes and
    does `ops` operations on operands of `dtype`, and which of the two
    bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops}


def cudnn_lstm_ms(x, w_ih, w_hh, b, h0, c0) -> dict:
    """torch.nn.LSTM (cuDNN) on the layer's shape: the inference forward
    and the backward (dx, dh0, dc0 and the weight gradients), each the
    median of 5 calls after 2 warm-ups with their min and max, since they
    spread from call to call; the training forward, the mean of 3. cuDNN's
    RNN takes float16 but not
    bfloat16 in PyTorch, so it runs in float16: the same bytes per value
    and the same tensor-core rate as the kernels' bf16. Its forward
    includes the input projection that the kernel leaves to a matmul."""
    dt = torch.float16
    B, _, I = x.shape
    H = w_hh.shape[0]
    lstm = torch.nn.LSTM(I, H, batch_first=True).to(x.device, dt)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    xs = x.to(dt).requires_grad_(True)
    state = (h0[None].to(dt), c0[None].to(dt))
    with torch.no_grad():
        for _ in range(2):  # warm: cuDNN's plan
            lstm(xs, state)
        infer = [cuda_ms(lambda: lstm(xs, state)) for _ in range(5)]
    for _ in range(2):  # warm: the training plan and its reserve space
        out = lstm(xs, state)[0]
    train = statistics.mean(cuda_ms(lambda: lstm(xs, state)) for _ in range(3))
    grad = torch.randn_like(out)
    for _ in range(2):  # warm: the backward's plan
        out.backward(grad, retain_graph=True)
    bwd = [cuda_ms(lambda: out.backward(grad, retain_graph=True))
           for _ in range(5)]
    return {"library_dtype": "float16",
            "bf16_acceptable_to_cudnn": torch.backends.cudnn.is_acceptable(
                x.to(torch.bfloat16)),
            "cudnn_fwd_ms": statistics.median(infer),
            "cudnn_fwd_min_ms": min(infer), "cudnn_fwd_max_ms": max(infer),
            "cudnn_train_fwd_ms": train,
            "cudnn_bwd_ms": statistics.median(bwd),
            "cudnn_bwd_min_ms": min(bwd), "cudnn_bwd_max_ms": max(bwd)}


def reset_counts() -> None:
    lstm_cuda.LAUNCHES = lstm_cuda.LAUNCHES_WITH_ACTS = 0
    lstm_cuda.LAUNCHES_BWD = 0
    jf.LAUNCHES_FWD = jf.LAUNCHES_BWD = 0
    lat.LAUNCHES_ALPHA = lat.LAUNCHES_BETA = 0
    lc.LAUNCHES_EXTRACT = lc.LAUNCHES_GRAD = 0
    q8.LAUNCHES = gf.LAUNCHES = 0
    fl.LAUNCHES_FWD = fl.LAUNCHES_BWD = 0
    bf.LAUNCHES_FWD = bf.LAUNCHES_BWD_A = bf.LAUNCHES_BWD_B = 0


def read_counts() -> dict:
    return {"lstm_fwd": lstm_cuda.LAUNCHES,
            "lstm_fwd_with_acts": lstm_cuda.LAUNCHES_WITH_ACTS,
            "lstm_bwd": lstm_cuda.LAUNCHES_BWD,
            "joint_fwd": jf.LAUNCHES_FWD, "joint_bwd": jf.LAUNCHES_BWD,
            "lattice_alpha": lat.LAUNCHES_ALPHA,
            "lattice_beta": lat.LAUNCHES_BETA,
            "extract_lp": lc.LAUNCHES_EXTRACT,
            "assemble_grad": lc.LAUNCHES_GRAD,
            "lstm_fwd_int8": q8.LAUNCHES, "greedy_fused": gf.LAUNCHES,
            "fused_ln_fwd": fl.LAUNCHES_FWD, "fused_ln_bwd": fl.LAUNCHES_BWD,
            "band_lp_fwd": bf.LAUNCHES_FWD,
            "band_lp_bwd_a": bf.LAUNCHES_BWD_A,
            "band_lp_bwd_b": bf.LAUNCHES_BWD_B}


BAND_KERNELS = ("band_lp_fwd", "band_lp_bwd_a", "band_lp_bwd_b")


def check_no_band(counts: dict, where: str) -> None:
    """K6 belongs to the pruned and AR losses alone."""
    check(all(counts[k] == 0 for k in BAND_KERNELS),
          f"{where} launched a K6 band kernel: "
          f"{ {k: counts[k] for k in BAND_KERNELS} }")


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain version, on the card."""
    with contextlib.ExitStack() as stack:
        for mod, name in ((lstm_cuda, "lstm_recurrence"),
                          (lstm_cuda, "lstm_recurrence_with_acts"),
                          (lstm_cuda, "lstm_recurrence_bwd"),
                          (jf, "joint_lp_fwd"), (jf, "joint_lp_bwd"),
                          (lat, "alpha_wavefront"), (lat, "beta_wavefront"),
                          (lat, "beta_occupancies"), (lc, "extract_lp"),
                          (lc, "assemble_grad"), (q8, "lstm_recurrence_int8"),
                          (gf, "greedy_fused_tokens"), (fl, "fln_fwd"),
                          (fl, "fln_bwd"), (bf, "band_lp_fwd"),
                          (bf, "band_lp_bwd_a"), (bf, "band_lp_bwd_b")):
            stack.enter_context(mock.patch.object(
                mod, name, getattr(mod, name + "_reference")))
        yield


# ------------------------------ phase 3 ----------------------------------

def kernel_vs_plain(rng: np.random.Generator, dev) -> dict:
    H = 512
    rows, worst, main = [], 0.0, None
    for name, B, T, I, with_state in CASES:
        k = 1.0 / np.sqrt(H)
        w_ih = torch.from_numpy(rng.uniform(-k, k, (I, 4 * H))).float().to(dev)
        w_hh = torch.from_numpy(rng.uniform(-k, k, (H, 4 * H))).float().to(dev)
        b = torch.from_numpy(rng.uniform(-2 * k, 2 * k, 4 * H)).float().to(dev)
        x = torch.from_numpy(rng.normal(size=(B, T, I))).float().to(dev)
        h0 = torch.zeros(B, H, device=dev)
        c0 = torch.zeros(B, H, device=dev)
        if with_state:
            h0 = torch.from_numpy(0.5 * rng.normal(size=(B, H))).float().to(dev)
            c0 = torch.from_numpy(rng.normal(size=(B, H))).float().to(dev)
        for cd in (torch.float32, torch.bfloat16):
            x_proj = (_dot(x, w_ih, cd) + b).contiguous()
            w = w_hh.to(cd).contiguous()
            args = (x_proj, w, h0, c0)
            want = lstm_cuda.lstm_recurrence_reference(*args)
            got = lstm_cuda.lstm_recurrence(*args)  # warm: build, caches
            again = lstm_cuda.lstm_recurrence(*args)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in (
                (got[0], want[0]), (got[1][0], want[1][0]),
                (got[1][1], want[1][1])))
            same_bits = (torch.equal(got[0], again[0])
                         and torch.equal(got[1][1], again[1][1]))
            # the same inputs with activations, as a training step runs them
            err_acts = max(max_abs(g, r) for g, r in zip(
                lstm_cuda.lstm_recurrence_with_acts(*args),
                lstm_cuda.lstm_recurrence_with_acts_reference(*args)))
            ok = (bool(torch.isfinite(got[0]).all())
                  and max(err, err_acts) <= ATOL[cd])
            times = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = (lstm_cuda.lstm_recurrence if which == "kernel"
                      else lstm_cuda.lstm_recurrence_reference)
                times[which].append(cuda_ms(lambda: fn(*args)))
            row = {"case": name, "B": B, "T": T, "I": I, "H": H,
                   "dtype": str(cd).replace("torch.", ""),
                   "max_abs_err": err, "atol": ATOL[cd],
                   "with_acts_max_abs_err": err_acts,
                   "kernel_ms": statistics.mean(times["kernel"]),
                   "plain_ms": statistics.mean(times["plain"]),
                   "bitwise_repeat": same_bits,
                   "plan": fwd_plan_row(B, H, cd, dev),
                   **bound(nbytes(args, got[0], got[1][1]),
                           2 * B * T * H * 4 * H, cd)}
            if (name, cd) == MAIN_CASE:
                # the layer as lstm_layer runs it, the input projection
                # included, beside cuDNN's LSTM, which includes it too
                def layer():
                    lstm_cuda.lstm_recurrence(
                        (_dot(x, w_ih, cd) + b).contiguous(), w, h0, c0)
                row["proj_plus_kernel_ms"] = statistics.mean(
                    cuda_ms(layer) for _ in range(2))
                row.update(cudnn_lstm_ms(x, w_ih, w_hh, b, h0, c0))
                row["library_ms"] = row["cudnn_fwd_ms"]
            if name == MAIN_CASE[0]:
                row["step_fit"] = step_fit(device_ms, dev, cd, B, H)
            print("kernel lstm_fwd " + json.dumps(row))
            check(ok, f"lstm_fwd {name} {cd}: max abs err {err} (with "
                      f"activations {err_acts}) > {ATOL[cd]} or non-finite "
                      "output")
            check(same_bits, f"lstm_fwd {name} {cd}: two runs gave "
                             "different bits")
            rows.append(row)
            worst = max(worst, err)
            if (name, cd) == MAIN_CASE:
                main = row
    return {"rows": rows, "max_abs_err": worst, "main": main}


def fwd_plan_row(B: int, H: int, cd, dev) -> dict:
    """K4-fwd's tile on this card: grid, units and rows a block, shared
    bytes, stage passes a step."""
    plan = lstm_cuda.device_fwd_plan(B, H, cd, dev)
    return {"grid": plan.grid, "units": plan.units, "rows": plan.rows,
            "smem_bytes": plan.smem_bytes, "passes": plan.passes}


def lstm_train_vs_plain(rng: np.random.Generator, dev) -> dict:
    """lstm_fwd with activations and lstm_bwd against their plain loops at
    the training path's shapes; lstm_bwd run twice must give identical
    bits. Beside the kernel's time: the kernel with the dW_hh product, as
    LSTMCore.backward runs them (`bwd_with_dw_ms`), and with the input
    projection's gradients too (`bwd_layer_ms`: dx, dW_ih, db), the work
    of cuDNN's backward; the kernel's tile (bwd_plan) and grid barriers."""
    H = 512
    rows, worst, main = [], {"fwd": 0.0, "bwd": 0.0}, None
    for name, B, T, I, with_state in TRAIN_LSTM_CASES:
        k = 1.0 / np.sqrt(H)
        w_ih = torch.from_numpy(rng.uniform(-k, k, (I, 4 * H))).float().to(dev)
        w_hh = torch.from_numpy(rng.uniform(-k, k, (H, 4 * H))).float().to(dev)
        b = torch.from_numpy(rng.uniform(-2 * k, 2 * k, 4 * H)).float().to(dev)
        x = torch.from_numpy(rng.normal(size=(B, T, I))).float().to(dev)
        h0 = torch.zeros(B, H, device=dev)
        c0 = torch.zeros(B, H, device=dev)
        dcT = torch.zeros(B, H, device=dev)  # training: final state unused
        if with_state:
            h0 = torch.from_numpy(0.5 * rng.normal(size=(B, H))).float().to(dev)
            c0 = torch.from_numpy(rng.normal(size=(B, H))).float().to(dev)
            dcT = torch.from_numpy(rng.normal(size=(B, H))).float().to(dev)
        dhs = torch.from_numpy(rng.normal(size=(B, T, H))).float().to(dev)
        for cd in (torch.float32, torch.bfloat16):
            x_proj = (_dot(x, w_ih, cd) + b).contiguous()
            w = w_hh.to(cd).contiguous()
            fwd_args = (x_proj, w, h0, c0)
            want = lstm_cuda.lstm_recurrence_with_acts_reference(*fwd_args)
            got = lstm_cuda.lstm_recurrence_with_acts(*fwd_args)
            fwd_again = lstm_cuda.lstm_recurrence_with_acts(*fwd_args)
            cs_prev = torch.cat([c0[:, None], want[1][:, :-1]], 1)
            bwd_args = (want[2], cs_prev, dhs, dcT, w)
            want_b = lstm_cuda.lstm_recurrence_bwd_reference(*bwd_args)
            got_b = lstm_cuda.lstm_recurrence_bwd(*bwd_args)
            again = lstm_cuda.lstm_recurrence_bwd(*bwd_args)
            torch.cuda.synchronize()
            err_f = max(max_abs(g, r) for g, r in zip(got, want))
            err_b = max(max_abs(g, r) for g, r in zip(got_b, want_b))
            rel_b = max(rel_err(g, r) for g, r in zip(got_b, want_b))
            same_bits = all(torch.equal(g, a) for g, a in zip(got_b, again))
            fwd_same_bits = all(torch.equal(g, a)
                                for g, a in zip(got, fwd_again))
            # the same inputs without activations, as serving runs them
            err_n = max(max_abs(g, r) for g, r in zip(
                leaves(lstm_cuda.lstm_recurrence(*fwd_args)),
                leaves(lstm_cuda.lstm_recurrence_reference(*fwd_args))))
            ok = (all(bool(torch.isfinite(g).all()) for g in got + got_b)
                  and max(err_f, err_n) <= ATOL[cd]
                  and rel_b <= REL_TOL[cd])
            kf, pf = timed_pair(
                lambda: lstm_cuda.lstm_recurrence_with_acts(*fwd_args),
                lambda: lstm_cuda.lstm_recurrence_with_acts_reference(
                    *fwd_args))
            kb, pb = timed_pair(
                lambda: lstm_cuda.lstm_recurrence_bwd(*bwd_args),
                lambda: lstm_cuda.lstm_recurrence_bwd_reference(*bwd_args))
            hs_prev = torch.cat([h0[:, None], want[0][:, :-1]], 1).reshape(
                B * T, H)
            x2 = x.reshape(B * T, I)

            def bwd_with_dw(layer: bool):
                dg = lstm_cuda.lstm_recurrence_bwd(*bwd_args)[0].reshape(
                    B * T, 4 * H)
                _dot(hs_prev.t(), dg, cd)
                if layer:
                    _dot(dg, w_ih.t(), cd)
                    _dot(x2.t(), dg, cd)
                    dg.sum(0)

            with_dw = {k: statistics.median(
                cuda_ms(lambda: bwd_with_dw(k == "layer")) for _ in range(5))
                for k in ("dw", "layer")}
            plan = lstm_cuda.device_bwd_plan(B, H, cd, dev)
            ops = 2 * B * T * H * 4 * H
            row = {"case": name, "B": B, "T": T, "I": I, "H": H,
                   "dtype": str(cd).replace("torch.", ""),
                   "fwd_max_abs_err": err_f, "fwd_atol": ATOL[cd],
                   "fwd_no_acts_max_abs_err": err_n,
                   "bwd_max_abs_err": err_b, "bwd_rel_err": rel_b,
                   "bwd_rtol": REL_TOL[cd], "bwd_bitwise_repeat": same_bits,
                   "fwd_bitwise_repeat": fwd_same_bits,
                   "fwd_kernel_ms": kf, "fwd_plain_ms": pf,
                   "bwd_kernel_ms": kb, "bwd_plain_ms": pb,
                   "fwd_plan": fwd_plan_row(B, H, cd, dev),
                   "bwd_with_dw_ms": with_dw["dw"],
                   "bwd_layer_ms": with_dw["layer"],
                   "bwd_plan": {**dataclasses.asdict(plan),
                                "passes": plan.passes},
                   "bwd_barriers": T,
                   "fwd_bound": bound(nbytes(fwd_args, got), ops, cd),
                   "bwd_bound": bound(nbytes(bwd_args, got_b), ops, cd)}
            if (name, cd) == TRAIN_MAIN:
                row.update(cudnn_lstm_ms(x, w_ih, w_hh, b, h0, c0))
            print("kernel lstm_fwd_with_acts+lstm_bwd " + json.dumps(row))
            check(ok, f"lstm training kernels {name} {cd}: fwd err {err_f} "
                      f"(without activations {err_n}), bwd rel err {rel_b}, "
                      "or non-finite output")
            check(same_bits, f"lstm_bwd {name} {cd}: two runs gave "
                             "different bits")
            check(fwd_same_bits, f"lstm_fwd with activations {name} {cd}: "
                                 "two runs gave different bits")
            rows.append(row)
            worst["fwd"] = max(worst["fwd"], err_f)
            worst["bwd"] = max(worst["bwd"], err_b)
            if (name, cd) == TRAIN_MAIN:
                main = row
    return {"rows": rows, "worst": worst, "main": main}


def joint_vs_plain(rng: np.random.Generator, dev) -> dict:
    """joint_fwd and joint_bwd against their plain versions at the training
    path's joint shape, with ragged frame and label lengths, one
    zero-frame row and the occupancies of the real lattice; each run
    twice must give identical bits, and lp_y must be -1e30 at u = U. The
    forward's W^T pass and ring kernel are timed apart by events, and the
    profiler must see them (bf16) or the CUDA-core kernel (f32) alone."""
    B, T, U, J, V = TRAIN_B, TRAIN_T // 2, TRAIN_U, 512, 1024
    k = 1.0 / np.sqrt(J)
    f = torch.from_numpy(0.5 * rng.normal(size=(B, T, J))).float().to(dev)
    g = torch.from_numpy(0.5 * rng.normal(size=(B, U + 1, J))).float().to(dev)
    w32 = torch.from_numpy(rng.uniform(-k, k, (J, V))).float().to(dev)
    b = torch.from_numpy(rng.uniform(-k, k, V)).float().to(dev)
    labels = torch.from_numpy(rng.integers(1, V, (B, U))).int().to(dev)
    fl = rng.integers(T // 2, T + 1, B)
    ll = rng.integers(U // 2, U + 1, B)
    fl[0], ll[0], fl[1], ll[2] = T, U, 0, 0  # full, zero-frame, no labels
    fl = torch.from_numpy(fl).int().to(dev)
    ll = torch.from_numpy(ll).int().to(dev)
    gbar = torch.full((B,), 1.0 / B, device=dev)  # the batch mean's
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        w = w32.to(cd).contiguous()
        fwd_args = (f, g, labels, w, b)
        want = jf.joint_lp_fwd_reference(*fwd_args)
        got = jf.joint_lp_fwd(*fwd_args)
        again_f = jf.joint_lp_fwd(*fwd_args)
        gb, gy = rl.occupancies_from_lp(want[0], want[1], fl, ll)
        bwd_args = (f, g, labels, w, b, gb, gy, want[2], gbar)
        want_b = jf.joint_lp_bwd_reference(*bwd_args)
        got_b = jf.joint_lp_bwd(*bwd_args)
        again = jf.joint_lp_bwd(*bwd_args)
        torch.cuda.synchronize()
        err_f = max(max_abs(x, y) for x, y in zip(got, want))
        err_b = max(max_abs(x, y) for x, y in zip(got_b, want_b))
        rel_b = {n: rel_err(x, y) for n, x, y in
                 zip(("df", "dg", "dw", "db"), got_b, want_b)}
        same_bits = all(torch.equal(x, y) for x, y in zip(got_b, again))
        same_bits_f = all(torch.equal(x, y) for x, y in zip(got, again_f))
        lp_y_last = bool((got[1][:, :, U] == -1e30).all())
        del again_f
        kf, pf = timed_pair(lambda: jf.joint_lp_fwd(*fwd_args),
                            lambda: jf.joint_lp_fwd_reference(*fwd_args))
        kb, pb = timed_pair(lambda: jf.joint_lp_bwd(*bwd_args),
                            lambda: jf.joint_lp_bwd_reference(*bwd_args))
        # the forward's W^T pass (0 in the CUDA-core form) and its ring or
        # CUDA-core kernel by events, and its kernels by name
        fwd_wt_ms, fwd_main_ms = event_split_ms(
            lambda i, ev: jf.joint_lp_fwd(*fwd_args, events=ev), 3)
        f_split = kernel_ms_by_name(
            lambda: jf.joint_lp_fwd(*fwd_args),
            ("joint_fwd_wt_kernel", "joint_fwd_ring_kernel",
             "joint_fwd_kernel"))
        # kernel A, kernel B's zb pass (0 in the CUDA-core form) and main
        # launch, the ordered sums
        a_ms, zb_ms, main_ms, sums_ms = event_split_ms(
            lambda i, ev: jf.joint_lp_bwd(*bwd_args, events=ev), 5)
        # kernel A's launches apart: the ring's W^T pass and ring kernel,
        # or the CUDA-core kernel
        a_split = kernel_ms_by_name(
            lambda: jf.joint_lp_bwd(*bwd_args),
            ("joint_bwd_a_wt_kernel", "joint_bwd_a_ring_kernel",
             "joint_bwd_a_kernel"))
        ring = bf.tensor_core_form(cd, J, V)
        plan = jf.device_bwd_b_plan(B * T * (U + 1), J, V, dev) if ring \
            else None
        fwd_layout = jf.device_fwd_layout(J, V, dev) if ring else None
        ops = 2 * B * T * (U + 1) * J * V  # one product over the cells
        row = {"B": B, "T": T, "U1": U + 1, "J": J, "V": V,
               "dtype": str(cd).replace("torch.", ""),
               "fwd_max_abs_err": err_f, "fwd_atol": ATOL[cd],
               "fwd_bitwise_repeat": same_bits_f,
               "fwd_lp_y_at_U_is_neg_inf": lp_y_last,
               "bwd_max_abs_err": err_b, "bwd_rel_err": rel_b,
               "bwd_rtol": REL_TOL[cd], "bwd_bitwise_repeat": same_bits,
               "fwd_kernel_ms": kf, "fwd_plain_ms": pf,
               # the forward: its W^T pass and main launch by events, its
               # kernels by the profiler, its layout (None: CUDA-core)
               "fwd_wt_ms": fwd_wt_ms, "fwd_main_ms": fwd_main_ms,
               "fwd_wt_kernel_ms": f_split["joint_fwd_wt_kernel"],
               "fwd_ring_kernel_ms": f_split["joint_fwd_ring_kernel"],
               "fwd_cuda_core_ms": f_split["joint_fwd_kernel"],
               "fwd_prev_ms": (JOINT_FWD_PREV_MS if cd == torch.bfloat16
                               else None),
               "fwd_wt_shape": (list(fwd_layout.wt_shape) if fwd_layout
                                else None),
               "fwd_smem_bytes": (fwd_layout.smem_bytes if fwd_layout
                                  else None),
               "bwd_kernel_ms": kb, "bwd_plain_ms": pb,
               "bwd_a_ms": a_ms, "bwd_b_zb_ms": zb_ms,
               "bwd_b_main_ms": main_ms, "bwd_sums_ms": sums_ms,
               "bwd_a_wt_ms": a_split["joint_bwd_a_wt_kernel"],
               "bwd_a_ring_ms": a_split["joint_bwd_a_ring_kernel"],
               "bwd_a_cuda_core_ms": a_split["joint_bwd_a_kernel"],
               "bwd_a_prev_ms": (JOINT_A_PREV_MS if cd == torch.bfloat16
                                 else None),
               # kernel B: the ring's plan (None: the CUDA-core form,
               # ROW_SPLITS splits of 32 columns)
               "bwd_b_plan": dataclasses.asdict(plan) if plan else None,
               # forward: the logits product; backward: it again, dz and
               # dW; kernel A: the logits again and dz; kernel B: the
               # logits again and dW
               "fwd_bound": bound(nbytes(fwd_args, got), ops, cd),
               "bwd_bound": bound(nbytes(bwd_args, got_b), 3 * ops, cd),
               "bwd_a_bound": bound(nbytes(bwd_args, got_b[:2]), 2 * ops,
                                    cd),
               "bwd_b_bound": bound(nbytes(bwd_args, got_b[2:]), 2 * ops,
                                    cd)}
        print("kernel joint_fwd+joint_bwd " + json.dumps(row))
        check(all(bool(torch.isfinite(x).all()) for x in got_b)
              and err_f <= ATOL[cd] and max(rel_b.values()) <= REL_TOL[cd],
              f"joint kernels {cd}: fwd err {err_f}, bwd rel err {rel_b}")
        check(same_bits, f"joint_bwd {cd}: two runs gave different bits")
        check(same_bits_f, f"joint_fwd {cd}: two runs gave different bits")
        check(lp_y_last, f"joint_fwd {cd}: lp_y at u = U is not -1e30")
        ran = {n: f_split[n] > 0 for n in f_split}
        check(ran == {"joint_fwd_wt_kernel": ring,
                      "joint_fwd_ring_kernel": ring,
                      "joint_fwd_kernel": not ring},
              f"joint_fwd {cd}: the profiler saw {f_split} (ms by kernel)")
        check(float(got_b[0][1].abs().max()) == 0.0,
              "joint_bwd: the zero-frame row has a non-zero gradient")
        out[cd] = row
    return {"rows": out, "main": out[torch.bfloat16],
            "worst_fwd": max(r["fwd_max_abs_err"] for r in out.values()),
            "worst_bwd": max(r["bwd_max_abs_err"] for r in out.values())}


def ragged_lengths(rng: np.random.Generator, dev, B: int, T: int, U: int):
    """Frame and label lengths (B,) int32: row 0 full, row 1 without
    frames, row 2 without labels, the rest from [T/2, T] and [U/2, U]."""
    fl = rng.integers(T // 2, T + 1, B)
    ll = rng.integers(U // 2, U + 1, B)
    fl[0], ll[0], fl[1], ll[2] = T, U, 0, 0
    return (torch.from_numpy(fl).int().to(dev),
            torch.from_numpy(ll).int().to(dev))


def lattice_scores(rng: np.random.Generator, dev, B: int, T: int, U: int):
    """Blank and label log-probs (B, T, U+1) of a random 3-way softmax
    (every path stays alive) and ragged lengths."""
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, T, U + 1, 3))).float().to(dev), dim=-1)
    return (lp[..., 0].contiguous(), lp[..., 1].contiguous(),
            *ragged_lengths(rng, dev, B, T, U))


def lattice_err(got, want) -> tuple[float, float, bool]:
    """Max abs error and max error over max(1, |plain|) on the reachable
    cells; whether every unreachable cell is at or below -1e29."""
    reach = want > -1e29
    d = (got - want).abs()[reach]
    scale = want.abs()[reach].clamp(min=1.0)
    return (float(d.max()), float((d / scale).max()),
            bool((got[~reach] <= -1e29).all()))


def lattice_vs_plain(rng: np.random.Generator, dev) -> dict:
    """lattice_alpha and lattice_beta (with the occupancies) against their
    plain versions at the training step's lattice, T'=200 and U+1 = 41
    (the fused route) and 81 (the two-pass route), ragged lengths and a
    zero-frame row; and the loss through them against the plain path."""
    B, T = TRAIN_B, TRAIN_T // 2
    rows = {}
    for U in (TRAIN_U, PALLAS_U):
        lpb, lpy, fl, ll = lattice_scores(rng, dev, B, T, U)
        lpb_m, lpy_m = rl._masked_transitions(lpb, lpy, fl, ll)
        accept = rl._accept_scores(lpb, fl, ll)
        a_args = (lpb_m, lpy_m)
        want_a = lat.alpha_wavefront_reference(*a_args)
        got_a = lat.alpha_wavefront(*a_args)
        b_args = (lpb_m, lpy_m, accept, want_a, fl)
        want_b = lat.beta_occupancies_reference(*b_args)
        got_b = lat.beta_occupancies(*b_args)
        loss_k = rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)[0]
        with plain_kernels():
            loss_p = rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)[0]
        torch.cuda.synchronize()
        err_a, rel_a, unreach_a = lattice_err(got_a, want_a)
        err_b, rel_b, unreach_b = lattice_err(got_b[0], want_b[0])
        err_occ = max(max_abs(got_b[1], want_b[1]),
                      max_abs(got_b[2], want_b[2]))
        loss_rel = rel_err(loss_k, loss_p)
        ka, pa = timed_pair(lambda: lat.alpha_wavefront(*a_args),
                            lambda: lat.alpha_wavefront_reference(*a_args))
        kb, pb = timed_pair(lambda: lat.beta_occupancies(*b_args),
                            lambda: lat.beta_occupancies_reference(*b_args))
        row = {"B": B, "T": T, "U1": U + 1,
               "alpha_max_abs_err": err_a, "alpha_rel_err": rel_a,
               "beta_max_abs_err": err_b, "beta_rel_err": rel_b,
               "rtol": LATTICE_RTOL, "occ_max_abs_err": err_occ,
               "occ_atol": OCC_ATOL, "loss_rel_err": loss_rel,
               "loss_rtol": LOSS_RTOL, "alpha_kernel_ms": ka,
               "alpha_plain_ms": pa, "beta_kernel_ms": kb,
               "beta_plain_ms": pb,
               # a log-add-exp of two terms per cell: ~8 operations; beta
               # adds the two occupancies
               "alpha_bound": bound(nbytes(a_args, got_a),
                                    8 * B * T * (U + 1), torch.float32),
               "beta_bound": bound(nbytes(b_args, got_b),
                                   16 * B * T * (U + 1), torch.float32)}
        print("kernel lattice " + json.dumps(row))
        check(rel_a <= LATTICE_RTOL and rel_b <= LATTICE_RTOL,
              f"lattice U+1={U + 1}: alpha rel err {rel_a}, beta {rel_b}")
        check(unreach_a and unreach_b,
              f"lattice U+1={U + 1}: an unreachable cell above -1e29")
        check(err_occ <= OCC_ATOL and loss_rel <= LOSS_RTOL,
              f"lattice U+1={U + 1}: occupancy err {err_occ}, loss rel "
              f"err {loss_rel}")
        check(not got_b[1][1].any() and not got_b[2][1].any(),
              "lattice_beta: the zero-frame row has occupancies")
        rows[U] = row
    return {"rows": rows, "main": rows[TRAIN_U],
            "worst_alpha": max(r["alpha_max_abs_err"] for r in rows.values()),
            "worst_beta": max(r["beta_max_abs_err"] for r in rows.values())}


def loss_rows_vs_plain(rng: np.random.Generator, dev) -> dict:
    """extract_lp and assemble_grad against their plain versions at the
    two-pass step's logits, (32, 200, 81, 1024) in f32 and bf16, with the
    occupancies of the real lattice scaled by the batch mean's 1/B."""
    B, T, U, V = TRAIN_B, TRAIN_T // 2, PALLAS_U, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    x32 = 2.0 * torch.randn(B, T, U + 1, V, generator=gen, device=dev)
    labels = torch.randint(1, V, (B, U), generator=gen, device=dev,
                           dtype=torch.int32)
    fl, ll = ragged_lengths(rng, dev, B, T, U)
    gb, gy = rl.occupancies_from_lp(*lc.extract_lp_reference(x32, labels),
                                    fl, ll)
    occ, gb, gy = ((gb + gy) / B, gb / B, gy / B)
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        x = x32.to(cd)
        want = lc.extract_lp_reference(x, labels)
        got = lc.extract_lp(x, labels)
        live = [w > -1e29 for w in want]
        rel_x = max(rel_err(g[m], w[m]) for g, w, m in zip(got, want, live))
        err_x = max(max_abs(g[m], w[m]) for g, w, m in zip(got, want, live))
        same_dead = all(torch.equal(g[~m], w[~m])
                        for g, w, m in zip(got, want, live))
        g_args = (x, labels, occ, gb, gy)
        want_g = lc.assemble_grad_reference(*g_args)
        got_g = lc.assemble_grad(*g_args)
        torch.cuda.synchronize()
        rel_g = rel_err(got_g.float(), want_g.float())
        err_g = max_abs(got_g.float(), want_g.float())
        finite = bool(torch.isfinite(got_g).all())
        # max, exp and sum per logit; the gradient one exp, two products
        bounds = {"extract_bound": bound(nbytes(x, labels, got),
                                         4 * x.numel(), torch.float32),
                  "grad_bound": bound(nbytes(g_args, got_g), 5 * x.numel(),
                                      torch.float32)}
        del want_g, got_g
        kx, px = timed_pair(lambda: lc.extract_lp(x, labels),
                            lambda: lc.extract_lp_reference(x, labels))
        kg, pg = timed_pair(lambda: lc.assemble_grad(*g_args),
                            lambda: lc.assemble_grad_reference(*g_args))
        row = {"B": B, "T": T, "U1": U + 1, "V": V,
               "dtype": str(cd).replace("torch.", ""),
               "extract_max_abs_err": err_x, "extract_rel_err": rel_x,
               "grad_max_abs_err": err_g, "grad_rel_err": rel_g,
               "rtol": REL_TOL[cd], "extract_kernel_ms": kx,
               "extract_plain_ms": px, "grad_kernel_ms": kg,
               "grad_plain_ms": pg, **bounds}
        print("kernel loss_rows " + json.dumps(row))
        check(rel_x <= REL_TOL[cd] and rel_g <= REL_TOL[cd] and finite,
              f"loss rows {cd}: extract rel err {rel_x}, grad rel err "
              f"{rel_g}, or a non-finite gradient")
        check(same_dead, f"extract_lp {cd}: lp_y at u = U is not NEG_INF")
        out[cd] = row
        del x
    return {"rows": out, "main": out[torch.float32],
            "worst_extract": max(r["extract_max_abs_err"]
                                 for r in out.values()),
            "worst_grad": max(r["grad_max_abs_err"] for r in out.values())}


def int8_plan_row(B: int, H: int, dev) -> list:
    """K7's launches on this card: each group's rows and tile (grid,
    units and rows a block, shared bytes, stage passes a step)."""
    return [{"rows": [b0, b1], "grid": plan.grid, "units": plan.units,
             "block_rows": plan.rows, "smem_bytes": plan.smem_bytes,
             "passes": plan.passes}
            for b0, b1, plan in q8.device_groups(B, H, dev)]


def kernel_launches(call, fragment: str) -> dict:
    """The device kernels of one call(), by torch.profiler: launches by
    name, of those whose name holds `fragment`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profiler_window()
        call()
        torch.cuda.synchronize()
        pad_profiler_window()
    counts = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and fragment in evt.key:
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    return counts


def lstm_int8_vs_plain(rng: np.random.Generator, dev) -> dict:
    """lstm_fwd_q (K7) against its plain version: the libri100 serving
    layers at the 800-frame bucket and batch tiles of 32 and 16 rows, in
    f32 and bf16, on int8 weights from quantize_tensor; two runs giving
    identical bits, one lstm_q_persistent_kernel a call by the profiler
    and no other kernel of lstm_fwd_q.cu, the tile, and at the serving
    shape a line through K7's time against T (µs a step, the fixed cost
    of a call)."""
    H = 512
    rows, worst, main = [], 0.0, None
    for name, B, T, I, with_state in INT8_CASES:
        k = 1.0 / np.sqrt(H)
        w_ih = torch.from_numpy(rng.uniform(-k, k, (I, 4 * H))).float().to(dev)
        qw = quantize_tensor(torch.from_numpy(
            rng.uniform(-k, k, (H, 4 * H))).float().to(dev))
        b = torch.from_numpy(rng.uniform(-2 * k, 2 * k, 4 * H)).float().to(dev)
        x = torch.from_numpy(rng.normal(size=(B, T, I))).float().to(dev)
        h0 = torch.zeros(B, H, device=dev)
        c0 = torch.zeros(B, H, device=dev)
        if with_state:
            h0 = torch.from_numpy(0.5 * rng.normal(size=(B, H))).float().to(dev)
            c0 = torch.from_numpy(rng.normal(size=(B, H))).float().to(dev)
        for cd in (torch.float32, torch.bfloat16):
            x_proj = (_dot(x, w_ih, cd) + b).to(cd).contiguous()
            args = (x_proj, qw.q, qw.scale, h0, c0)
            want = q8.lstm_recurrence_int8_reference(*args)
            got = q8.lstm_recurrence_int8(*args)
            again = q8.lstm_recurrence_int8(*args)
            torch.cuda.synchronize()
            err = max(max_abs(got[0], want[0]), max_abs(got[1][1], want[1][1]))
            same_bits = (torch.equal(got[0], again[0])
                         and torch.equal(got[1][1], again[1][1]))
            kernels = kernel_launches(lambda: q8.lstm_recurrence_int8(*args),
                                      "lstm_q")
            plan = int8_plan_row(B, H, dev)
            kt, pt = timed_pair(lambda: q8.lstm_recurrence_int8(*args),
                                lambda: q8.lstm_recurrence_int8_reference(
                                    *args))
            row = {"case": name, "B": B, "T": T, "I": I, "H": H,
                   "batch_tile": q8.batch_tile(B, H),
                   "dtype": str(cd).replace("torch.", ""),
                   "max_abs_err": err, "atol": ATOL[cd], "kernel_ms": kt,
                   "plain_ms": pt, "bitwise_repeat": same_bits,
                   "kernels": kernels, "plan": plan,
                   **bound(nbytes(args, got[0], got[1][1]),
                           2 * B * T * H * 4 * H, torch.int8)}
            if name == INT8_MAIN[0]:
                row["step_fit"] = step_fit(device_ms, dev, cd, B, H,
                                           int8=True)
            print("kernel lstm_int8 " + json.dumps(row))
            check(bool(torch.isfinite(got[0]).all()) and err <= ATOL[cd],
                  f"lstm_int8 {name} {cd}: max abs err {err} > {ATOL[cd]} "
                  "or non-finite output")
            check(same_bits, f"lstm_int8 {name} {cd}: two runs gave "
                             "different bits")
            check(bool(kernels) and all("lstm_q_persistent_kernel" in k
                                        for k in kernels)
                  and sum(kernels.values()) == len(plan),
                  f"lstm_int8 {name} {cd}: a call ran {kernels}, not one "
                  f"lstm_q_persistent_kernel for each of its {len(plan)} "
                  "groups")
            rows.append(row)
            worst = max(worst, err)
            if (name, cd) == INT8_MAIN:
                main = row
    return {"rows": rows, "max_abs_err": worst, "main": main}


def greedy_fused_vs_plain(serving: dict, dev) -> dict:
    """greedy_fused (K9) against its plain version on one served batch (the
    first max_batch utterances at the 800-frame bucket, max_symbols 100),
    in f32 (identical tokens and steps) and bf16 (agreement reported), and
    the lock-step greedy_decode on the same encoder output."""
    cfg, params = serving["cfg"], serving["params"]
    feats, lens = served_batch(serving, dev)
    rows = {}
    for cd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        with torch.inference_mode():
            enc, enc_lens = m.encode(params, c, feats, lens)
            f, flens, weights = gf.fused_inputs(params, c, enc, enc_lens)
            args = (f, flens, weights, MAX_SYMBOLS, cfg.blank, c.cdtype)
            got = gf.greedy_fused_tokens(*args)
            want = gf.greedy_fused_tokens_reference(*args)
            torch.cuda.synchronize()
            kt, pt = timed_pair(lambda: gf.greedy_fused_tokens(*args),
                                lambda: gf.greedy_fused_tokens_reference(
                                    *args))
            lockstep = statistics.mean(
                cuda_ms(lambda: greedy_decode(params, c, enc, enc_lens,
                                              MAX_SYMBOLS)) for _ in range(2))
        E, H = weights[0].shape[1], weights[2].shape[0]
        J, V = f.shape[2], weights[0].shape[0]
        n_tok = int((got[0] != cfg.blank).sum())
        n_steps = int(got[1].sum())
        # each step the joint's output product; each emission (and the
        # start symbol) the predictor cell and its projection
        ops = (2 * n_steps * J * V
               + 2 * (n_tok + f.shape[0]) * ((E + H) * 4 * H + H * J))
        row = {"dtype": cd, "B": f.shape[0], "T": f.shape[1], "J": J,
               "V": V, "max_symbols": MAX_SYMBOLS,
               "tokens_identical": torch.equal(got[0], want[0]),
               "steps_identical": torch.equal(got[1], want[1]),
               "row_agreement": float((got[0] == want[0]).all(1).float()
                                      .mean()),
               "max_abs_err": float((got[0] - want[0]).abs().max()),
               "tokens": n_tok, "steps": n_steps, "kernel_ms": kt,
               "plain_ms": pt, "lockstep_ms": lockstep,
               **bound(nbytes(args[:3], got), ops, torch.float32)}
        print("kernel greedy_fused " + json.dumps(row))
        if cd == "float32":
            check(row["tokens_identical"] and row["steps_identical"],
                  "greedy_fused f32: tokens or steps differ from the plain "
                  "version")
        rows[cd] = row
    return {"rows": rows, "main": rows["bfloat16"],
            "max_abs_err": rows["float32"]["max_abs_err"]}


def cycled(fn, n: int):
    """A call of fn(i) for i = 0, 1, ..., n-1, 0, 1, ... in turn."""
    count = itertools.count()
    return lambda: fn(next(count) % n)


def mean_ms(fn, reps: int = 20) -> float:
    """CUDA-event ms of one call, over `reps` calls back to back: the
    host's enqueue included where it is slower than the device."""
    return cuda_ms(lambda: [fn() for _ in range(reps)]) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device ms of one call: the `reps` calls are queued behind a spin
    kernel of ~0.1 s (longer than their enqueue), so the events bracket
    the device's work alone."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_ln_vs_plain(rng: np.random.Generator, dev) -> dict:
    """fused_ln_fwd and fused_ln_bwd (K8) against the plain LayerNorm
    (`layer_norm_reference`) and its autograd at the conformer's rows, act
    none and silu; dg and db identical over two runs. Times: the device's
    ms per call (`device_ms`) and the ms per call with the host's enqueue
    (`mean_ms`, "call"), 20 calls each, in turns plain, kernel, kernel,
    plain. Library:
    F.layer_norm and its backward (one native_layer_norm_backward gives
    dx, dg and db); silu has no single PyTorch call."""
    D = LN_D
    rows, main = [], None
    worst = {"fwd": 0.0, "bwd": 0.0}
    for case, N in LN_CASES:
        x = torch.from_numpy(3 * rng.normal(size=(N, D)) + 1).float().to(dev)
        g = torch.from_numpy(1 + 0.5 * rng.normal(size=D)).float().to(dev)
        b = torch.from_numpy(0.5 * rng.normal(size=D)).float().to(dev)
        dy = torch.from_numpy(rng.normal(size=(N, D))).float().to(dev)
        for act in fl.ACTS:
            y, mu, rstd = fl.fln_fwd(x, g, b, act)
            bwd_args = (x, g, b, mu, rstd, dy, act)
            got = fl.fln_bwd(*bwd_args)
            again = fl.fln_bwd(*bwd_args)
            leaves_ = [a.clone().requires_grad_(True) for a in (x, g, b)]
            ref = fl.layer_norm_reference(*leaves_, act)
            want = torch.autograd.grad(ref, leaves_, dy)
            torch.cuda.synchronize()
            err_y = max_abs(y, ref.detach())
            err_b = max(max_abs(a, e) for a, e in zip(got, want))
            rel = {n: rel_err(a, e) for n, a, e in zip(("dx", "dg", "db"),
                                                       got, want)}
            same_bits = all(torch.equal(a, e) for a, e in zip(again, got))
            finite = all(bool(torch.isfinite(a).all()) for a in (y, *got))

            # Device times read their inputs from device memory, not L2:
            # the calls cycle through copies of x and dy (with a graph
            # each for the autograd backwards) three times the L2's size.
            n_cp = max(2, -(-3 * L2_BYTES // nbytes(x)))
            xs = [x.clone() for _ in range(n_cp)]
            dys = [dy.clone() for _ in range(n_cp)]

            def graphs(fn):
                out = []
                for xc in xs:
                    lv = [a.clone().requires_grad_(True) for a in (xc, g, b)]
                    out.append((fn(*lv), lv))
                return out

            def autograd_bwd(gr):
                return lambda i: torch.autograd.grad(gr[i][0], gr[i][1],
                                                     dys[i],
                                                     retain_graph=True)

            ref_graphs = graphs(lambda *a: fl.layer_norm_reference(*a, act))
            fns = {"kernel": (
                       lambda i: fl.fln_fwd(xs[i], g, b, act),
                       lambda i: fl.fln_bwd(xs[i], g, b, mu, rstd, dys[i],
                                            act)),
                   "plain": (
                       lambda i: fl.layer_norm_reference(xs[i], g, b, act),
                       autograd_bwd(ref_graphs))}
            times = {}
            for which in ("plain", "kernel", "kernel", "plain"):
                fwd, bwd = fns[which]
                times.setdefault(which, []).append(
                    (device_ms(cycled(fwd, n_cp)),
                     device_ms(cycled(bwd, n_cp))))
            k_f, k_b = (statistics.mean(t[i] for t in times["kernel"])
                        for i in (0, 1))
            p_f, p_b = (statistics.mean(t[i] for t in times["plain"])
                        for i in (0, 1))
            # with the host's enqueue, back to back on one input
            kc_f, kc_b, pc_f, pc_b = (mean_ms(cycled(fn, 1)) for fn in
                                      (*fns["kernel"], *fns["plain"]))
            lib_f = lib_b = None
            if act == "none":
                lib_graphs = graphs(lambda *a: torch.nn.functional.layer_norm(
                    a[0], (D,), a[1], a[2], fl.EPS))
                lib_f = device_ms(cycled(
                    lambda i: torch.nn.functional.layer_norm(
                        xs[i], (D,), g, b, fl.EPS), n_cp))
                lib_b = device_ms(cycled(autograd_bwd(lib_graphs), n_cp))
                del lib_graphs
            del xs, dys, ref_graphs
            silu = act == "silu"
            row = {"case": case, "N": N, "D": D, "act": act,
                   "y_max_abs_err": err_y, "y_atol": LN_Y_ATOL,
                   "bwd_max_abs_err": err_b, "bwd_rel_err": rel,
                   "dx_rtol": LN_DX_RTOL, "dg_db_rtol": LN_DGB_RTOL,
                   "bwd_bitwise_repeat": same_bits,
                   "fwd_kernel_ms": k_f, "fwd_plain_ms": p_f,
                   "fwd_library_ms": lib_f, "bwd_kernel_ms": k_b,
                   "bwd_plain_ms": p_b, "bwd_library_ms": lib_b,
                   "fwd_kernel_call_ms": kc_f, "fwd_plain_call_ms": pc_f,
                   "bwd_kernel_call_ms": kc_b, "bwd_plain_call_ms": pc_b,
                   # per element: centre, square, sum, scale, g, b (+ the
                   # sigmoid and product of silu); the backward twice that
                   "fwd_bound": bound(nbytes(x, g, b, y, mu, rstd),
                                      (12 if silu else 8) * N * D,
                                      torch.float32),
                   "bwd_bound": bound(nbytes(bwd_args[:6], got),
                                      (22 if silu else 14) * N * D,
                                      torch.float32)}
            print("kernel fused_ln " + json.dumps(row))
            check(finite and err_y <= LN_Y_ATOL
                  and rel["dx"] <= LN_DX_RTOL
                  and max(rel["dg"], rel["db"]) <= LN_DGB_RTOL,
                  f"fused_ln {case} {act}: y err {err_y}, bwd rel err {rel} "
                  "or a non-finite output")
            check(same_bits, f"fused_ln_bwd {case} {act}: two runs gave "
                             "different bits")
            rows.append(row)
            worst["fwd"] = max(worst["fwd"], err_y)
            worst["bwd"] = max(worst["bwd"], err_b)
            if (case, act) == LN_MAIN:
                main = row
    return {"rows": rows, "main": main, "worst": worst}


def event_split_ms(call, n_events: int, reps: int = 5) -> list[float]:
    """Mean device ms between consecutive events of call(i, events), each
    call recording `n_events` CUDA events between its launches, the `reps`
    calls queued behind a spin kernel as in device_ms."""
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(n_events)]
           for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for i, ev in enumerate(evs):
        call(i, ev)
    torch.cuda.synchronize()
    return [statistics.mean(e[k].elapsed_time(e[k + 1]) for e in evs)
            for k in range(n_events - 1)]


def kernel_ms_by_name(call, names, reps: int = 3) -> dict:
    """Device ms a call of the kernels whose names hold each of `names`,
    by torch.profiler over `reps` calls after a warm one, the window
    padded at both ends (pad_profiler_window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profiler_window()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        pad_profiler_window()
    ms = {n: 0.0 for n in names}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if n in evt.key:
                ms[n] += getattr(evt, "self_device_time_total", getattr(
                    evt, "self_cuda_time_total", 0)) / 1e3 / reps
    return ms


def band_split_ms(call, n: int, reps: int = 5) -> tuple[float, float]:
    """Device ms of a band call's first pass (band_lp_fwd's and
    band_lp_bwd_a's W^T pass, band_lp_bwd_b's zb pass) and of its main
    launch (with the ordered sums), each call(i, events) on copy i % n
    recording three CUDA events around its two launches."""
    first_ms, main_ms = event_split_ms(lambda i, ev: call(i % n, ev), 3,
                                       reps)
    return first_ms, main_ms


def band_fused_vs_plain(rng: np.random.Generator, dev) -> dict:
    """band_fwd, band_bwd_a and band_bwd_b (K6) against their plain versions
    at the pruned step's band, B=32, T'=200, S=8, J=512, V=8192, in f32 and
    bf16; lp_blank, lp_y, base, df, dg_w, dW and db identical over two
    runs. Times as
    fused_ln_vs_plain:
    device ms per call behind a spin kernel, the calls cycling through
    copies of g_w (105 MB, twice the L2 alone) three times the L2's size,
    in turns plain, kernel, kernel, plain. No single PyTorch call computes
    the band joint with its log-softmax picks: library_ms is null, and the
    full lattice's K1 / K2 at the same batch (the train_pruned phase) is
    the comparison."""
    B, T, S, J, V = TRAIN_B, TRAIN_T // 2, PRUNED_S, 512, PRUNED_V
    k = 1.0 / np.sqrt(J)
    f = torch.from_numpy(0.5 * rng.normal(size=(B, T, J))).float().to(dev)
    g_w = torch.from_numpy(0.5 * rng.normal(size=(B, T, S, J))).float().to(
        dev)
    w32 = torch.from_numpy(rng.uniform(-k, k, (J, V))).float().to(dev)
    b = torch.from_numpy(rng.uniform(-k, k, V)).float().to(dev)
    lab_w = torch.from_numpy(rng.integers(1, V, (B, T, S))).int().to(dev)
    lab_w[:, :, -1] = 0  # the last row of a band at u = U: the blank id
    # the loss's cotangents: minus the batch mean's share of occupancies
    cb = torch.from_numpy(-rng.uniform(0, 1, (B, T, S)) / B).float().to(dev)
    cy = torch.from_numpy(-rng.uniform(0, 1, (B, T, S)) / B).float().to(dev)
    n_cp = max(2, -(-3 * L2_BYTES // nbytes(g_w)))
    gws = [g_w.clone() for _ in range(n_cp)]
    N = B * T * S
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        w = w32.to(cd).contiguous()
        fwd_args = (f, g_w, lab_w, w, b)
        want = bf.band_lp_fwd_reference(*fwd_args)
        got = bf.band_lp_fwd(*fwd_args)
        again_f = bf.band_lp_fwd(*fwd_args)
        bwd_args = (f, g_w, lab_w, w, b, want[2], cb, cy)
        got_a = bf.band_lp_bwd_a(*bwd_args)
        again_a = bf.band_lp_bwd_a(*bwd_args)
        got_b = bf.band_lp_bwd_b(*bwd_args)
        again = bf.band_lp_bwd_b(*bwd_args)
        want_a = bf.band_lp_bwd_a_reference(*bwd_args)
        want_b = bf.band_lp_bwd_b_reference(*bwd_args)
        torch.cuda.synchronize()
        err_f = max(max_abs(x, y) for x, y in zip(got, want))
        err_a = max(max_abs(x, y) for x, y in zip(got_a, want_a))
        err_b = max(max_abs(x, y) for x, y in zip(got_b, want_b))
        rel = {n: rel_err(x, y) for n, x, y in
               zip(("df", "dg_w", "dw", "db"), got_a + got_b,
                   want_a + want_b)}
        same_bits = all(torch.equal(x, y) for x, y in zip(got_b, again))
        same_bits_a = all(torch.equal(x, y) for x, y in zip(got_a, again_a))
        same_bits_f = all(torch.equal(x, y) for x, y in zip(got, again_f))
        finite = all(bool(torch.isfinite(x).all())
                     for x in (*got, *got_a, *got_b))
        del want_a, want_b, again_f
        base = want[2]

        def call_args(kind, i):
            """The arguments of a forward or backward call on copy i."""
            a = (f, gws[i], lab_w, w, b)
            return a if kind == "fwd" else a + (base, cb, cy)

        calls = {"kernel": (bf.band_lp_fwd, bf.band_lp_bwd_a,
                            bf.band_lp_bwd_b),
                 "plain": (bf.band_lp_fwd_reference,
                           bf.band_lp_bwd_a_reference,
                           bf.band_lp_bwd_b_reference)}
        times = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            fw, ba, bb = calls[which]
            times.setdefault(which, []).append(tuple(
                device_ms(cycled(lambda i, c=c, kind=kind: c(
                    *call_args(kind, i)), n_cp), reps=5)
                for c, kind in ((fw, "fwd"), (ba, "bwd"), (bb, "bwd"))))
        kt = [statistics.mean(t[i] for t in times["kernel"]) for i in range(3)]
        pt = [statistics.mean(t[i] for t in times["plain"]) for i in range(3)]
        fwd_wt_ms, fwd_main_ms = band_split_ms(
            lambda i, ev: bf.band_lp_fwd(*call_args("fwd", i), events=ev),
            n_cp)
        wt_ms, a_main_ms = band_split_ms(
            lambda i, ev: bf.band_lp_bwd_a(*call_args("bwd", i), events=ev),
            n_cp)
        zb_ms, main_ms = band_split_ms(
            lambda i, ev: bf.band_lp_bwd_b(*call_args("bwd", i), events=ev),
            n_cp)
        ring = bf.tensor_core_form(cd, J, V)
        plan = bf.device_bwd_b_plan(N, J, V, dev) if ring else None
        layout = bf.device_bwd_a_layout(J, V, dev) if ring else None
        fwd_layout = bf.device_fwd_layout(J, V, dev) if ring else None
        ops = 2 * N * J * V  # one product over the band
        row = {"B": B, "T": T, "S": S, "J": J, "V": V, "rows": N,
               "dtype": str(cd).replace("torch.", ""),
               "fwd_max_abs_err": err_f, "fwd_atol": ATOL[cd],
               "bwd_a_max_abs_err": err_a, "bwd_b_max_abs_err": err_b,
               "bwd_rel_err": rel, "bwd_rtol": REL_TOL[cd],
               "fwd_bitwise_repeat": same_bits_f,
               "bwd_a_bitwise_repeat": same_bits_a,
               "bwd_b_bitwise_repeat": same_bits,
               "fwd_kernel_ms": kt[0], "fwd_plain_ms": pt[0],
               "bwd_a_kernel_ms": kt[1], "bwd_a_plain_ms": pt[1],
               "bwd_b_kernel_ms": kt[2], "bwd_b_plain_ms": pt[2],
               # the forward: its W^T pass and ring kernel apart (the
               # CUDA-core form: 0 and the kernel), its layout
               "fwd_wt_ms": fwd_wt_ms, "fwd_main_ms": fwd_main_ms,
               "fwd_prev_ms": (FWD_PREV_MS if cd == torch.bfloat16
                               else None),
               "fwd_wt_shape": (list(fwd_layout.wt_shape) if fwd_layout
                                else None),
               "fwd_smem_bytes": (fwd_layout.smem_bytes if fwd_layout
                                  else None),
               # kernel A: its W^T pass and main launch (with the df sum)
               # apart, the tensor-core form's scratch and shared bytes
               "bwd_a_wt_ms": wt_ms, "bwd_a_main_ms": a_main_ms,
               "bwd_a_prev_ms": (BWD_A_PREV_MS if cd == torch.bfloat16
                                 else None),
               "bwd_a_wt_shape": list(layout.wt_shape) if layout else None,
               "bwd_a_smem_bytes": layout.smem_bytes if layout else None,
               # kernel B: the tensor-core form's plan (the CUDA-core
               # form's splits for f32), its zb pass and main launch apart
               "bwd_b_v_tile": plan.v_tile if plan else bf.V_TILE_B,
               "bwd_b_splits": plan.splits if plan else bf.row_splits(V),
               "bwd_b_grid": list(plan.grid) if plan else None,
               "bwd_b_smem_bytes": plan.smem_bytes if plan else None,
               "bwd_b_zb_ms": zb_ms, "bwd_b_main_ms": main_ms,
               "bwd_b_prev_ms": (BWD_B_PREV_MS if cd == torch.bfloat16
                                 else None),
               # forward: the logits product; A: it again and dz; B: it
               # again and dW
               "fwd_bound": bound(nbytes(fwd_args, got), ops, cd),
               "bwd_a_bound": bound(nbytes(bwd_args, got_a), 2 * ops, cd),
               "bwd_b_bound": bound(nbytes(bwd_args, got_b), 2 * ops, cd)}
        print("kernel band_fused " + json.dumps(row))
        check(finite and err_f <= ATOL[cd] and max(rel.values()) <= REL_TOL[cd],
              f"band kernels {cd}: fwd err {err_f}, bwd rel err {rel}, or a "
              "non-finite output")
        check(same_bits_f, f"band_fwd {cd}: two runs gave different bits")
        check(same_bits_a, f"band_bwd_a {cd}: two runs gave different bits")
        check(same_bits, f"band_bwd_b {cd}: two runs gave different bits")
        out[cd] = row
        del got, got_a, again_a, got_b, again, want, base
        torch.cuda.empty_cache()
    del gws
    torch.cuda.empty_cache()
    return {"rows": out, "main": out[torch.bfloat16],
            "worst": {k: max(r[f"{k}_max_abs_err"] for r in out.values())
                      for k in ("fwd", "bwd_a", "bwd_b")}}


# ------------------------------ phase 4 ----------------------------------

def blank_offset(params, cfg, dev, rng) -> float:
    """Blank-bias offset for the random model. Its joint logits barely
    depend on the frame (a random encoder's output is small), so the
    offset is set from the data: it leaves blank 0.1 below the best other
    token at the start symbol (median over frames), so each utterance
    emits a few tokens on its first frames and then walks the rest of its
    frames on blank. The 0.1 margin keeps the decisions clear of ties."""
    feats = torch.from_numpy(rng.normal(size=(4, 200, cfg.input_dim))
                             ).float().to(dev)
    lens = torch.full((4,), 200, dtype=torch.int32, device=dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        enc, _ = m.encode(params, f32, feats, lens)
        pred, _ = m.predict_step(params, f32,
                                 torch.full((4,), cfg.blank, device=dev),
                                 m.init_pred_state(f32, 4, dev))
        logits = m.joint_step(params, f32, enc.reshape(-1, enc.shape[-1]),
                              pred.repeat_interleave(enc.shape[1], 0))
    others = torch.cat([logits[:, :cfg.blank], logits[:, cfg.blank + 1:]], 1)
    gap = logits[:, cfg.blank] - others.max(dim=1).values
    return float(-gap.median()) - 0.1


def post(url: str, body: dict) -> tuple[int, dict, float]:
    data = json.dumps(body).encode()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            url, data=data, method="POST"), timeout=300) as r:
        out = json.loads(r.read())
        return r.status, out, time.perf_counter() - t0


def serve_requests(engine, utts) -> list[tuple[int, dict, float]]:
    srv = http_server("127.0.0.1", 0, engine)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/recognize"
    try:
        with concurrent.futures.ThreadPoolExecutor(len(utts)) as ex:
            futs = [ex.submit(post, url, {"feats": u.tolist()})
                    for u in utts]
            return [f.result() for f in futs]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


def decode_batch(params, cfg, feats, lens, plain: bool):
    """recognize_greedy + the encoder output, through the kernel or, with
    plain=True, through the plain recurrence (on the same card)."""
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx, torch.inference_mode():
        enc, _ = m.encode(params, cfg, feats, lens)
        tok, n = recognize_greedy(params, cfg, feats, lens, MAX_SYMBOLS)
    return enc, [tok[b, :n[b]].tolist() for b in range(len(n))]


def serving_setup(seed: int, n_requests: int, dev) -> dict:
    """The served model (libri100, random weights from the seed, the blank
    offset of `blank_offset`) and the requests' utterances."""
    rng = np.random.default_rng(seed)
    cfg = config_libri100()
    params = m.init_params(cfg, rng, dev)
    offset = blank_offset(params, cfg, dev, rng)
    params["joint"]["out"]["b"][cfg.blank] += offset
    lengths = rng.integers(150, 801, size=n_requests)
    lengths[:2] = (150, 800)
    utts = [rng.normal(size=(int(T), cfg.input_dim)).astype(np.float32)
            for T in lengths]
    return {"cfg": cfg, "params": params, "offset": offset,
            "lengths": lengths, "utts": utts}


def served_batch(serving: dict, dev):
    """The first max_batch utterances padded to the largest bucket, as the
    engine pads a batch of them: feats (8, 800, 80) and lengths."""
    B, tb = min(MAX_BATCH, len(serving["utts"])), BUCKETS[-1]
    feats = np.zeros((B, tb, serving["cfg"].input_dim), np.float32)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        feats[i, :serving["lengths"][i]] = serving["utts"][i]
        lens[i] = serving["lengths"][i]
    return torch.from_numpy(feats).to(dev), torch.from_numpy(lens).to(dev)


def serve_all(serving: dict, params, dev) -> tuple[list, dict, dict]:
    """Every request through a BatchingEngine holding `params`, behind
    http_server: the answers, the engine's stats and the launch counts of
    the served requests alone (the warm-up excluded)."""
    cfg = serving["cfg"]
    engine = BatchingEngine(params, cfg, max_symbols=MAX_SYMBOLS,
                            frame_buckets=BUCKETS, max_batch=MAX_BATCH,
                            window_ms=WINDOW_MS, device=dev)
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        answers = serve_requests(engine, serving["utts"])
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        stats = engine.stats.summary()
    finally:
        engine.close()

    codes = [a[0] for a in answers]
    check(all(c == 200 for c in codes), f"HTTP codes {codes}")
    for (_, out, _), T in zip(answers, serving["lengths"]):
        n = len(out["tokens"])
        check(n == len(out["confidence"]) == len(out["frames"]) <= MAX_SYMBOLS,
              "result fields disagree in length")
        check(all(0 < k < cfg.vocab_size for k in out["tokens"]),
              "token outside the vocabulary or blank")
        check(all(np.isfinite(c) and c <= 1e-6 for c in out["confidence"]),
              "confidence is not a finite log-probability")
        check(all(0 <= f < T for f in out["frames"])
              and out["frames"] == sorted(out["frames"]),
              "frames out of order or past the utterance")
    lat = sorted(a[2] * 1e3 for a in answers)
    tokens = [len(a[1]["tokens"]) for a in answers]
    result = {"requests": len(answers),
              "http_codes": {str(c): codes.count(c) for c in set(codes)},
              "warmup_s": warmup_s,
              "wall_s": wall_s, "req_per_s": len(answers) / wall_s,
              "mean_batch": stats["mean_batch"],
              "batches": stats["batches"],
              "p50_ms": lat[len(lat) // 2],
              "p95_ms": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
              "mean_tokens": statistics.mean(tokens),
              "blank_offset": serving["offset"]}
    return answers, result, counts


def kernel_vs_plain_tokens(params, cfg, feats, lens, what: str) -> dict:
    """recognize_greedy on one batch through the kernels and through the
    plain versions, in f32 (identical tokens required) and bf16."""
    B = feats.shape[0]
    out = {}
    for cd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        enc_k, tok_k = decode_batch(params, c, feats, lens, plain=False)
        enc_p, tok_p = decode_batch(params, c, feats, lens, plain=True)
        agree = sum(a == b for a, b in zip(tok_k, tok_p)) / B
        row = {"params": what, "dtype": cd, "enc_max_abs_err": float(
            (enc_k - enc_p).abs().max()), "token_agreement": agree,
            "tokens_per_utt": [len(t) for t in tok_k]}
        print("kernel_vs_plain_decode " + json.dumps(row))
        if cd == "float32":
            check(tok_k == tok_p, f"f32 tokens ({what} params) differ "
                                  "between the kernel path and the plain path")
            check(row["enc_max_abs_err"] <= ATOL[torch.float32],
                  f"f32 encoder output ({what} params) differs between "
                  "kernel and plain")
            out["enc_f32"] = enc_k
        out[cd] = row
    return out


def end_to_end(serving: dict, dev) -> dict:
    cfg, params = serving["cfg"], serving["params"]
    answers, result, counts = serve_all(serving, params, dev)
    launches = counts["lstm_fwd"]
    result["launches"] = launches
    check(launches > 0, "the served path never launched lstm_fwd")
    check_no_band(counts, "serving")
    print("e2e " + json.dumps(result))

    # One batch of the served utterances: kernel path vs plain path.
    feats_d, lens_d = served_batch(serving, dev)
    enc_f32 = kernel_vs_plain_tokens(params, cfg, feats_d, lens_d,
                                     "float")["enc_f32"]

    # The kernel path on the card against the port on the CPU (plain
    # recurrence, another matmul library), two utterances, f32.
    c = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    enc_cpu, _ = m.encode(cpu_params, c, feats_d[:2].cpu(), lens_d[:2].cpu())
    err = float((enc_cpu - enc_f32[:2].cpu()).abs().max())
    print(f"cpu_reference enc_max_abs_err {err}")
    check(err <= ATOL[torch.float32], f"card vs CPU encoder output {err}")
    return result


def int8_serving(serving: dict, dev) -> dict:
    """Phase 4b: the same requests to an engine holding quantize_params
    (serve.py --quantize int8). At max_batch 8 every encoder layer takes
    the W8A8 route: lstm_fwd_q launches and lstm_fwd does not."""
    cfg = serving["cfg"]
    qparams = quantize_params(serving["params"])
    qb, fb = quantized_bytes(qparams)
    answers, result, counts = serve_all(serving, qparams, dev)
    result.update({"int8_mb": qb / 1e6, "fp32_mb": fb / 1e6,
                   "launches": counts["lstm_fwd_int8"],
                   "lstm_fwd_launches": counts["lstm_fwd"]})
    print("e2e_int8 " + json.dumps(result))
    check(counts["lstm_fwd_int8"] > 0,
          "the int8 engine never launched lstm_fwd_q")
    check(counts["lstm_fwd"] == 0,
          "the int8 engine launched lstm_fwd: an encoder layer took the "
          "dequantized route")
    check_no_band(counts, "int8 serving")
    feats_d, lens_d = served_batch(serving, dev)
    kernel_vs_plain_tokens(qparams, cfg, feats_d, lens_d, "int8")
    k7 = k7_calls(qparams, cfg, feats_d, lens_d)
    print("e2e_int8_k7 " + json.dumps(k7))
    check(len(k7) == cfg.enc_layers
          and all("lstm_q_persistent_kernel" in c["name"] for c in k7),
          f"a served int8 batch's encoder ran {k7}, not one "
          f"lstm_q_persistent_kernel for each of its {cfg.enc_layers} layers")
    result["qparams"] = qparams
    return result


def k7_calls(qparams, cfg, feats, lens) -> list:
    """The K7 kernels (those of lstm_fwd_q.cu) of one served int8 batch's
    encode at the served dtype, by torch.profiler, in order: name and
    device ms each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        m.encode(qparams, cfg, feats, lens)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_profiler_window()
            m.encode(qparams, cfg, feats, lens)
            torch.cuda.synchronize()
            pad_profiler_window()
    evts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "lstm_q" in e.name),
                  key=lambda e: e.time_range.start)
    return [{"name": e.name[:120], "ms": e.time_range.elapsed_us() / 1e3}
            for e in evts]


def host_ms(fn, repeats: int = 2) -> float:
    """Mean wall time of fn() ending in a synchronize."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.mean(times)


def fused_greedy(serving: dict, qparams, dev) -> dict:
    """Phase 4c: recognize_greedy_fused on the served batch with float and
    int8 params, against recognize_greedy on the same params: greedy_fused
    launched; f32 tokens identical; at bf16 (the served dtype) the two
    entry points timed, encoder included."""
    cfg = serving["cfg"]
    feats, lens = served_batch(serving, dev)
    rows, launches = [], 0
    for what, params in (("float", serving["params"]), ("int8", qparams)):
        for cd in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=cd)
            with torch.inference_mode():
                reset_counts()
                tok_f, n_f = gf.recognize_greedy_fused(params, c, feats, lens,
                                                       MAX_SYMBOLS)
                torch.cuda.synchronize()
                counts = read_counts()
                tok_g, n_g = recognize_greedy(params, c, feats, lens,
                                              MAX_SYMBOLS)
                row = {"params": what, "dtype": cd,
                       "greedy_fused_launches": counts["greedy_fused"],
                       "lstm_fwd_int8_launches": counts["lstm_fwd_int8"],
                       "lstm_fwd_launches": counts["lstm_fwd"],
                       "tokens_identical": torch.equal(tok_f, tok_g)
                       and torch.equal(n_f, n_g),
                       "row_agreement": float((tok_f == tok_g).all(1).float()
                                              .mean()),
                       "tokens_per_utt": n_f.tolist()}
                if cd == "bfloat16":
                    row["fused_ms"] = host_ms(lambda: gf.recognize_greedy_fused(
                        params, c, feats, lens, MAX_SYMBOLS))
                    row["lockstep_ms"] = host_ms(lambda: recognize_greedy(
                        params, c, feats, lens, MAX_SYMBOLS))
            print("fused_greedy " + json.dumps(row))
            check(counts["greedy_fused"] > 0,
                  f"recognize_greedy_fused ({what}, {cd}) never launched "
                  "greedy_fused")
            if what == "int8":
                check(counts["lstm_fwd_int8"] > 0 and counts["lstm_fwd"] == 0,
                      f"recognize_greedy_fused (int8, {cd}): the encoder did "
                      "not take the W8A8 route")
            if cd == "float32":
                check(row["tokens_identical"],
                      f"recognize_greedy_fused ({what}, f32): tokens differ "
                      "from recognize_greedy")
            launches += counts["greedy_fused"]
            rows.append(row)
    return {"rows": rows, "launches": launches}


def walking_offset(params, cfg, dev, rng, blank_share: float = 0.7) -> float:
    """Blank-bias offset for the random conformer: blank wins on
    `blank_share` of the (frame, predictor state) pairs, the state being
    the start symbol's or the one after emitting the frame's best token;
    the 0.01 keeps the pair at the quantile off a tie. The median rule of
    `blank_offset` does not fit it: its joint logits vary with the frame
    far more than the LSTM's (every block ends in a LayerNorm)."""
    feats = torch.from_numpy(rng.normal(size=(4, BUCKETS[-1], cfg.input_dim))
                             ).float().to(dev)
    lens = torch.full((4,), BUCKETS[-1], dtype=torch.int32, device=dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        enc, _ = m.encode(params, f32, feats, lens)
        enc = enc.reshape(-1, enc.shape[-1])
        n = enc.shape[0]
        pred, state = m.predict_step(
            params, f32, torch.full((n,), cfg.blank, device=dev),
            m.init_pred_state(f32, n, dev))
        logits = [m.joint_step(params, f32, enc, pred)]
        best = logits[0].clone()
        best[:, cfg.blank] = float("-inf")
        pred, _ = m.predict_step(params, f32, best.argmax(dim=1), state)
        logits.append(m.joint_step(params, f32, enc, pred))
    gaps = []
    for lg in logits:
        others = torch.cat([lg[:, :cfg.blank], lg[:, cfg.blank + 1:]], 1)
        gaps.append(lg[:, cfg.blank] - others.max(dim=1).values)
    return float(-torch.quantile(torch.cat(gaps), 1.0 - blank_share)) + 0.01


def conformer_serving_setup(serving: dict, seed: int, dev) -> dict:
    """libri100_conformer with random weights from the seed, serving the
    libri100 engine's utterances. The predictor's side of the joint is
    scaled up 8x: at its random scale an emission barely moves the
    logits, so a frame that emits once emits up to max_symbols; scaled,
    an utterance emits a few tokens on some frames and walks all of them
    (with the blank offset of `walking_offset`)."""
    rng = np.random.default_rng(seed + 10)
    cfg = config_libri100_conformer()
    params = m.init_params(cfg, rng, dev)
    params["joint"]["pred_proj"]["w"] *= 8.0
    offset = walking_offset(params, cfg, dev, rng)
    params["joint"]["out"]["b"][cfg.blank] += offset
    return {**serving, "cfg": cfg, "params": params, "offset": offset}


def conformer_end_to_end(conf: dict, dev) -> dict:
    """Phase 4d: the requests to an engine on libri100_conformer. Every
    encode runs K8-fwd at each of its 48 LayerNorms and no LSTM kernel;
    the f32 tokens of one served batch are the same through the kernels
    and through the plain versions, and through recognize_greedy_fused
    (K9, which looks only at the predictor) and recognize_greedy."""
    cfg, params = conf["cfg"], conf["params"]
    _, result, counts = serve_all(conf, params, dev)
    result.update({"launches": counts["fused_ln_fwd"],
                   "fused_ln_fwd_per_batch": counts["fused_ln_fwd"]
                   / result["batches"],
                   "lstm_fwd_launches": counts["lstm_fwd"]})
    print("e2e_conformer " + json.dumps(result))
    check(counts["fused_ln_fwd"] == LN_PER_ENCODE * result["batches"],
          f"the conformer engine launched fused_ln_fwd "
          f"{counts['fused_ln_fwd']} times in {result['batches']} batches, "
          f"not {LN_PER_ENCODE} a batch")
    check(counts["lstm_fwd"] == 0, "the conformer engine launched lstm_fwd")
    check_no_band(counts, "conformer serving")
    feats, lens = served_batch(conf, dev)
    kernel_vs_plain_tokens(params, cfg, feats, lens, "conformer")
    c = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        reset_counts()
        tok_f, n_f = gf.recognize_greedy_fused(params, c, feats, lens,
                                               MAX_SYMBOLS)
        torch.cuda.synchronize()
        fused_launches = read_counts()["greedy_fused"]
        tok_g, n_g = recognize_greedy(params, c, feats, lens, MAX_SYMBOLS)
    row = {"params": "conformer", "dtype": "float32",
           "greedy_fused_launches": fused_launches,
           "tokens_identical": torch.equal(tok_f, tok_g)
           and torch.equal(n_f, n_g), "tokens_per_utt": n_f.tolist()}
    print("fused_greedy_conformer " + json.dumps(row))
    check(fused_launches > 0, "recognize_greedy_fused on the conformer "
                              "never launched greedy_fused")
    check(row["tokens_identical"], "recognize_greedy_fused (conformer, f32): "
                                   "tokens differ from recognize_greedy")
    result["fused_greedy"] = row
    return result


def serve_cli(extra: list, utt: np.ndarray) -> dict:
    """serve.py's CLI, --config libri100_conformer plus `extra`, in a
    process of its own: it warms up, answers one /recognize and /stats,
    and drains and exits 0 on SIGTERM."""
    cmd = [sys.executable, "-m", "rnn_transducer_tpu_torch.serve",
           "--config", "libri100_conformer", "--port", "0", *extra]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    lines, started = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line.rstrip())
            if "serving on " in line:
                started.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        check(started.wait(timeout=300),
              f"serve CLI {extra} did not start: {lines[-5:]}")
        start_s = time.perf_counter() - t0
        url = next(ln for ln in lines if "serving on " in ln).split(
            "serving on ")[1].split()[0]
        code, out, lat = post(url + "/recognize", {"feats": utt.tolist()})
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    row = {"argv": cmd[3:], "start_s": start_s, "code": code,
           "tokens": len(out["tokens"]), "latency_ms": lat * 1e3,
           "stats": stats, "rc": rc,
           "drained": any("drained and closed" in ln for ln in lines)}
    print("serve_cli " + json.dumps(row))
    check(code == 200 and rc == 0 and row["drained"],
          f"serve CLI {extra}: code {code}, exit {rc}, log {lines[-5:]}")
    return row


# ------------------------------ phase 5 ----------------------------------

def bench_batch(cfg, seed: int, dev, U: int = TRAIN_U, B: int = TRAIN_B):
    """bench.py's batch: B utterances of noise features, full frame and
    label lengths, U random labels, from the seed."""
    rng = np.random.default_rng(seed)
    T = TRAIN_T
    feats = rng.normal(size=(B, T, cfg.input_dim)).astype(np.float32)
    labels = rng.integers(1, cfg.vocab_size, size=(B, U)).astype(np.int32)
    return (torch.from_numpy(feats).to(dev),
            torch.full((B,), T, dtype=torch.int32, device=dev),
            torch.from_numpy(labels).to(dev),
            torch.full((B,), U, dtype=torch.int32, device=dev))


def leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def pad_profiler_window() -> None:
    """A spin kernel of ~20 ms, then a synchronise. torch.profiler drops a
    kernel whose start or end, mapped from the card's clock onto the
    host's, falls outside its window, and the mapping can be off by
    milliseconds: one AR step's trace on the H100 placed kernels up to 3.9
    ms before their own launch, and lost the step's first LSTM kernel. A
    pad at each end of the window keeps the profiled work inside it; the
    spin kernels themselves are left out of every count."""
    torch.cuda._sleep(40_000_000)
    torch.cuda.synchronize()


def profile_step(step, state, batch, profile_dir, name="train_step"):
    """One training step under torch.profiler: device time by kernel
    family, host time by the step's spans, the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profiler_window()
        t0 = time.perf_counter()
        state, _ = step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pad_profiler_window()
    families = {"lstm_fwd": ("lstm_fwd_persistent_kernel",),
                "lstm_bwd": ("lstm_bwd_persistent_kernel",),
                # K1: the ring's W^T pass and ring kernel, or its CUDA-core
                # form
                "joint_fwd": ("joint_fwd_wt_kernel", "joint_fwd_ring_kernel",
                              "joint_fwd_kernel"),
                "joint_bwd_a": ("joint_bwd_a_",),
                # K2's kernel B: the ring's two kernels, or its CUDA-core
                # form (never a K6 kernel)
                "joint_bwd_b": ("joint_bwd_b_zb_kernel",
                                "joint_bwd_b_ring_kernel",
                                "joint_bwd_b_kernel"),
                "joint_bwd_sums": ("reduce_parts_kernel",),
                "lattice": ("lattice_alpha_kernel", "lattice_beta_kernel"),
                "loss_rows": ("extract_lp_kernel", "assemble_grad_kernel"),
                "fused_ln": ("ln_fwd_", "ln_bwd_"),
                # K6: the backward kernels' names first (every kernel of
                # band_fused.cu may carry its file's tag in its name)
                "band_bwd_a": ("band_bwd_a_",),
                "band_bwd_b": ("band_bwd_b_",),
                "band_sums": ("band_sum_parts",),
                "band_fwd": ("band_fwd_wt_kernel", "band_fwd_ring_kernel",
                             "band_fwd_kernel"),
                "gemm": ("gemm", "Gemm", "cutlass", "sm90_xmma"),
                "softmax": ("softmax",),
                "elementwise": ("elementwise_kernel",),
                "reduce": ("reduce_kernel",)}
    device = {k: 0.0 for k in (*families, "other")}
    launches = {k: 0 for k in device}
    host, span, ops = {}, {}, []
    for evt in prof.key_averages():
        if evt.key in tl.SPANS:  # a span: host time, and its device range
            if evt.device_type == DeviceType.CUDA:
                span[evt.key] = evt.device_time_total / 1e3
            else:
                host[evt.key] = evt.cpu_time_total / 1e3
            continue
        if evt.device_type != DeviceType.CUDA or "spin_kernel" in evt.key:
            continue
        fam = next((k for k, names in families.items()
                    if any(n in evt.key for n in names)), "other")
        ms = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0)) / 1e3
        device[fam] += ms
        launches[fam] += evt.count
        ops.append((ms, evt.count, evt.key))
    busy = sum(device.values())
    top = [{"op": k[:120], "ms": ms, "launches": n}
           for ms, n, k in sorted(ops, reverse=True)[:10]]
    out = {"wall_ms": wall_ms, "device_ms": device, "device_launches":
           launches, "device_busy_share": busy / wall_ms,
           "host_span_ms": host, "device_span_ms": span,
           "top_device_ops": top}
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))
        with open(os.path.join(profile_dir, f"{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=60))
    return state, out


def check_fused_joint_profile(prof: dict, result: dict, what: str) -> None:
    """A profiled fused-loss step runs K1 on its ring, the W^T pass and the
    ring kernel once each a joint_fwd call, K2's kernels A and B on their
    rings, A's W^T pass and ring kernel and B's zb pass and ring kernel
    once each a joint_bwd call, and no K6 kernel."""
    seen = prof["device_launches"]
    per_step = result["launches"]["joint_fwd"] / result["steps"]
    check(per_step > 0 and seen["joint_fwd"] == 2 * per_step,
          f"the profiled {what} step ran {seen['joint_fwd']} joint_fwd "
          f"kernels, not 2 for each of its {per_step} joint_fwd calls")
    per_step = result["launches"]["joint_bwd"] / result["steps"]
    check(per_step > 0 and seen["joint_bwd_a"] == 2 * per_step,
          f"the profiled {what} step ran {seen['joint_bwd_a']} joint_bwd_a "
          f"kernels, not 2 for each of its {per_step} joint_bwd calls")
    check(per_step > 0 and seen["joint_bwd_b"] == 2 * per_step,
          f"the profiled {what} step ran {seen['joint_bwd_b']} joint_bwd_b "
          f"kernels, not 2 for each of its {per_step} joint_bwd calls")
    band = {k: seen[k] for k in ("band_fwd", "band_bwd_a", "band_bwd_b",
                                 "band_sums")}
    check(not any(band.values()),
          f"the profiled {what} step launched band kernels: {band}")


def check_band_profile(prof: dict, result: dict, what: str) -> None:
    """A profiled band step (bf16 W, J % 16 == 0, V even) runs each K6
    kernel in its tensor-core form, two launches a call: K6-fwd's W^T pass
    and ring kernel (the family `band_fwd`), K6-A's W^T pass and ring
    kernel (`band_bwd_a_`), K6-B's zb pass and ring kernel
    (`band_bwd_b_`)."""
    seen = prof["device_launches"]
    for fam, name in (("band_fwd", "band_lp_fwd"),
                      ("band_bwd_a", "band_lp_bwd_a"),
                      ("band_bwd_b", "band_lp_bwd_b")):
        per_step = result["launches"][name] / result["steps"]
        check(per_step > 0 and seen[fam] == 2 * per_step,
              f"the profiled {what} step ran {seen[fam]} {fam} kernels, not "
              f"2 for each of its {per_step} {name} calls")


def check_lstm_launches(prof: dict, result: dict, what: str) -> None:
    """K4-fwd and K4-bwd are one launch per LSTM layer call: the profiled
    step's lstm_fwd and lstm_bwd kernels number their wrappers' calls a
    step (5 each at libri100: 4 encoder layers and the predictor; the AR
    aligner's forward adds its own), not one per time step."""
    counts, steps = result["launches"], result["steps"]
    for fam, calls in (("lstm_fwd", counts["lstm_fwd"]
                        + counts["lstm_fwd_with_acts"]),
                       ("lstm_bwd", counts["lstm_bwd"])):
        per_step = calls / steps
        seen = prof["device_launches"][fam]
        check(per_step > 0 and seen == per_step,
              f"the profiled {what} step ran {seen} {fam} kernels, not the "
              f"{per_step} layer calls a step")


def lattice_ms(dev, seed: int) -> dict:
    """The loss's lattice layer at the training shape, through K3 and
    through the plain versions, masking and gathers included:
    forward_from_lp_with_alpha (alpha) and occupancies_from_lp (beta and
    the occupancies); CUDA events, in turns plain, kernel, kernel, plain."""
    rng = np.random.default_rng(seed)
    lpb, lpy, fl, ll = lattice_scores(rng, dev, TRAIN_B, TRAIN_T // 2,
                                      TRAIN_U)
    alpha = rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)[1]

    def plain(fn):
        def run():
            with plain_kernels():
                fn()
        return run

    def fwd():
        rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)

    def occ():
        rl.occupancies_from_lp(lpb, lpy, fl, ll, alpha)

    ka, pa = timed_pair(fwd, plain(fwd))
    kb, pb = timed_pair(occ, plain(occ))
    return {"alpha_kernel_ms": ka, "alpha_plain_ms": pa,
            "beta_occupancies_kernel_ms": kb,
            "beta_occupancies_plain_ms": pb}


def leaf_paths(tree, path: str = ""):
    """'/'-joined dict keys and list indices of every leaf, in the order
    of torch's pytree flatten (dicts in insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{path}/{i}")
    else:
        yield path


def f32_kernels_vs_plain(seed: int, dev, loss_impl: str = "fused",
                         U: int = TRAIN_U, cfg=None,
                         B: int = TRAIN_B, **loss_kw) -> dict:
    """One f32 loss and gradient of the model (libri100 unless `cfg` is
    given), B utterances, T=400, U labels, through the kernels and through
    the plain versions.

    The conformer's attention key bias gets no gradient in exact
    arithmetic (each query's softmax is invariant to the shift q . b_k of
    all its logits): both sides give f32 rounding noise there, so those
    leaves are held to 1e-4 of the largest gradient instead of to each
    other."""
    cfg = dataclasses.replace(cfg or config_libri100(),
                              compute_dtype="float32")
    params = m.init_params(cfg, np.random.default_rng(seed + 2), dev)
    batch = bench_batch(cfg, seed + 2, dev, U, B)
    flat, spec = torch.utils._pytree.tree_flatten(params)
    names = list(leaf_paths(params))
    check(len(names) == len(flat), "leaf_paths disagrees with the pytree")
    noise = [n.endswith("/att/k/b") for n in names]

    def loss_and_grads(plain: bool):
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        with ctx:
            xs = [p.detach().requires_grad_(True) for p in flat]
            loss, _ = tl.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec),
                                 cfg, *batch, loss_impl=loss_impl, **loss_kw)
            grads = torch.autograd.grad(loss, xs)
        return float(loss.detach()), grads

    lk, gk = loss_and_grads(plain=False)
    lp, gp = loss_and_grads(plain=True)
    loss_rel = abs(lk - lp) / abs(lp)
    worst = max(rel_err(a, b) for a, b, z in zip(gk, gp, noise) if not z)
    top = max(float(a.abs().max()) for a in gp)
    noise_max = max([float(a.abs().max()) for a, z in zip(gk + gp,
                                                          noise + noise)
                     if z] or [0.0])
    row = {"model": "conformer" if cfg.enc_type == "conformer" else "lstm",
           "B": B, "loss_impl": loss_impl, "U": U, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_err": loss_rel,
           "loss_rtol": LOSS_RTOL, "grad_worst_rel_err": worst,
           "grad_rtol": GRAD_RTOL, "leaves": len(gk),
           "key_bias_leaves": sum(noise), "key_bias_max_abs": noise_max,
           "max_abs_grad": top}
    print("train_f32_kernels_vs_plain " + json.dumps(row))
    check(loss_rel <= LOSS_RTOL,
          f"f32 loss ({loss_impl}): kernels {lk} vs plain {lp}")
    check(worst <= GRAD_RTOL,
          f"f32 gradients ({loss_impl}): worst rel err {worst}")
    check(noise_max <= 1e-4 * top,
          f"f32 key-bias gradients {noise_max} above noise level")
    return row


def trees_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def cli_round_trip(dev) -> dict:
    """The training CLI for 3 steps with a checkpoint; the checkpoint
    restores to the state the CLI ended with."""
    with tempfile.TemporaryDirectory() as d:
        argv = ["--config", "libri100", "--data", "synthetic", "--steps", "3",
                "--batch-size", "8", "--max-frames", "200", "--max-labels",
                "20", "--warmup-steps", "1", "--log-every", "1",
                "--ckpt-dir", d, "--device", dev.type]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = train_cli(argv)
        last = json.loads(out.getvalue().strip().splitlines()[-1])
        restored, step = ckpt.restore_checkpoint(d, device=dev)
    same = (step == state.step == 3
            and trees_equal(restored.params, state.params)
            and trees_equal(restored.opt_state, state.opt_state))
    row = {"final_json": last, "restored_step": step,
           "restored_equals_state": same}
    print("train_cli " + json.dumps(row))
    check(last.get("steps") == 3 and np.isfinite(last.get("final_loss")),
          f"training CLI final line {last}")
    check(same, "the restored checkpoint differs from the CLI's state")
    return row


def cli_json(argv: list, steps: int, what: str) -> dict:
    """The training CLI in this process; its last stdout line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli(argv)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"train_cli_{what} " + json.dumps(last))
    check(last.get("steps") == steps and np.isfinite(last.get("final_loss")),
          f"training CLI ({what}): final line {last}")
    return last


def timed_steps(step, state, batch, B: int = TRAIN_B):
    """One step, then bench.py's slope runs (SLOPE_STEPS steps, best of
    SLOPE_REPEATS), with the launch counts of exactly these steps."""
    infos = []
    reset_counts()
    t0 = time.perf_counter()
    state, info = step(state, *batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    infos.append(info)
    times = []
    for n in SLOPE_STEPS:
        best = float("inf")
        for _ in range(SLOPE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                state, info = step(state, *batch)
                infos.append(info)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times.append(best)
    counts = read_counts()
    dt = (times[1] - times[0]) / (SLOPE_STEPS[1] - SLOPE_STEPS[0])
    losses = [float(i["loss"]) for i in infos]
    gnorms = [float(i["grad_norm"]) for i in infos]
    skipped = sum(int(i["skipped_nonfinite"]) for i in infos)
    result = {"steps": len(infos), "first_step_s": first_s,
              "ms_per_step": dt * 1e3, "utt_per_s": B / dt,
              "slope_times_s": times, "loss_first": losses[0],
              "loss_last": losses[-1], "grad_norm_last": gnorms[-1],
              "skipped_nonfinite": skipped,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts}
    check(all(np.isfinite(x) for x in losses + gnorms),
          "non-finite loss or grad norm in a training step")
    check(skipped == 0, f"{skipped} training steps skipped as non-finite")
    return state, result


def train_run(seed: int, dev, loss_impl: str, U: int, cfg=None,
              B: int = TRAIN_B, **tcfg_kw):
    """A fresh state (libri100 unless `cfg` is given) trained on bench.py's
    batch of B utterances with U labels: the step, its state after the
    timed steps, the batch and the result."""
    cfg = cfg or config_libri100()
    tcfg = TrainConfig(batch_size=B, warmup_steps=100,
                       total_steps=10000,  # bench.py's TrainConfig
                       loss_impl=loss_impl, **tcfg_kw)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev)
    step = tl.make_train_step(cfg, tcfg)
    batch = bench_batch(cfg, seed, dev, U, B)
    p0 = [p.clone() for p in leaves(state.params)]
    torch.cuda.reset_peak_memory_stats()
    state, result = timed_steps(step, state, batch, B)
    moved = max(float((a - b).abs().max())
                for a, b in zip(leaves(state.params), p0))
    result = {"B": B, "T": TRAIN_T, "U": U, "dtype": "bfloat16",
              "loss_impl": loss_impl, **result, "param_max_change": moved}
    check(moved > 0.0, "the params did not change over the training steps")
    return step, state, batch, result


def train_phase(seed: int, dev, profile_dir) -> dict:
    step, state, batch, result = train_run(seed, dev, "auto", TRAIN_U)
    print("train " + json.dumps(result))
    counts = result["launches"]
    for name in ("lstm_fwd_with_acts", "lstm_bwd", "joint_fwd", "joint_bwd",
                 "lattice_alpha", "lattice_beta"):
        check(counts[name] > 0, f"the training step never launched {name}")
    check_no_band(counts, "the fused training step")

    state, prof = profile_step(step, state, batch, profile_dir)
    print("train_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "libri100")
    check_fused_joint_profile(prof, result, "libri100")
    lat_ms = lattice_ms(dev, seed)
    print("train_lattice " + json.dumps(lat_ms))
    result["profile"], result["lattice"] = prof, lat_ms
    result["f32"] = f32_kernels_vs_plain(seed, dev)
    result["cli"] = cli_round_trip(dev)
    return result


def train_pallas_phase(seed: int, dev, profile_dir) -> dict:
    """The two-pass route (loss_impl="pallas") at B=32, T=400, U=80, then
    the same batch through the fused route; the f32 check of the
    two-pass route; the CLI with --loss-impl pallas."""
    step, state, batch, result = train_run(seed, dev, "pallas", PALLAS_U)
    print("train_pallas " + json.dumps(result))
    counts = result["launches"]
    for name in ("extract_lp", "assemble_grad", "lattice_alpha",
                 "lattice_beta", "lstm_fwd_with_acts", "lstm_bwd"):
        check(counts[name] > 0,
              f"the two-pass training step never launched {name}")
    check(counts["joint_fwd"] == counts["joint_bwd"] == 0,
          "the two-pass training step launched the fused joint kernels")
    check_no_band(counts, "the two-pass training step")
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_pallas_step")
    print("train_pallas_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "two-pass")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()

    fused = train_run(seed, dev, "fused", PALLAS_U)[3]
    print("train_fused_U80 " + json.dumps(fused))
    check_no_band(fused["launches"], "the fused step at U=80")
    result["fused_same_batch"] = fused
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "pallas", PALLAS_U)

    result["cli"] = cli_json(
        ["--config", "libri100", "--data", "synthetic", "--steps", "2",
         "--batch-size", "8", "--max-frames", "200", "--max-labels", "20",
         "--warmup-steps", "1", "--log-every", "1", "--loss-impl", "pallas",
         "--device", dev.type], 2, "pallas")
    return result


def train_conformer_phase(seed: int, dev, profile_dir) -> dict:
    """libri100_conformer at bench.py's B=64, T=400, U=40 through the
    default loss (fused on the card): K8-bwd at each of the 48 LayerNorms
    of every step, with K4 (the predictor), K1, K2 and K3; a profiled
    step; the f32 check; the CLI for 3 steps."""
    cfg = config_libri100_conformer()
    step, state, batch, result = train_run(seed, dev, "auto", CONF_U, cfg,
                                           CONF_B)
    counts, steps = result["launches"], result["steps"]
    result["fused_ln_bwd_per_step"] = counts["fused_ln_bwd"] / steps
    print("train_conformer " + json.dumps(result))
    for name in ("fused_ln_fwd", "fused_ln_bwd"):
        check(counts[name] == LN_PER_ENCODE * steps,
              f"the conformer step launched {name} {counts[name]} times in "
              f"{steps} steps, not {LN_PER_ENCODE} a step")
    for name in ("lstm_fwd_with_acts", "lstm_bwd", "joint_fwd", "joint_bwd",
                 "lattice_alpha", "lattice_beta"):
        check(counts[name] > 0, f"the conformer step never launched {name}")
    check_no_band(counts, "the conformer step")
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_conformer_step")
    print("train_conformer_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "conformer")
    check_fused_joint_profile(prof, result, "conformer")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "fused", CONF_U, cfg,
                                         CONF_B)
    torch.cuda.empty_cache()
    result["cli"] = cli_json(
        ["--config", "libri100_conformer", "--data", "synthetic", "--steps",
         "3", "--batch-size", "8", "--max-frames", "400", "--max-labels",
         "20", "--warmup-steps", "1", "--log-every", "1", "--device",
         dev.type], 3, "conformer")
    return result


def short_run(seed: int, dev, loss_impl: str, U: int, cfg,
              B: int = TRAIN_B, n: int = 2) -> dict:
    """A fresh state, one warm step, then n steps timed by the host clock
    ending in a synchronise: a context number for a route too slow for the
    slope runs, not a slope."""
    tcfg = TrainConfig(batch_size=B, warmup_steps=100, total_steps=10000,
                       loss_impl=loss_impl)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev)
    step = tl.make_train_step(cfg, tcfg)
    batch = bench_batch(cfg, seed, dev, U, B)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, info = step(state, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, info = step(state, *batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    return {"B": B, "T": TRAIN_T, "U": U, "V": cfg.vocab_size,
            "loss_impl": loss_impl, "timed_steps": n, "ms_per_step": ms,
            "utt_per_s": B / ms * 1e3, "loss_last": float(info["loss"]),
            "skipped_nonfinite": int(info["skipped_nonfinite"]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": read_counts()}


def check_band_step(result: dict, what: str, per_step_k3: int) -> None:
    """One launch of each K6 kernel a step, `per_step_k3` of each K3 kernel,
    the LSTM kernels, and not the full lattice's joint kernels."""
    counts, steps = result["launches"], result["steps"]
    for name in BAND_KERNELS:
        check(counts[name] == steps,
              f"the {what} step launched {name} {counts[name]} times in "
              f"{steps} steps, not once a step")
    for name in ("lattice_alpha", "lattice_beta"):
        check(counts[name] == per_step_k3 * steps,
              f"the {what} step launched {name} {counts[name]} times in "
              f"{steps} steps, not {per_step_k3} a step")
    for name in ("lstm_fwd_with_acts", "lstm_bwd"):
        check(counts[name] > 0, f"the {what} step never launched {name}")
    check(counts["joint_fwd"] == counts["joint_bwd"] == 0,
          f"the {what} step launched the full lattice's joint kernels")


def train_pruned_phase(seed: int, dev, profile_dir) -> dict:
    """The pruned two-pass loss at its card shape: libri100 with V=8192,
    S=8, B=32, T=400, U=100, bf16, simple_loss_scale 0.5. K6 once each a
    step; K3 three times each (the simple pass's alpha and beta, the
    bounds' occupancies, the band's alpha and beta); a profiled step; the
    full lattice's K1 / K2 on the same batch for context; the f32 check;
    the CLI with --pruned-range 8 on a JSON config."""
    cfg = dataclasses.replace(config_libri100(), vocab_size=PRUNED_V,
                              pruned_range=PRUNED_S)
    step, state, batch, result = train_run(seed, dev, "pruned", PRUNED_U,
                                           cfg)
    result.update(V=PRUNED_V, S=PRUNED_S)
    print("train_pruned " + json.dumps(result))
    check_band_step(result, "pruned", 3)
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_pruned_step")
    print("train_pruned_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "pruned")
    check_band_profile(prof, result, "pruned")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()
    fused = short_run(seed, dev, "fused", PRUNED_U, cfg)
    print("train_fused_V8192 " + json.dumps(fused))
    check_no_band(fused["launches"], "the fused step")
    result["fused_same_batch"] = fused
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "pruned", PRUNED_U, cfg)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "libri100_v8192.json")
        with open(path, "w") as fh:
            json.dump({k: v for k, v in dataclasses.asdict(
                dataclasses.replace(cfg, pruned_range=0)).items()
                if not isinstance(v, tuple)}, fh)
        result["cli"] = cli_json(
            ["--config", path, "--pruned-range", str(PRUNED_S), "--data",
             "synthetic", "--steps", "3", "--batch-size", "8",
             "--max-frames", "200", "--max-labels", "20", "--warmup-steps",
             "1", "--log-every", "1", "--device", dev.type], 3, "pruned")
    return result


def train_ar_phase(seed: int, dev, profile_dir) -> dict:
    """The alignment-restricted band at libri100's B=32, T=400, U=40,
    ar_range 8 (centred), self-aligned: the live model's Viterbi path under
    no_grad, then the banded loss through K6 once each a step and K3 once
    each (the band's alpha and beta); a profiled step; the f32 check; the
    CLI with --ar-range 8."""
    cfg = config_libri100()
    step, state, batch, result = train_run(seed, dev, "auto", TRAIN_U, cfg,
                                           ar_range=AR_S)
    result.update(ar_range=AR_S, ar_left=-1)
    print("train_ar " + json.dumps(result))
    check_band_step(result, "AR", 1)
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_ar_step")
    print("train_ar_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "AR")
    check_band_profile(prof, result, "AR")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "ar", TRAIN_U, cfg,
                                         ar_range=AR_S)
    torch.cuda.empty_cache()
    result["cli"] = cli_json(
        ["--config", "libri100", "--ar-range", str(AR_S), "--data",
         "synthetic", "--steps", "3", "--batch-size", "8", "--max-frames",
         "200", "--max-labels", "20", "--warmup-steps", "1", "--log-every",
         "1", "--device", dev.type], 3, "ar")
    return result


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bnd: dict, library_ms=None, kernel=None) -> dict:
    entry = {"name": name, "route": "cuda",
             "source": f"rnn_transducer_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
             "bound_by": bnd["bound_by"], "library_ms": library_ms}
    if kernel:  # the device kernel's name, where it differs from `name`
        entry["kernel"] = kernel
    return entry


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--profile-dir", default=None,
                   help="write the training step's torch.profiler trace "
                        "and table here")
    args = p.parse_args(argv)

    # phase 1: card
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 2: build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}")
    for line in build.build_log().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"build: {line.strip()}")

    # phase 3: each kernel against its plain version
    t0 = time.perf_counter()
    k = kernel_vs_plain(np.random.default_rng(args.seed + 1), dev)
    kt = lstm_train_vs_plain(np.random.default_rng(args.seed + 3), dev)
    kj = joint_vs_plain(np.random.default_rng(args.seed + 4), dev)
    kl = lattice_vs_plain(np.random.default_rng(args.seed + 5), dev)
    kr = loss_rows_vs_plain(np.random.default_rng(args.seed + 6), dev)
    kq = lstm_int8_vs_plain(np.random.default_rng(args.seed + 7), dev)
    serving = serving_setup(args.seed, args.requests, dev)
    kg = greedy_fused_vs_plain(serving, dev)
    kln = fused_ln_vs_plain(np.random.default_rng(args.seed + 8), dev)
    kb = band_fused_vs_plain(np.random.default_rng(args.seed + 9), dev)
    print(f"phase kernel: {time.perf_counter() - t0:.1f} s")

    # phase 4: serving end to end, float and int8, and the fused decoder
    t0 = time.perf_counter()
    e2e = end_to_end(serving, dev)
    print(f"phase e2e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e2e_q = int8_serving(serving, dev)
    print(f"phase e2e_int8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fused = fused_greedy(serving, e2e_q.pop("qparams"), dev)
    print(f"phase fused: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    conf = conformer_serving_setup(serving, args.seed, dev)
    e2e_c = conformer_end_to_end(conf, dev)
    print(f"phase e2e_conformer: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    utt = serving["utts"][0]
    for extra in ([], ["--quantize", "int8"]):
        serve_cli(extra, utt)
    print(f"phase serve_cli: {time.perf_counter() - t0:.1f} s")
    del serving, conf
    torch.cuda.empty_cache()

    # phase 5: training
    t0 = time.perf_counter()
    train = train_phase(args.seed, dev, args.profile_dir)
    print(f"phase train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pallas = train_pallas_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_pallas: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    conf_train = train_conformer_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_conformer: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pruned = train_pruned_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_pruned: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_ar_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_ar: {time.perf_counter() - t0:.1f} s")

    # phase 6: results
    lp = "rnn_transducer_tpu/ops/lstm_pallas.py"
    jp = "rnn_transducer_tpu/ops/rnnt_joint_fused.py"
    wp = "rnn_transducer_tpu/ops/rnnt_lattice_pallas.py"
    rp = "rnn_transducer_tpu/ops/rnnt_loss_pallas.py"
    gp = "rnn_transducer_tpu/decode/greedy_pallas.py"
    fp = "rnn_transducer_tpu/ops/fused_ln.py"
    bp = "rnn_transducer_tpu/ops/rnnt_band_fused.py"
    counts = train["launches"]
    two_pass = pallas["launches"]
    km, tm_, jm_, lm, rm, lnm, bm = (k["main"], kt["main"], kj["main"],
                                     kl["main"], kr["main"], kln["main"],
                                     kb["main"])
    band_counts = pruned["launches"]
    print(json.dumps({"kernels": [
        kernel_entry("lstm_fwd", "lstm_fwd.cu", f"{lp}:119", e2e["launches"],
                     k["max_abs_err"], km["kernel_ms"], km["plain_ms"], km,
                     km["library_ms"]),
        kernel_entry("lstm_fwd_with_acts", "lstm_fwd.cu", f"{lp}:119",
                     counts["lstm_fwd_with_acts"], kt["worst"]["fwd"],
                     tm_["fwd_kernel_ms"], tm_["fwd_plain_ms"],
                     tm_["fwd_bound"], tm_["cudnn_train_fwd_ms"]),
        kernel_entry("lstm_bwd", "lstm_bwd.cu", f"{lp}:222",
                     counts["lstm_bwd"], kt["worst"]["bwd"],
                     tm_["bwd_kernel_ms"], tm_["bwd_plain_ms"],
                     tm_["bwd_bound"], tm_["cudnn_bwd_ms"]),
        kernel_entry("joint_fwd", "joint_fwd.cu", f"{jp}:132",
                     counts["joint_fwd"], kj["worst_fwd"],
                     jm_["fwd_kernel_ms"], jm_["fwd_plain_ms"],
                     jm_["fwd_bound"]),
        kernel_entry("joint_bwd", "joint_bwd.cu", f"{jp}:374",
                     counts["joint_bwd"], kj["worst_bwd"],
                     jm_["bwd_kernel_ms"], jm_["bwd_plain_ms"],
                     jm_["bwd_bound"]),
        kernel_entry("lattice_alpha", "lattice.cu", f"{wp}:65",
                     counts["lattice_alpha"], kl["worst_alpha"],
                     lm["alpha_kernel_ms"], lm["alpha_plain_ms"],
                     lm["alpha_bound"]),
        kernel_entry("lattice_beta", "lattice.cu", f"{wp}:65",
                     counts["lattice_beta"], kl["worst_beta"],
                     lm["beta_kernel_ms"], lm["beta_plain_ms"],
                     lm["beta_bound"]),
        kernel_entry("extract_lp", "loss_rows.cu", f"{rp}:82",
                     two_pass["extract_lp"], kr["worst_extract"],
                     rm["extract_kernel_ms"], rm["extract_plain_ms"],
                     rm["extract_bound"]),
        kernel_entry("assemble_grad", "loss_rows.cu", f"{rp}:126",
                     two_pass["assemble_grad"], kr["worst_grad"],
                     rm["grad_kernel_ms"], rm["grad_plain_ms"],
                     rm["grad_bound"]),
        kernel_entry("lstm_fwd_int8", "lstm_fwd_q.cu", f"{lp}:532",
                     e2e_q["launches"], kq["max_abs_err"],
                     kq["main"]["kernel_ms"], kq["main"]["plain_ms"],
                     kq["main"], kernel="lstm_q_persistent_kernel"),
        kernel_entry("greedy_fused", "greedy_fused.cu", f"{gp}:107",
                     fused["launches"], kg["max_abs_err"],
                     kg["main"]["kernel_ms"], kg["main"]["plain_ms"],
                     kg["main"]),
        kernel_entry("fused_ln_fwd", "fused_ln.cu", f"{fp}:118",
                     e2e_c["launches"], kln["worst"]["fwd"],
                     lnm["fwd_kernel_ms"], lnm["fwd_plain_ms"],
                     lnm["fwd_bound"], lnm["fwd_library_ms"]),
        kernel_entry("fused_ln_bwd", "fused_ln.cu", f"{fp}:152",
                     conf_train["launches"]["fused_ln_bwd"],
                     kln["worst"]["bwd"], lnm["bwd_kernel_ms"],
                     lnm["bwd_plain_ms"], lnm["bwd_bound"],
                     lnm["bwd_library_ms"]),
        kernel_entry("band_lp_fwd", "band_fused.cu", f"{bp}:95",
                     band_counts["band_lp_fwd"], kb["worst"]["fwd"],
                     bm["fwd_kernel_ms"], bm["fwd_plain_ms"],
                     bm["fwd_bound"]),
        kernel_entry("band_lp_bwd_a", "band_fused.cu", f"{bp}:157",
                     band_counts["band_lp_bwd_a"], kb["worst"]["bwd_a"],
                     bm["bwd_a_kernel_ms"], bm["bwd_a_plain_ms"],
                     bm["bwd_a_bound"]),
        kernel_entry("band_lp_bwd_b", "band_fused.cu", f"{bp}:238",
                     band_counts["band_lp_bwd_b"], kb["worst"]["bwd_b"],
                     bm["bwd_b_kernel_ms"], bm["bwd_b_plain_ms"],
                     bm["bwd_b_bound"]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
