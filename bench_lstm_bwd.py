#!/usr/bin/env python3
"""Where a step of the LSTM backward kernel (K4-bwd) spends its time.

    python3 bench_lstm_bwd.py [--out PARTS.json]

Builds `rnn_transducer_tpu_torch/csrc/lstm_bwd.cu` as it is and in
variants that each drop parts of a step, then times one launch of every
build at libri100's training shapes (layer 0: B=32, T=400; layers 1-3:
T=200; the predictor: T=41 at B=32 and 64) in bf16 and f32, in turns, on
one CUDA card. The ablated variants compute wrong values on purpose and
serve only as clocks; the port never loads any of them:

  full          the kernel as shipped
  no_barrier    the grid barrier replaced by a block barrier
  grid_sync     cooperative_groups' grid.sync() in place of the split
                barrier, with the next step's loads before it (a correct
                kernel: the design the split barrier replaced)
  no_fetch      the stage's TMA copies skipped (its mbarrier completes at
                once; the product reads the last stage)
  no_product    the dh product skipped (the partial sums are zeros)
  barrier_only  neither fetch nor product: barrier, epilogue, loads
  phases        the full kernel with clock64() read by thread 0 of every
                block at the step's phase boundaries: fetch + product,
                epilogue, barrier (arrive, next loads, wait); the cycles go
                to a scratch area behind the barrier's counter

The per-step cost of a part is (full - variant) / (T + 1) steps; the
phases variant splits its own per-step time by the blocks' mean cycle
shares (`phase_us_per_step`). The fixed cost of a launch (the W_hh slice
load, the launch itself) is the intercept of the full kernel's ms against
T. Prints one JSON line per shape, and writes them all to --out if given.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.utils import build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "rnn_transducer_tpu_torch", "csrc", "lstm_bwd.cu")
ARRIVE = "    barrier_arrive(p.arrived);\n"
WAIT = "    barrier_wait(p.arrived, (unsigned int)(T - t) * n_blocks);\n"
STEP_END = ARRIVE + "    if (t > 0) prefetch(t - 1);\n" + WAIT
GRID_SYNC = ("    if (t > 0) prefetch(t - 1);\n"
             "    cooperative_groups::this_grid().sync();\n")
FETCH = ("        tma_rows(dg_s, sp, src + (size_t)(b0 + r0) * p.Kp + c0, "
         "p.Kp, SR,\n                 (unsigned int)(KC * sizeof(W)), "
         "mbar);\n")
ARRIVE_ONLY = ('        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" '
               '::"r"(mbar) : "memory");\n')
PRODUCT = ("        warp_tile<UB>(d, w_s, wp, c0 + warp * kw, dg_s, sp, n0, "
           "warp * kw,\n                      kw, lane);\n")
PRODUCT_CALL = "                     red_s, b0, mbar, phase);\n"
BREAK = "      break;\n"
# thread 0's clock at the step's phase boundaries, summed per phase
CLOCK = ("    if (threadIdx.x == 0) {{ const long long n = clock64(); "
         "ph[{i}] += n - mark; mark = n; }}\n")
PHASES = (
    ("  prefetch(T - 1);\n",
     "  prefetch(T - 1);\n  long long ph[3] = {0, 0, 0};\n"
     "  long long mark = clock64();\n"),
    (PRODUCT_CALL, PRODUCT_CALL + CLOCK.format(i=0)),
    (ARRIVE, CLOCK.format(i=1) + ARRIVE),
    (WAIT, WAIT + CLOCK.format(i=2)),
    (BREAK, "      if (threadIdx.x == 0) {\n"
            "        unsigned long long* o = reinterpret_cast<unsigned "
            "long long*>(p.arrived + 4) + 3 * (blockIdx.y * gridDim.x + "
            "blockIdx.x);\n"
            "        for (int i = 0; i < 3; ++i) o[i] = ph[i];\n"
            "      }\n" + BREAK),
)
PHASE_NAMES = ("fetch_and_product", "epilogue", "barrier")
VARIANTS = {
    "full": (),
    "no_barrier": ((ARRIVE, "    __syncthreads();\n"), (WAIT, "")),
    "grid_sync": ((STEP_END, GRID_SYNC),),
    "no_fetch": ((FETCH, ARRIVE_ONLY),),
    "no_product": ((PRODUCT, ""),),
    "barrier_only": ((FETCH, ARRIVE_ONLY), (PRODUCT, "")),
    "phases": PHASES,
}
# (name, B, T, H): libri100's layer 0 and layers 1-3, its predictor, and
# the conformer's predictor at B=64
SHAPES = (("l0_train", 32, 400, 512), ("l1_train", 32, 200, 512),
          ("pred_b32", 32, 41, 512), ("pred_b64", 64, 41, 512))


def variant_source(patches) -> str:
    with open(SRC) as f:
        src = f.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"bench_lstm_bwd: the pattern {old!r} is not "
                             "in lstm_bwd.cu once; update the variants")
        src = src.replace(old, new)
    if any(STEP_END == old for old, _ in patches):
        src = "#include <cooperative_groups.h>\n" + src
    return src


def build_variants(workdir: str) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together, each into its own
    shared library."""
    nvcc = build._nvcc()
    cmds, libs = [], {}
    for name, patches in VARIANTS.items():
        cu = os.path.join(workdir, f"lstm_bwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(patches))
        so = os.path.join(workdir, f"lstm_bwd_{name}.so")
        cmds.append([nvcc, *build.NVCC_FLAGS, "-I",
                     os.path.dirname(SRC), "-shared", "-o", so, cu])
        libs[name] = so
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for c, p in zip(cmds, procs):
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed: {' '.join(c)}\n{out}")
    out = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        lib.lstm_bwd.restype, lib.lstm_bwd.argtypes = (
            build.SIGNATURES["lstm_bwd"])
        out[name] = lib
    return out


def inputs(B: int, T: int, H: int, dtype, dev):
    """acts, cs_prev, dhs, dcT, w from the plain forward, seeded."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, T, 4 * H, generator=g).to(dev)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dtype).to(dev)
    h0 = torch.zeros(B, H, device=dev)
    c0 = torch.zeros(B, H, device=dev)
    _, cs, acts = lstm_cuda.lstm_recurrence_with_acts_reference(x, w, h0, c0)
    dhs = torch.randn(B, T, H, generator=g).to(dev)
    dcT = torch.zeros(B, H, device=dev)
    return acts, torch.cat([c0[:, None], cs[:, :-1]], 1), dhs, dcT, w


def launch_ms(lib, args, plan, dev, reps: int, cycles=None) -> list[float]:
    """Kernel ms of `reps` launches, each timed alone by CUDA events; the
    exchange buffer is zeroed outside the timed range. With `cycles` (a
    list), the phases variant's cycles per block of each launch are
    appended to it."""
    acts, cs_prev, dhs, dcT, w = args
    B, T, H4 = acts.shape
    H = H4 // 4
    dgates = torch.empty((B, T, H4), device=dev)
    dh0 = torch.empty((B, H), device=dev)
    dc0 = torch.empty((B, H), device=dev)
    n_blocks = plan.grid[0] * plan.grid[1]
    head = 2 * plan.grid[1] * plan.rows * plan.k_pad * w.element_size()
    xbuf = torch.zeros(head + 16 + 24 * n_blocks, dtype=torch.uint8,
                       device=dev)
    times = []
    for _ in range(reps + 1):  # the first call warms up
        xbuf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.lstm_bwd(
            acts.data_ptr(), cs_prev.data_ptr(), dhs.data_ptr(),
            dcT.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
            dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            xbuf.data_ptr(), B, T, H, plan.units, plan.rows,
            plan.stage_rows, plan.stage_cols, *build.stream_args(dev))
        end.record()
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"lstm_bwd launch failed ({err})")
        times.append(start.elapsed_time(end))
        if cycles is not None:
            cycles.append(xbuf[head + 16:].view(torch.int64).view(
                n_blocks, 3).double().cpu())
    return times[1:]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="also write the rows to this JSON file")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_lstm_bwd: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory() as d:
        libs = build_variants(d)
        rows = []
        for dtype in (torch.bfloat16, torch.float32):
            for name, B, T, H in SHAPES:
                a = inputs(B, T, H, dtype, dev)
                plan = lstm_cuda.device_bwd_plan(B, H, dtype, dev)
                ms = {k: [] for k in libs}
                cycles = []
                # in turns: every variant, then every variant in reverse
                for order in (list(libs), list(libs)[::-1]):
                    for k in order:
                        ms[k] += launch_ms(
                            libs[k], a, plan, dev, args.reps,
                            cycles if k == "phases" else None)
                med = {k: statistics.median(v) for k, v in ms.items()}
                steps = T + 1
                share = torch.stack(cycles[1:]).mean((0, 1))
                share = (share / share.sum()).tolist()
                row = {"case": name, "B": B, "T": T, "H": H,
                       "dtype": str(dtype).replace("torch.", ""),
                       "plan": {"units": plan.units, "rows": plan.rows,
                                "grid": plan.grid,
                                "smem_bytes": plan.smem_bytes,
                                "passes": plan.passes},
                       "ms": med, "ms_min": {k: min(v) for k, v in ms.items()},
                       "us_per_step": {k: v / steps * 1e3
                                       for k, v in med.items()},
                       "part_us_per_step": {
                           "barrier": (med["full"] - med["no_barrier"])
                           / steps * 1e3,
                           "fetch": (med["full"] - med["no_fetch"])
                           / steps * 1e3,
                           "product": (med["full"] - med["no_product"])
                           / steps * 1e3,
                           "fetch_and_product": (med["full"]
                                                 - med["barrier_only"])
                           / steps * 1e3,
                           "grid_sync_over_split": (med["grid_sync"]
                                                    - med["full"])
                           / steps * 1e3},
                       "phase_us_per_step": {
                           n: f * med["phases"] / steps * 1e3
                           for n, f in zip(PHASE_NAMES, share)},
                       "card": card}
                print("lstm_bwd_parts " + json.dumps(row))
                rows.append(row)
        for dt in ("bfloat16", "float32"):
            by_t = {r["T"]: r["ms"]["full"] for r in rows
                    if r["dtype"] == dt and r["B"] == 32}
            slope = (by_t[400] - by_t[41]) / (400 - 41)
            print("lstm_bwd_fixed " + json.dumps({
                "dtype": dt, "us_per_step": slope * 1e3,
                "fixed_us": (by_t[41] - slope * 42) * 1e3, "card": card}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
