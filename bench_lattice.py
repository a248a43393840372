#!/usr/bin/env python3
"""Where a diagonal of the RNN-T lattice kernels (K3: alpha, and beta with
the occupancies) spends its time.

    python3 bench_lattice.py [--src LATTICE_CU] [--out PARTS.json]
                             [--shapes B,T,U ...]

Builds `rnn_transducer_tpu_torch/csrc/lattice.cu` (or the file given by
--src, such as an older checkout's) as it is and in variants that each
drop one part of a diagonal, then times one launch of every build (for
the walk design, one launch a column tile where the port walks the
lattice in tiles) at the training step's lattices (B=32, T'=200, U+1 = 41
and 101) or at --shapes, in turns, on one CUDA card. The ablated variants compute wrong values on purpose and
serve only as clocks; the port never loads any of them. The variants
follow the design the source holds:

  one block a lattice, a block barrier a diagonal (the design before the
  band walk):
    full        the kernel as it is
    no_load     the scores are constants, not loads from global memory
    no_barrier  the __syncthreads of each diagonal dropped
    no_lae      each log-add-exp is a max (no expf, no log1pf)
    clock       the full kernel with clock64() read by thread 0 around
                each diagonal's barrier: cycles of the walk and of the
                barrier waits, written over the first cells of each
                lattice's output

  up to four walker warps walk a lattice over bands of its columns, while
  the block's other warps stage the scores and write the results out (the
  design that replaced it):
    full        the kernel as it is
    no_wait     no warp waits for another's chunks (the walk reads
                whatever the ring holds)
    no_lae      each log-add-exp is a max
    no_writes   the writer warps store no alpha / beta cell
    no_shfl     each shuffle returns the lane's own value
    no_hand     a band's edge is read without waiting for its diagonal
    no_copies   the staging warps issue no copy (the walk reads stale
                scores)
    clock       the full kernel with clock64() read by the first walker's
                lane 0: cycles of its walk and of its waits for staged
                chunks
    split       clock64() read by lane 0 of the walker that reads a band
                edge (alpha's last, beta's first): cycles of its walk, of
                its waits for staged chunks, of its handoff reads, and
                from the issue of a diagonal's step (its shuffles and
                log-add-exp chains) to the issue of what follows it
    chain       a micro-kernel beside the walk: one warp's chain of
                dependent walk cells (lae_cell) alone, with a shuffle a
                step, and two cells with two shuffles a step, in clock64
                cycles a step: the floor a diagonal cannot beat

A part's cost a diagonal is (full - variant) / diagonals; the clock
variant gives the walk's cycles a diagonal (the chain floor of the walk,
with the card's clock). beta's launch is timed with and without the
occupancies (alpha given or not): the difference is its occupancy pass.
Prints one JSON line per shape and kernel, and writes them all to --out if
given. Needs a CUDA card and nvcc.
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

from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat
from rnn_transducer_tpu_torch.utils import build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "rnn_transducer_tpu_torch", "csrc", "lattice.cu")

# ----- one block a lattice, a block barrier a diagonal -----
B_ALPHA_LOADS = ("        const float below =\n"
                 "            prev[u] + (t >= 1 ? lpb[cell - U1] : kNegInf);\n"
                 "        const float left = (u >= 1) ? prev[u - 1] + "
                 "lpy[cell - 1] : kNegInf;\n")
B_BETA_LOADS = ("        const float down = lpb[cell] + nxt[u];\n"
                "        const float right =\n"
                "            lpy[cell] + (u + 1 < U1 ? nxt[u + 1] : "
                "kNegInf);\n"
                "        v = fmaxf(lae(lae(accept[cell], down), right), "
                "kNegInf);\n")
B_ALPHA_SYNC = "    __syncthreads();\n    float* tmp = prev;\n"
B_BETA_SYNC = "    __syncthreads();\n    float* tmp = nxt;\n"
LAE = "  const float out = mx + log1pf(expf(mn - mx));\n"
B_CLOCK_SYNC = ("    long long c0 = clock64();\n    __syncthreads();\n"
                "    wait_cycles += clock64() - c0;\n")
B_ALPHA_LOOP = "  const int D = T + U1 - 1;\n  for (int d = 1; d < D; ++d) {\n"
B_BETA_LOOP = ("  const int D = T + U1 - 1;\n"
               "  for (int d = D - 1; d >= 0; --d) {\n")
CLOCK_START = ("  long long walk0 = clock64();\n"
               "  long long wait_cycles = 0;\n")
B_ALPHA_END = ("    prev = cur;\n    cur = tmp;\n  }\n}\n")
B_BETA_END = "  if (alpha == nullptr) return;\n"
CLOCK_OUT = ("  if (threadIdx.x == 0) {{\n"
             "    unsigned int* o = reinterpret_cast<unsigned int*>({arr});\n"
             "    o[0] = (unsigned int)(clock64() - walk0);\n"
             "    o[1] = (unsigned int)wait_cycles;\n  }}\n")
BLOCK_VARIANTS = {
    "full": (),
    "no_load": ((B_ALPHA_LOADS, B_ALPHA_LOADS.replace(
        "lpb[cell - U1]", "-0.5f").replace("lpy[cell - 1]", "-0.5f")),
                (B_BETA_LOADS, B_BETA_LOADS.replace("lpb[cell]", "-0.5f")
                 .replace("lpy[cell]", "-0.5f")
                 .replace("accept[cell]", "-0.5f"))),
    "no_barrier": ((B_ALPHA_SYNC, "    float* tmp = prev;\n"),
                   (B_BETA_SYNC, "    float* tmp = nxt;\n")),
    "no_lae": ((LAE, "  const float out = mx;\n"),),
    "clock": ((B_ALPHA_LOOP, CLOCK_START + B_ALPHA_LOOP),
              (B_BETA_LOOP, CLOCK_START + B_BETA_LOOP),
              (B_ALPHA_SYNC, B_CLOCK_SYNC + "    float* tmp = prev;\n"),
              (B_BETA_SYNC, B_CLOCK_SYNC + "    float* tmp = nxt;\n"),
              (B_ALPHA_END, "    prev = cur;\n    cur = tmp;\n  }\n"
               + CLOCK_OUT.format(arr="alpha") + "}\n"),
              (B_BETA_END, CLOCK_OUT.format(arr="beta") + B_BETA_END)),
}
BLOCK_MARK = "prev[u] + (t >= 1 ? lpb[cell - U1] : kNegInf)"

# ----- walker warps over bands, the scores staged and the results written
# by the block's other warps -----
W_WAIT = "    mbar_wait(full_bar(m, slot), (unsigned)((ch / p.slots) & 1));\n"
W_WRITTEN_WAIT = ("      mbar_wait(written_bar(m, p, slot), "
                  "(unsigned)((c / p.slots - 1) & 1),\n"
                  "                true);\n")
W_WALKED_WAIT = ("    mbar_wait(walked_bar(m, p, slot), "
                 "(unsigned)((c / p.slots) & 1), true);\n")
W_WRITE = ("        out[(size_t)t * a.ld + u] = "
           "base[(size_t)i * A * m.pitch + u];\n")
W_LOOP = ("  const int chunks = (steps + p.chunk - 1) / p.chunk;\n"
          "  for (int ch = 0; ch < chunks; ++ch) {\n")
W_END = "  if (kBeta && w == 0 && lane == 0) *m.log_z = c(0);\n"
W_CLOCK_WAIT = ("    long long c0 = clock64();\n" + W_WAIT
                + "    wait_cycles += clock64() - c0;\n")
# warp 0's cycles over the first words of alpha, the last of beta (the
# writers store beta's first cells last)
W_CLOCK_OUT = CLOCK_OUT.format(
    arr="out + (kBeta ? (size_t)T * U1 - 2 : 0)")
# the split variant: the stamps of the walker that reads an edge (alpha's
# last band, beta's first) over four words of the output
W_HAND_READ = "        float edge = reads ? hand_get(hand_in, d) : kNegInf;\n"
W_ALPHA_STEP = ("        alpha_step<K>(c, cur, edge, col, kk, band, lane, "
                "d + 1, T, U1, res);\n")
W_BETA_STEP = (
    "        if (accepts_on<K>(cur, kk, band, lane, d, T, U1)) {\n"
    "          beta_step<K, true>(c, cur, edge, col, kk, band, lane, d, T, "
    "U1,\n"
    "                             res);\n"
    "        } else {\n"
    "          beta_step<K, false>(c, cur, edge, col, kk, band, lane, d, T, "
    "U1,\n"
    "                              res);\n"
    "        }\n")
SPLIT_START = CLOCK_START + "  long long hand_cycles = 0, step_cycles = 0;\n"
STEP0 = "        long long s0 = clock64();\n"
STEP1 = "        step_cycles += clock64() - s0;\n"
SPLIT_OUT = (
    "  if ((kBeta ? w == 0 : w == p.warps - 1) && lane == 0) {\n"
    "    unsigned int* o = reinterpret_cast<unsigned int*>(\n"
    "        out + (kBeta ? (size_t)T * U1 - 4 : 0));\n"
    "    o[0] = (unsigned int)(clock64() - walk0);\n"
    "    o[1] = (unsigned int)wait_cycles;\n"
    "    o[2] = (unsigned int)hand_cycles;\n"
    "    o[3] = (unsigned int)step_cycles;\n  }\n")
W_LAE = "  const float out = mx + log1p_nonneg(expf(mn - mx));\n"
W_SHFL = (("__shfl_sync(kFull, c(n - 1) + s(1, n - 1), down)",
           "(c(n - 1) + s(1, n - 1))"),
          ("__shfl_sync(kFull, c(j - 1) + s(1, j - 1), down)",
           "(c(j - 1) + s(1, j - 1))"),
          ("__shfl_sync(kFull, c(0), up)", "c(0)"),
          ("__shfl_sync(kFull, c(j + 1), up)", "c(j + 1)"))
W_HAND = "  } while (static_cast<int>(w >> 32) != d);\n"
W_COPY = ('        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" '
          '::"r"(dst),\n'
          '                     "l"(src[arr] + (size_t)t * a.ld + u)\n'
          '                     : "memory");\n')
# a micro-kernel: one warp's chain of n dependent walk cells (lae_cell), in
# mode 0 alone, in mode 1 with a shuffle a step, in mode 2 two cells and two
# shuffles a step; its clock64 cycles a lane
CHAIN = r"""
extern "C" __global__ void lae_chain_kernel(float* vals, long long* cycles,
                                            int n, int mode) {
  const int lane = threadIdx.x;
  const int down = (lane + 31) & 31;
  float a = vals[lane], b = vals[32 + lane], c2 = vals[64 + lane], a2 = a;
  const long long t0 = clock64();
  if (mode == 0) {
    for (int i = 0; i < n; ++i) a = lae_cell(a, b, true);
  } else if (mode == 1) {
    for (int i = 0; i < n; ++i) {
      a = lae_cell(a + b, __shfl_sync(kFull, a + c2, down), true);
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const float y0 = __shfl_sync(kFull, a + c2, down);
      const float y1 = __shfl_sync(kFull, a2 + c2, down);
      a = lae_cell(a + b, y0, true);
      a2 = lae_cell(a2 + b, y1, true);
    }
  }
  const long long t1 = clock64();
  vals[96 + lane] = a + a2;
  cycles[lane] = t1 - t0;
}

extern "C" int lae_chain(void* vals, void* cycles, int n, int mode,
                         void* stream) {
  lae_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(vals), static_cast<long long*>(cycles), n, mode);
  return (int)cudaGetLastError();
}
"""
WARP_VARIANTS = {
    "full": (),
    "no_wait": ((W_WAIT, ""), (W_WRITTEN_WAIT, ""), (W_WALKED_WAIT, "")),
    "no_lae": ((W_LAE, "  const float out = mx;\n", 2),),
    "no_writes": ((W_WRITE, "        (void)base;\n"),),
    "no_shfl": W_SHFL,
    "no_hand": ((W_HAND, "  } while (false);\n"),),
    "no_copies": ((W_COPY, "        (void)dst;\n"),),
    "clock": ((W_LOOP, CLOCK_START + W_LOOP), (W_WAIT, W_CLOCK_WAIT),
              (W_END, W_CLOCK_OUT + W_END)),
    "split": ((W_LOOP, SPLIT_START + W_LOOP), (W_WAIT, W_CLOCK_WAIT),
              (W_HAND_READ, "        long long h0 = clock64();\n"
               + W_HAND_READ + "        hand_cycles += clock64() - h0;\n",
               2),
              (W_ALPHA_STEP, STEP0 + W_ALPHA_STEP + STEP1),
              (W_BETA_STEP, STEP0 + W_BETA_STEP + STEP1),
              (W_END, SPLIT_OUT + W_END)),
    "chain": ((None, CHAIN),),
}
WARP_MARK = "lae_from_masked"
TILE_MARK = "int edge;"

# (B, T, U): the fused and the pruned step's lattices
SHAPES = ((32, 200, 40), (32, 200, 100))


def design(src: str) -> tuple[str, dict]:
    """The design of a lattice.cu source and its variants."""
    if BLOCK_MARK in src:
        return "block", BLOCK_VARIANTS
    if WARP_MARK in src and TILE_MARK in src:
        return "warp", WARP_VARIANTS
    if WARP_MARK in src:
        raise SystemExit("bench_lattice: a walk from before column tiles; "
                         "time it with the bench_lattice.py of its checkout")
    raise SystemExit("bench_lattice: the source holds no design this script "
                     "knows; update its variants")


def variant_source(src: str, patches) -> str:
    """The source with each (old, new[, times]) patch applied: `old` must
    occur `times` (default 1) times; old None appends `new`."""
    for old, new, *times in patches:
        if old is None:
            src += new
            continue
        if src.count(old) != (times[0] if times else 1):
            raise SystemExit(f"bench_lattice: the pattern {old!r} is not in "
                             "lattice.cu as often as the variant needs; "
                             "update the variants")
        src = src.replace(old, new)
    return src


def build_variants(src_path: str, workdir: str) -> tuple[str, dict]:
    """One nvcc per variant, all started together, each into its own
    shared library."""
    with open(src_path) as f:
        src = f.read()
    name_of_design, variants = design(src)
    nvcc = build._nvcc()
    cmds, libs = [], {}
    for name, patches in variants.items():
        try:
            text = variant_source(src, patches)
        except SystemExit as e:
            if name == "full":
                raise
            print(f"skipped variant {name}: {e}")
            continue
        cu = os.path.join(workdir, f"lattice_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(workdir, f"lattice_{name}.so")
        cmds.append([nvcc, *build.NVCC_FLAGS, "-I",
                     os.path.dirname(os.path.abspath(src_path)), "-shared",
                     "-o", so, cu])
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
        for fn in (("lattice_alpha", "lattice_beta")
                   if name_of_design == "block" else
                   ("lattice_alpha", "lattice_beta", "lattice_occupancy")):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = (
                build.SIGNATURES[fn] if name_of_design != "block"
                else BLOCK_SIGNATURES[fn])
        if name_of_design != "block":  # check_launch's message, here
            lib.kernel_error_string = lambda err: b"a CUDA error"
        if name == "chain":
            lib.lae_chain.restype = _I
            lib.lae_chain.argtypes = [_P, _P, _I, _I, _P]
        out[name] = lib
    return name_of_design, out


_P, _I = ctypes.c_void_p, ctypes.c_int
BLOCK_SIGNATURES = {
    # lp_blank_m, lp_y_m, alpha, B, T, U1, device, stream
    "lattice_alpha": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    # lp_blank_m, lp_y_m, accept, alpha, frame_lens, beta, g_blank, g_y,
    # B, T, U1, device, stream
    "lattice_beta": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P]),
}


def inputs(B: int, T: int, U: int, dev):
    from rnn_transducer_tpu_torch.bench_band_bwd_b import lattice_problem

    return lattice_problem(B, T, U, dev)


def launch(lib, which: str, design_name: str, args, dev):
    """One launch of `which` ("alpha", "beta" or "beta_occ"); its outputs.
    The walk design launches as the port does: one launch, or one a column
    tile of `tile_plan` (and the occupancies after the tiles)."""
    lpb, lpy, acc, fl = args
    alpha = torch.zeros_like(lpb)
    occ = which == "beta_occ"
    if design_name != "block":
        if which == "alpha":
            return [lat._launch_alpha(lib, lpb, lpy)]
        return list(lat._launch_beta(lib, lpb, lpy, acc,
                                     alpha if occ else None,
                                     fl if occ else None))
    B, T, U1 = lpb.shape
    out = [torch.empty_like(lpb) for _ in range(3)]
    stream = build.stream_args(dev)
    if which == "alpha":
        err = lib.lattice_alpha(lpb.data_ptr(), lpy.data_ptr(),
                                out[0].data_ptr(), B, T, U1, *stream)
    else:
        err = lib.lattice_beta(
            lpb.data_ptr(), lpy.data_ptr(), acc.data_ptr(),
            alpha.data_ptr() if occ else None,
            fl.data_ptr() if occ else None, out[0].data_ptr(),
            out[1].data_ptr() if occ else None,
            out[2].data_ptr() if occ else None, B, T, U1, *stream)
    if err:
        raise SystemExit(f"lattice_{which} launch failed ({err})")
    return out


def launch_ms(lib, which, design_name, args, dev, reps: int) -> list[float]:
    """Kernel ms of `reps` launches, each timed alone by CUDA events,
    after a warm one."""
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(lib, which, design_name, args, dev)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times[1:]


def clock_cycles(lib, which, design_name, args, dev,
                 names=("walk", "wait")) -> dict:
    """A clock variant's cycles a lattice (the mean over the lattices),
    one for each of `names`, read from as many words of each lattice's
    output: the first, or for the band design's beta the last."""
    out = launch(lib, which, design_name, args, dev)[0]
    torch.cuda.synchronize()
    B = out.shape[0]
    flat = out.reshape(B, -1)
    last = design_name == "warp" and which != "alpha"
    n = len(names)
    words = (flat[:, -n:] if last else flat[:, :n]).contiguous().view(
        torch.int32)
    words = words.to(torch.int64) & 0xFFFFFFFF
    return {f"{name}_cycles": words[:, i].double().mean().item()
            for i, name in enumerate(names)}


def chain_cycles(lib, dev, n: int = 4096) -> dict:
    """clock64 cycles a step of the chain micro-kernel in its three modes
    (one cell; one cell and a shuffle; two cells and two shuffles), the
    mean over the lanes of the second of two launches."""
    g = torch.Generator().manual_seed(0)
    out = {}
    for mode, name in enumerate(("cell", "cell_shfl", "two_cells_shfl")):
        vals = torch.cat([-5 - torch.rand(32, generator=g),
                          -0.7 - 0.1 * torch.rand(64, generator=g),
                          torch.zeros(32)]).to(dev)
        cycles = torch.zeros(32, dtype=torch.int64, device=dev)
        for _ in range(2):
            err = lib.lae_chain(vals.data_ptr(), cycles.data_ptr(), n, mode,
                                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise SystemExit(f"lae_chain launch failed ({err})")
        torch.cuda.synchronize()
        out[name] = cycles.double().mean().item() / n
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", default=SRC)
    p.add_argument("--out", default=None,
                   help="also write the rows to this JSON file")
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--shapes", nargs="+", default=None, metavar="B,T,U",
                   help="lattices to time in place of the training step's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_lattice: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    clock_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    rows = []
    with tempfile.TemporaryDirectory() as d:
        design_name, libs = build_variants(args.src, d)
        if "chain" in libs:
            row = {"chain_cycles_a_step": chain_cycles(libs.pop("chain"),
                                                       dev),
                   "max_sm_clock": clock_mhz, "card": card}
            print("lattice_chain " + json.dumps(row), flush=True)
            rows.append(row)
        timed = [k for k in libs if k not in ("clock", "split")]
        shapes = ([tuple(int(x) for x in sh.split(",")) for sh in args.shapes]
                  if args.shapes else SHAPES)
        for B, T, U in shapes:
            a = inputs(B, T, U, dev)
            diagonals = T + U
            for which in ("alpha", "beta", "beta_occ"):
                # a lattice the walk design takes in column tiles: the
                # full kernel alone (the variants and the clock stamps
                # are made for one launch a lattice)
                stamped = design_name == "block" or len(
                    lat.tile_plan(U + 1, which != "alpha")) == 1
                variants = timed if stamped else ["full"]
                ms = {k: [] for k in variants}
                # in turns: every variant, then every variant in reverse
                for order in (variants, variants[::-1]):
                    for k in order:
                        ms[k] += launch_ms(libs[k], which, design_name, a,
                                           dev, args.reps)
                med = {k: statistics.median(v) for k, v in ms.items()}
                clock = (clock_cycles(libs["clock"], which, design_name, a,
                                      dev) if stamped else {})
                split = (clock_cycles(libs["split"], which, design_name, a,
                                      dev, ("walk", "wait", "hand", "step"))
                         if "split" in libs and stamped else {})
                row = {"design": design_name, "kernel": which, "B": B,
                       "T": T, "U1": U + 1, "diagonals": diagonals,
                       "ms": med, "ms_min": {k: min(v) for k, v in
                                             ms.items()},
                       "ns_a_diagonal": {k: v / diagonals * 1e6
                                         for k, v in med.items()},
                       "part_ns_a_diagonal": {
                           k: (med["full"] - v) / diagonals * 1e6
                           for k, v in med.items() if k != "full"},
                       "clock": {**clock, **({
                           "walk_cycles_a_diagonal":
                           clock["walk_cycles"] / diagonals,
                           "wait_cycles_a_diagonal":
                           clock["wait_cycles"] / diagonals} if clock
                           else {})},
                       "split_cycles_a_diagonal": {
                           k: v / diagonals for k, v in split.items()},
                       "max_sm_clock": clock_mhz, "card": card}
                print("lattice_parts " + json.dumps(row), flush=True)
                rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
