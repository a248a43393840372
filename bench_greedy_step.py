#!/usr/bin/env python3
"""Where a step of the one-launch greedy decode (K9) spends its time.

    python3 bench_greedy_step.py [--out PARTS.json]

Builds `rnn_transducer_tpu_torch/csrc/greedy_fused.cu` as it is (`full`)
and with clock64() stamps (`phases`), then times the cluster kernel of
each build at libri100's width (E = H = J = 512, V = 1024, f32 weights,
bf16 activations) on one CUDA card, in turns, with as many utterances as
the card holds clusters at once (at most 8), so that every row runs in
the first wave:

  blank   every step blank (b_out[blank] raised by 1e4): every row runs
          T steps; T = 100, 200, 400, 800, and a line through the device
          ms against T: µs a blank step and the fixed cost of a call
  emit    every step an emission (b_out[blank] lowered by 1e4): every row
          runs max_symbols steps on frame 0; max_symbols = 25, 50, 100,
          200: µs an emission step (the step and the prediction network),
          with as many utterances as above and with one (`emit_1`: no
          other cluster reads the weights from L2 at the same time)
  paced   T = 400 frames with one emission every 40, 20, 13, 8 or 5
          frames, or none (`paced_inputs`): 0-80 emissions a row between
          blank steps, as a trained model emits; the device ms against
          the emissions a row, beside what the blank and emit fits give

`phases`: thread 0 of every block reads clock64() at a step's phase
boundaries and sums the cycles of each phase: `f` (the loop's top: the
prefetch of the row two frames ahead), `z` (z over J and a block barrier,
where no warp formed it a frame ahead: after an emission), `chain`
(thread 0's logit: its in-order fmaf chain over J from shared memory),
`stores` (the warps' argmax by redux.sync, a block barrier and their
st.async stores into the 16 blocks), `exchange` (the wait on the block's
own mbarrier until every block's candidates have landed: the exchange's
latency and the wait for the slowest block), `reduce` (every warp's
reduction of the candidates), `emission` (the prediction network); and
an emission's own phases, in cycles an emission: `e` (the embedding row,
the sums' zeroing, a block barrier), `gates` (the gate columns' chunks
through the ring and their chains), `cell` (the cell and rd(h)'s remote
stores), `barrier_h`, `g` (W_pred's chains), `g_scatter`, `barrier_g`
(with the ring's priming for the next emission). The sums go to device
arrays that an added entry point copies out. A
phase's time a step is its share of the cycles times the phases build's
own µs a step. The stamps cost what `full` and `phases` differ by.
Prints one JSON line per build and case, and writes them all to --out if
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

from rnn_transducer_tpu_torch.decode import greedy_fused as gf
from rnn_transducer_tpu_torch.utils import build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "rnn_transducer_tpu_torch", "csrc", "greedy_fused.cu")
PHASES = ("f", "z", "chain", "stores", "exchange", "reduce", "emission")
EMISSION = ("e", "gates", "cell", "barrier_h", "g", "g_scatter",
            "barrier_g")
MAX_BLOCKS = 1024
PERIODS = (0, 40, 20, 13, 8, 5)  # frames an emission; 0: none
E = H = J = 512
V = 1024
STAMP = ("    if (threadIdx.x == 0) {{ const long long n_ = clock64(); "
         "ph_[{i}] += n_ - mark_; mark_ = n_; }}\n")
ESTAMP = ("  if (threadIdx.x == 0) {{ const long long n_ = clock64(); "
          "g_ephase[blockIdx.x][{i}] += n_ - em_; em_ = n_; }}\n")
# (anchor, replacement) pairs: each anchor must occur once
PATCHES = (
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_phase["
     f"{MAX_BLOCKS}][8];\n__device__ unsigned long long g_ephase["
     f"{MAX_BLOCKS}][8];\n"),
    ("  const Smem& s = x.s;\n  const int U4 = 4 * q.U;\n",
     "  const Smem& s = x.s;\n  const int U4 = 4 * q.U;\n"
     "  long long em_ = clock64();\n"),
    ("  __syncthreads();\n  const float* h_in = ",
     "  __syncthreads();\n" + ESTAMP.format(i=0) + "  const float* h_in = "),
    ("  // the cell of the block's units; rd(h) into every block's h_out\n",
     ESTAMP.format(i=1)
     + "  // the cell of the block's units; rd(h) into every block's h_out\n"),
    ("  cluster_sync();\n  // the block's joint units",
     ESTAMP.format(i=2) + "  cluster_sync();\n" + ESTAMP.format(i=3)
     + "  // the block's joint units"),
    ("  for (int n = threadIdx.x; n < q.JU; n += kThreads) {\n"
     "    const float v = s.pa[n] + s.bp[n];",
     ESTAMP.format(i=4)
     + "  for (int n = threadIdx.x; n < q.JU; n += kThreads) {\n"
     "    const float v = s.pa[n] + s.bp[n];"),
    ("  x.seq += st.total;\n  ++x.ne;\n",
     ESTAMP.format(i=5) + "  x.seq += st.total;\n  ++x.ne;\n"),
    ("  if (q.wo_res) st.prime(x.ring, x.seq);\n}\n",
     "  if (q.wo_res) st.prime(x.ring, x.seq);\n" + ESTAMP.format(i=6)
     + "  if (threadIdx.x == 0) g_ephase[blockIdx.x][7] += 1;\n}\n"),
    ("  x.emit.prime(x.ring, x.seq);\n  int* toks",
     "  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 8; ++i) g_ephase[blockIdx.x][i] = 0;\n  }\n"
     "  x.emit.prime(x.ring, x.seq);\n  int* toks"),
    ("  int t = 0, u = 0, it = 0;\n",
     "  int t = 0, u = 0, it = 0;\n"
     "  long long ph_[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  long long mark_ = clock64();\n"),
    ("    if (!z_valid) {\n",
     STAMP.format(i=0) + "    if (!z_valid) {\n"),
    ("    const bool pre = ahead && t + 1 < len;\n",
     STAMP.format(i=1) + "    const bool pre = ahead && t + 1 < len;\n"),
    ("    unsigned long long* slots = s.cand + (size_t)(it & 1) * NS;\n",
     STAMP.format(i=2)
     + "    unsigned long long* slots = s.cand + (size_t)(it & 1) * NS;\n"),
    ("    unsigned cphase = (unsigned)(it >> 1) & 1u;\n"
     "    tma_bulk::mbar_wait(cbar, cphase);\n",
     STAMP.format(i=3) + "    unsigned cphase = (unsigned)(it >> 1) & 1u;\n"
     "    tma_bulk::mbar_wait(cbar, cphase);\n" + STAMP.format(i=4)),
    ("    const int k = best_i;\n",
     "    const int k = best_i;\n" + STAMP.format(i=5)),
    ("      emission(p, q, x, k);\n",
     "      emission(p, q, x, k);\n" + STAMP.format(i=6)),
    ("  if (r == 0 && threadIdx.x == 0) p.steps[b] = it;\n",
     "  if (r == 0 && threadIdx.x == 0) p.steps[b] = it;\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 7; ++i) g_phase[blockIdx.x][i] = ph_[i];\n"
     "    g_phase[blockIdx.x][7] = it;\n  }\n"),
)
TAIL = """
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""
PHASE_TAIL = """
extern "C" int greedy_phase_cycles(void* out, int n_blocks) {
  cudaError_t e = cudaMemcpyFromSymbol(
      out, g_phase, (size_t)n_blocks * 8 * sizeof(long long));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(
      static_cast<long long*>(out) + (size_t)n_blocks * 8, g_ephase,
      (size_t)n_blocks * 8 * sizeof(long long));
}
"""


def variant_source(name: str) -> str:
    with open(SRC) as f:
        src = f.read()
    if name == "phases":
        for old, new in PATCHES:
            if src.count(old) != 1:
                raise SystemExit(f"bench_greedy_step: the pattern {old!r} is "
                                 "not in greedy_fused.cu once; update PATCHES")
            src = src.replace(old, new)
        src += PHASE_TAIL
    return src + TAIL


def build_variants(workdir: str) -> dict[str, ctypes.CDLL]:
    """One nvcc per build, started together, each into its own library."""
    nvcc = build._nvcc()
    cmds, sos = [], {}
    for name in ("full", "phases"):
        cu = os.path.join(workdir, f"greedy_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        sos[name] = os.path.join(workdir, f"greedy_{name}.so")
        cmds.append([nvcc, *build.NVCC_FLAGS, "-I", os.path.dirname(SRC),
                     "-shared", "-o", sos[name], cu])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for c, p in zip(cmds, procs):
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed: {' '.join(c)}\n{out}")
        for line in out.splitlines():
            if "ptxas info" in line and "Used" in line:
                print(f"{os.path.basename(c[-1])}: {line.strip()}")
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        for fn in ("greedy_cluster", "kernel_error_string"):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = (
                build.SIGNATURES[fn])
        if name == "phases":
            lib.greedy_phase_cycles.restype = ctypes.c_int
            lib.greedy_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def inputs(B: int, T: int, blank_bias: float, dev):
    """f (B, T, J), lens = T and the f32 weights of a random predictor and
    joint (the card tests' scales), b_out[blank] moved by blank_bias."""
    g = torch.Generator().manual_seed(0)

    def u(*s, k):
        return (torch.rand(*s, generator=g) * 2 - 1) * k

    f = 0.5 * torch.randn(B, T, J, generator=g)
    bo = u(V, k=J ** -0.5)
    bo[0] += blank_bias
    weights = (torch.randn(V, E, generator=g), u(E, 4 * H, k=H ** -0.5),
               u(H, 4 * H, k=H ** -0.5), u(4 * H, k=H ** -0.5),
               u(H, J, k=H ** -0.5), u(J, k=H ** -0.5), u(J, V, k=J ** -0.5),
               bo)
    return (f.to(dev), torch.full((B,), T, dtype=torch.int32, device=dev),
            tuple(w.contiguous().to(dev) for w in weights))


def paced_inputs(B: int, T: int, period: int, dev):
    """`inputs` with one emission every `period` frames (none at 0): the
    predictor's state after token 1 (or the start symbol) and after token
    2 sets g_0 to about +10 and -10 and g_1 to the opposite (W_hh's input
    saturated away); f_0 is +10 on frames 0, 2p, 4p, .. and f_1 on frames
    p, 3p, ..; either is -10 elsewhere. W_out's logit of token 2 is 1000
    z_0 and of token 1 1000 z_1, blank's 500: so z_0 = tanh(f_0 + g_0)
    nears 1, and token 2 wins, on an even frame after token 1 and nowhere
    else, and token 1 on an odd frame after token 2. Each such frame
    emits once and then its blank; the rest are blank steps. Every row
    runs T + ceil(T / period) steps, the rest of the weights random."""
    f, lens, w = inputs(B, T, 0.0, dev)
    embed, w_ih, w_hh, b, wp, bp, wo, bo = (x.clone() for x in w)
    embed[:, 0] = 1.0          # the start symbol and token 1: state A
    embed[2, 0] = -1.0         # token 2: state B
    w_ih[0, 2 * H] = 20.0      # unit 0's cell input tanh(+-20)
    b[0] = b[3 * H] = 20.0     # unit 0's input and output gates open
    b[H] = -20.0               # its forget gate shut: c_0 = +-1
    wp[0, 0], wp[0, 1] = 13.0, -13.0  # g_0 = 13 h_0 ~ +-9.9, g_1 = -g_0
    wo[:2] = 0.0
    wo[0, 2] = wo[1, 1] = 1000.0
    bo[:] = 0.0
    bo[0] = 500.0
    f[:, :, :2] = -10.0
    if period:
        f[:, 0::2 * period, 0] = 10.0
        f[:, period::2 * period, 1] = 10.0
    return f, lens, (embed, w_ih, w_hh, b, wp, bp, wo, bo)


def device_ms(call, reps: int) -> float:
    """Device ms of one call: `reps` calls queued behind a spin kernel."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fit(xs, ys) -> tuple[float, float]:
    """Slope and intercept of the least-squares line through (xs, ys)."""
    mx, my = statistics.mean(xs), statistics.mean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return slope, my - slope * mx


def run_case(libs, case: str, dev, reps: int) -> list[dict]:
    """Both builds over the case's sizes, in turns full, phases, phases,
    full; the line fits; the phases build's cycle split at the middle
    size."""
    sizes = (100, 200, 400, 800) if case == "blank" else (25, 50, 100, 200)
    plan = gf.cluster_plan(E, H, J, V)
    B = 1 if case == "emit_1" else min(8, gf.device_clusters(plan, dev))
    ms = {name: {n: [] for n in sizes} for name in libs}
    split = None
    for n in sizes:
        T, U_max = (n, 100) if case == "blank" else (1000, n)
        f, lens, weights = inputs(B, T, 1e4 if case == "blank" else -1e4,
                                  dev)
        packed = gf.pack_weights(weights, plan)

        def call(lib):
            return gf.launch_cluster(lib, f, lens, weights, packed, plan,
                                     U_max, 0, torch.bfloat16)
        _, steps = call(libs["full"])
        torch.cuda.synchronize()
        if not bool((steps == n).all()):
            raise SystemExit(f"{case}: rows ran {steps.tolist()} steps, "
                             f"not {n}")
        for name in ("full", "phases", "phases", "full"):
            ms[name][n].append(device_ms(lambda: call(libs[name]), reps))
        if n == sizes[2]:
            call(libs["phases"])
            torch.cuda.synchronize()
            cyc = torch.zeros(2, B * plan.C, 8, dtype=torch.int64)
            err = libs["phases"].greedy_phase_cycles(cyc.data_ptr(),
                                                     B * plan.C)
            if err:
                raise SystemExit(f"greedy_phase_cycles failed ({err})")
            per = cyc[0, :, :7].double() / cyc[0, :, 7:].double()  # a step
            # an emission (the first, on the start symbol, included)
            per_e = cyc[1, :, :7].double() / cyc[1, :, 7:].double()
            split = {"size": n, "cycles_per_step": dict(zip(
                PHASES, per.mean(0).tolist())),
                "cycles_per_step_max_block": dict(zip(
                    PHASES, per.max(0).values.tolist())),
                "cycles_per_emission": dict(zip(
                    EMISSION, per_e.mean(0).tolist()))}
    rows = []
    for name in libs:
        means = [statistics.mean(ms[name][n]) for n in sizes]
        slope, icept = fit(sizes, means)
        row = {"build": name, "case": case, "B": B, "E": E, "H": H, "J": J,
               "V": V, "sizes": sizes, "ms": means,
               "us_a_step": slope * 1e3, "fixed_us": icept * 1e3}
        if name == "phases" and split:
            cyc = split["cycles_per_step"]
            total = sum(cyc.values())
            row.update(split)
            row["phase_us_per_step"] = {k: v / total * slope * 1e3
                                        for k, v in cyc.items()}
            row["cycles_per_us"] = total / (slope * 1e3)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def run_paced(libs, dev, reps: int, rows: list[dict]) -> dict:
    """The `full` build at T = 400 frames with one emission every
    PERIODS frames (`paced_inputs`), and the line through the device ms
    against the emissions a row; beside each, the time that the `blank`
    and `emit` rows' fits give for T blank steps and that many
    emissions."""
    T = 400
    plan = gf.cluster_plan(E, H, J, V)
    B = min(8, gf.device_clusters(plan, dev))
    blank = next(r for r in rows if r["build"] == "full"
                 and r["case"] == "blank")
    emit = next(r for r in rows if r["build"] == "full"
                and r["case"] == "emit")
    emissions, ms, fitted = [], [], []
    for period in PERIODS:
        n = -(-T // period) if period else 0
        f, lens, weights = paced_inputs(B, T, period, dev)
        packed = gf.pack_weights(weights, plan)

        def call():
            return gf.launch_cluster(libs["full"], f, lens, weights, packed,
                                     plan, 100, 0, torch.bfloat16)
        tokens, steps = call()
        torch.cuda.synchronize()
        if not (bool((steps == T + n).all())
                and bool(((tokens != 0).sum(1) == n).all())):
            raise SystemExit(f"paced {period}: rows ran {steps.tolist()} "
                             f"steps, not {T + n} with {n} emissions")
        emissions.append(n)
        ms.append(statistics.mean(device_ms(call, reps) for _ in range(2)))
        fitted.append((blank["fixed_us"] + T * blank["us_a_step"]
                       + n * emit["us_a_step"]) / 1e3)
    slope, icept = fit(emissions, ms)
    row = {"build": "full", "case": "paced", "B": B, "T": T,
           "periods": PERIODS, "emissions": emissions, "ms": ms,
           "ms_from_fits": fitted, "us_an_emission": slope * 1e3,
           "ms_no_emission": icept}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="also write the rows to this JSON file")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_greedy_step: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"card: {card}")
    build.load_library()  # the pack
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        libs = build_variants(workdir)
        for case in ("blank", "emit", "emit_1"):
            rows += run_case(libs, case, dev, args.reps)
        rows.append(run_paced(libs, dev, args.reps, rows))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
