#!/usr/bin/env python3
"""The band joint's kernels (K6-fwd, its log-probs; K6-A and K6-B, its dz
and dW / db), the fused joint's forward and backward (K1, K2), the LSTM
forward (K4-fwd), the W8A8 LSTM recurrence (K7), the one-launch greedy
decode (K9) and the training steps and served requests that run them,
timed on one CUDA card for one or more checkouts of this repository, in
turns.

    python3 -m rnn_transducer_tpu_torch.bench_band_bwd_b \
        [--trees DIR [DIR ...]] [--parts PART [PART ...]] [--out RESULTS.json]

run from the root of a checkout. Each tree runs in a process of its own,
in the order given (default: this checkout), so that two versions of the
kernels are compared on one card: pass `--trees OLD NEW NEW OLD`. A
process puts the tree's root first on the import path (its package and
its chip_smoke.py), builds that tree's kernels, then runs the parts
(default: all fifteen, in this order):

  band_fwd     holds `band_lp_fwd` (lp_blank, lp_y, base) against its
               plain version at the pruned step's band (B=32, T'=200, S=8,
               J=512, bf16) with V=8192, at the AR step's V=1024, and at
               V=256 and 64 (max |err|, two runs bit for bit, the
               outputs' sha256 digests), and times it: device ms a call
               behind a spin kernel, g_w cycled through copies three times
               the L2's size; where the tree's wrapper takes `events`, its
               W^T pass and ring kernel apart; then a line through its
               time against its chunks of 64 columns (`chunk_fit`: µs a
               chunk and outside the loop over chunks, a block);
  band_bwd_a   the same for `band_lp_bwd_a` (df, dg_w; max |err| over the
               largest |value|), its W^T pass and main launch apart;
  band_bwd_b   the same for `band_lp_bwd_b` (dW, db) at V=8192 and 1024,
               with `events` its zb pass and main launch apart;
  pruned_step  trains libri100 with V=8192, S=8, U=100 at B=32, T=400
               (chip_smoke.train_run: ms/step by the slope of two runs,
               and the mean of STEADY_STEPS steps, best of three), then
               profiles one step (device ms by kernel family, host and
               device ms by the step's spans);
  joint_fwd    holds `joint_lp_fwd` (K1) against its plain version at the
               libri100 joint's cells (B=32, T'=200, U+1=41, J=512) with
               V=1024 in bf16 and f32, and in bf16 at V=512, 256 and 64
               (max |err|, two runs bit for bit, the outputs' sha256
               digests), and times it: device ms a call behind a spin
               kernel, f cycled through copies three times the L2's size;
               where the tree's wrapper takes `events`, its W^T pass and
               ring kernel apart; then `chunk_fit` over the bf16 rows;
  joint_bwd    holds `joint_lp_bwd` (K2) against its plain version at the
               libri100 joint (B=32, T'=200, U+1=41, J=512, V=1024), bf16
               and f32, with ragged lengths and the real lattice's
               occupancies, and times it: device ms a call behind a spin
               kernel, and by torch.profiler its kernels by name (kernel
               A, its W^T pass and ring kernel where it has them, kernel
               B, B's zb pass where it has one, the ordered sums); where
               the tree's wrapper takes `events`, kernel A, B's zb pass
               and main launch and the sums by CUDA events;
  train_step   trains libri100 at B=32, T=400, U=40 through the default
               (fused) loss, then profiles one step (as pruned_step);
  conformer_step  the same for libri100_conformer at B=64, T=400, U=40;
  lstm_fwd     holds `lstm_recurrence` (serving, without activations) at
               libri100's 800- and 400-frame buckets (l0_b800, l1_b800,
               l0_b400) and `lstm_recurrence_with_acts` (training) at
               l0_train, l1_train, pred_b32 and pred_b64 (chip_smoke's
               shapes), bf16 and f32, against their plain versions (max
               |err|, two runs bit for bit, the outputs' sha256
               digests), and times them: device ms a
               call behind a spin kernel, twice; where the tree has
               `fwd_plan`, the tile; then a line through the serving
               call's time at B=8 against T = 100, 200, 400, 800
               (`step_fit`: µs a step and the fixed cost of a call);
  lstm_int8    holds `lstm_recurrence_int8` (K7) at chip_smoke's
               INT8_CASES (l0_b800, l1_b800, b32_l1, b16_l1), bf16 and
               f32, against its
               plain version (max |err|, two runs bit for bit, the sha256
               digests of hs and c_T, which the parent's must equal),
               times it (device ms a call behind a spin kernel, twice),
               with its groups' tiles where the tree has
               `device_groups`; then `step_fit` of K7 at B=8, H=512 in
               bf16 and f32, and chip_smoke's 24 requests served to an
               engine holding quantize_params: p50, p95 and K7's calls;
  greedy_fused holds `greedy_fused_tokens` (K9) against its plain version
               at chip_smoke's served batch (B=8 utterances at the
               800-frame bucket, max_symbols 100) in bf16 and f32 (tokens
               and steps equal to the plain version's, two runs bit for
               bit, the sha256 digests of tokens and steps, which the
               parent's must equal), and times it at B = 1, 8 and 16 in
               bf16: device ms a call behind a spin kernel, twice, its
               kernels by name (torch.profiler), the longest row's steps
               and µs a step; where the tree has `cluster_plan`, the plan
               and the clusters the card holds at once;
  ar_step      trains the alignment-restricted band (ar_range 8) at
               libri100's B=32, T=400, U=40, then profiles one step;
  serve        serves chip_smoke's 24 requests at libri100 width to a
               BatchingEngine behind http_server: p50 and p95 latency and
               the LSTM forward's calls;
  fused_ln     holds `fln_fwd` and `fln_bwd` (K8) against the plain
               LayerNorm and its autograd at chip_smoke's LN_CASES (N =
               1600 and 6400 rows, D = 512; `ln_problem`), act none and
               silu (errors,
               two backward runs bit for bit, the sha256 digests of y, mu,
               rstd, dx, dg and db), and times both: device ms a call
               behind a spin kernel, x and dy cycled through copies three
               times the L2's size, twice; by torch.profiler the device ms
               of each LayerNorm kernel by name (a backward of two
               launches, as before the one-launch kernel, apart);
  lattice      holds `alpha_wavefront` and `beta_occupancies` (K3) against
               their plain versions at B=32, T'=200 and U+1 = 41, 81 and
               101 (the fused, two-pass and pruned steps' lattices), at
               (8, 100, 200), (4, 60, 513) and (3, 5, 1101), on
               `lattice_problem`'s exact scores (errors,
               the sha256 digests of alpha, beta and both occupancies), and
               times alpha, beta + occupancies and beta alone
               (`beta_wavefront`): device ms a call behind a spin kernel,
               twice, and the host's µs a call of alpha and of beta +
               occupancies (`enqueue_us`).

Prints one JSON line per tree and writes them all to --out if given.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time


PARTS = ("band_fwd", "band_bwd_a", "band_bwd_b", "pruned_step", "joint_fwd",
         "joint_bwd", "train_step", "conformer_step", "lstm_fwd",
         "lstm_int8", "greedy_fused", "ar_step", "serve", "fused_ln",
         "lattice")


def one(root: str, parts) -> dict:
    """The measurements of the tree at `root`, in this process, which was
    started as a script: its own directory, first on the import path, is
    replaced by the tree's root."""
    sys.path[0] = root
    import torch

    import chip_smoke as cs
    from rnn_transducer_tpu_torch.utils import build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.load_library()
    out = {"root": root, "card": cs.card_line()}
    for part in parts:
        out[part] = MEASURE[part](cs, dev)
        torch.cuda.empty_cache()
    return out


# The band parts: the wrapper's name, its outputs, the name of its first
# pass's time where `events` splits it.
BAND_PARTS = {"fwd": ("band_lp_fwd", ("lp_blank", "lp_y", "base"), "wt_ms"),
              "a": ("band_lp_bwd_a", ("df", "dg_w"), "wt_ms"),
              "b": ("band_lp_bwd_b", ("dw", "db"), "zb_ms")}


def band(cs, dev, which: str) -> dict:
    """The rows of the band_fwd (which "fwd"), band_bwd_a ("a") or
    band_bwd_b ("b") part, with the chunk fit of the first two."""
    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    rows = []
    name, names, first = BAND_PARTS[which]
    fn = getattr(bf, name)
    ref = getattr(bf, f"{name}_reference")
    with_events = "events" in inspect.signature(fn).parameters
    rng = np.random.default_rng(9)
    B, T, S, J = cs.TRAIN_B, cs.TRAIN_T // 2, cs.PRUNED_S, 512
    # the forward and A also at one and four chunks of 64 columns: the
    # intercept of their time against V is a block's cost outside its
    # chunk loop
    for V in (cs.PRUNED_V, 1024) + ((256, 64) if which != "b" else ()):
        k = 1.0 / np.sqrt(J)
        f = torch.from_numpy(0.5 * rng.normal(size=(B, T, J))).float().to(dev)
        g_w = torch.from_numpy(0.5 * rng.normal(size=(B, T, S, J))).float(
        ).to(dev)
        w = torch.from_numpy(rng.uniform(-k, k, (J, V))).to(
            dev, torch.bfloat16)
        b = torch.from_numpy(rng.uniform(-k, k, V)).float().to(dev)
        lab_w = torch.from_numpy(rng.integers(1, V, (B, T, S))).int().to(dev)
        lab_w[:, :, -1] = 0
        cb = torch.from_numpy(-rng.uniform(0, 1, (B, T, S)) / B).float().to(
            dev)
        cy = torch.from_numpy(-rng.uniform(0, 1, (B, T, S)) / B).float().to(
            dev)
        rest = ()
        if which != "fwd":
            rest = (bf.band_lp_fwd_reference(f, g_w, lab_w, w, b)[2], cb, cy)
        args = (f, g_w, lab_w, w, b, *rest)
        got = fn(*args)
        again = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        err = {n: (cs.max_abs(x, y) if which == "fwd" else cs.rel_err(x, y))
               for n, x, y in zip(names, got, want)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        # the outputs' bits, to compare trees run on the same inputs
        digest = {n: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[
            :16] for n, x in zip(names, got)}
        del got, again, want
        n_cp = max(2, -(-3 * cs.L2_BYTES // cs.nbytes(g_w)))
        gws = [g_w.clone() for _ in range(n_cp)]

        def call(i, **kw):
            return fn(f, gws[i], lab_w, w, b, *rest, **kw)

        row = {"B": B, "T": T, "S": S, "J": J, "V": V, "dtype": "bfloat16",
               ("max_abs_err" if which == "fwd" else "rel_err"): err,
               "bitwise_repeat": same, "finite": finite, "digest": digest,
               "plain_ms": cs.device_ms(lambda: ref(*args), reps=2),
               "kernel_ms": [cs.device_ms(cs.cycled(call, n_cp), reps=5)
                             for _ in range(2)]}
        if with_events:
            # the first pass (W^T or zb), the main launch with its sums
            row[first], row["main_ms"] = cs.event_split_ms(
                lambda i, ev: call(i % n_cp, events=ev), 3)
            if which == "b":
                row["plan"] = dataclasses.asdict(bf.device_bwd_b_plan(
                    B * T * S, J, V, dev))
            else:
                layout = (bf.device_fwd_layout if which == "fwd"
                          else bf.device_bwd_a_layout)
                row["layout"] = dataclasses.asdict(layout(J, V, dev))
        print(("band_fwd " if which == "fwd" else f"band_bwd_{which} ")
              + json.dumps(row), flush=True)
        rows.append(row)
        del gws, args, rest, f, g_w, w
        torch.cuda.empty_cache()
    if which == "b":
        return {"rows": rows}
    return {"rows": rows, "fit": chunk_fit(rows, B * T * S, dev)}


def chunk_fit(rows, n_rows: int, dev) -> dict:
    """A ring kernel's time (a forward's or kernel A's) against its
    chunks of 64 columns: a least-squares line through each row's ms (the
    main launch's where events split it, else the call's), per block of
    64 rows by the waves of blocks the card runs (one block an SM): the µs
    a block spends a chunk and outside its loop over the chunks (labels or
    sidecars, z, epilogue, launch, A's df sum)."""
    import statistics

    import torch

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = -(-(-(-n_rows // 64)) // n_sm)
    xs = [-(-r["V"] // 64) for r in rows]
    ys = [r.get("main_ms", statistics.mean(r["kernel_ms"])) for r in rows]
    mx, my = statistics.mean(xs), statistics.mean(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return {"waves": waves, "chunks": xs, "ms": ys,
            "us_a_chunk_a_block": slope / waves * 1e3,
            "us_outside_the_loop_a_block": (my - slope * mx) / waves * 1e3}


def pruned_step(cs, dev) -> dict:
    from rnn_transducer_tpu_torch.models.config import config_libri100

    cfg = dataclasses.replace(config_libri100(), vocab_size=cs.PRUNED_V,
                              pruned_range=cs.PRUNED_S)
    step, state, batch, result = cs.train_run(0, dev, "pruned", cs.PRUNED_U,
                                              cfg)
    state, steady = steady_ms(step, state, batch)
    _, prof = cs.profile_step(step, state, batch, None, "train_pruned_step")
    return {"ms_per_step": result["ms_per_step"],
            "slope_times_s": result["slope_times_s"],
            "steady_ms_per_step": steady,
            "utt_per_s": result["utt_per_s"],
            "peak_mem_gb": result["peak_mem_gb"],
            "launches_band_lp_fwd": result["launches"]["band_lp_fwd"],
            "launches_band_lp_bwd_a": result["launches"]["band_lp_bwd_a"],
            "launches_band_lp_bwd_b": result["launches"]["band_lp_bwd_b"],
            "steps": result["steps"], **profiled(prof)}


# steps of a steady run: its mean ms a step is read beside the slope's
STEADY_STEPS, STEADY_REPEATS = 20, 3


def steady_ms(step, state, batch) -> tuple:
    """The state after the runs and the ms a step of STEADY_STEPS steps
    between two synchronises, best of STEADY_REPEATS."""
    import torch

    best = float("inf")
    for _ in range(STEADY_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEADY_STEPS):
            state, _ = step(state, *batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / STEADY_STEPS)
    return state, best


def profiled(prof: dict) -> dict:
    """A profiled step's wall ms, busy share, device ms and launches by
    kernel family, and host and device ms by the step's spans."""
    return {"profile_wall_ms": prof["wall_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_ms": prof["device_ms"],
            "device_launches": prof["device_launches"],
            "host_span_ms": prof.get("host_span_ms"),
            "device_span_ms": prof.get("device_span_ms")}


def joint_fwd(cs, dev) -> dict:
    """The rows of the joint_fwd part, with the chunk fit of its bf16
    rows."""
    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as jf

    fn, ref = jf.joint_lp_fwd, jf.joint_lp_fwd_reference
    with_events = "events" in inspect.signature(fn).parameters
    names = ("lp_blank", "lp_y", "base")
    rng = np.random.default_rng(14)
    B, T, U, J = cs.TRAIN_B, cs.TRAIN_T // 2, cs.TRAIN_U, 512
    rows = []
    for V, cd in ((1024, torch.bfloat16), (1024, torch.float32),
                  (512, torch.bfloat16), (256, torch.bfloat16),
                  (64, torch.bfloat16)):
        k = 1.0 / np.sqrt(J)
        f = torch.from_numpy(0.5 * rng.normal(size=(B, T, J))).float().to(dev)
        g = torch.from_numpy(0.5 * rng.normal(size=(B, U + 1, J))).float(
        ).to(dev)
        w = torch.from_numpy(rng.uniform(-k, k, (J, V))).to(dev, cd)
        b = torch.from_numpy(rng.uniform(-k, k, V)).float().to(dev)
        labels = torch.from_numpy(rng.integers(1, V, (B, U))).int().to(dev)
        args = (f, g, labels, w, b)
        got = fn(*args)
        again = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        err = {n: cs.max_abs(x, y) for n, x, y in zip(names, got, want)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        # the outputs' bits, to compare trees run on the same inputs
        digest = {n: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[
            :16] for n, x in zip(names, got)}
        del got, again, want
        n_cp = max(2, -(-3 * cs.L2_BYTES // cs.nbytes(f)))
        fs = [f.clone() for _ in range(n_cp)]

        def call(i, **kw):
            return fn(fs[i], g, labels, w, b, **kw)

        row = {"B": B, "T": T, "U1": U + 1, "J": J, "V": V,
               "dtype": str(cd).replace("torch.", ""), "max_abs_err": err,
               "bitwise_repeat": same, "finite": finite, "digest": digest,
               "plain_ms": cs.device_ms(lambda: ref(*args), reps=2),
               "kernel_ms": [cs.device_ms(cs.cycled(call, n_cp), reps=5)
                             for _ in range(2)]}
        if with_events:
            # the W^T pass (0 in the CUDA-core form), the main launch
            row["wt_ms"], row["main_ms"] = cs.event_split_ms(
                lambda i, ev: call(i % n_cp, events=ev), 3)
        if bf.tensor_core_form(cd, J, V):
            row["layout"] = dataclasses.asdict(bf.device_fwd_layout(J, V,
                                                                    dev))
        print("joint_fwd " + json.dumps(row), flush=True)
        rows.append(row)
        del fs, args, f, g, w
        torch.cuda.empty_cache()
    ring = [r for r in rows if r["dtype"] == "bfloat16"]
    return {"rows": rows, "fit": chunk_fit(ring, B * T * (U + 1), dev)}


# joint_lp_bwd's kernels by name, as torch.profiler reports them: the first
# family whose fragment the name holds (A's W^T pass and ring kernel before
# A itself, whose other kernels land in `a`; B's zb pass before B).
K2_KERNELS = (("a_wt", "joint_bwd_a_wt"), ("a_ring", "joint_bwd_a_ring"),
              ("a", "joint_bwd_a"), ("b_zb", "joint_bwd_b_zb"),
              ("b_main", "joint_bwd_b"), ("sums", "reduce_parts"))


def by_kernel_ms(call, reps: int = 5) -> dict:
    """Device ms a call of each of K2_KERNELS' families (and `other`), by
    torch.profiler over `reps` calls after a warm one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    ms = {k: 0.0 for k, _ in K2_KERNELS}
    ms["other"] = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        fam = next((k for k, frag in K2_KERNELS if frag in evt.key), "other")
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        ms[fam] += us / 1e3 / reps
    return ms


def joint_bwd(cs, dev) -> list:
    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as jf
    from rnn_transducer_tpu_torch.ops import rnnt_loss as rl

    with_events = "events" in inspect.signature(jf.joint_lp_bwd).parameters
    rng = np.random.default_rng(4)
    B, T, U, J, V = cs.TRAIN_B, cs.TRAIN_T // 2, cs.TRAIN_U, 512, 1024
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
    gbar = torch.full((B,), 1.0 / B, device=dev)
    rows = []
    for cd in (torch.bfloat16, torch.float32):
        w = w32.to(cd).contiguous()
        lpb, lpy, base = jf.joint_lp_fwd_reference(f, g, labels, w, b)
        gb, gy = rl.occupancies_from_lp(lpb, lpy, fl, ll)
        args = (f, g, labels, w, b, gb, gy, base, gbar)
        got = jf.joint_lp_bwd(*args)
        again = jf.joint_lp_bwd(*args)
        want = jf.joint_lp_bwd_reference(*args)
        torch.cuda.synchronize()
        rel = {n: cs.rel_err(x, y) for n, x, y in
               zip(("df", "dg", "dw", "db"), got, want)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        # the outputs' bits, to compare trees run on the same inputs
        digest = {n: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[
            :16] for n, x in zip(("df", "dg", "dw", "db"), got)}
        del got, again, want
        row = {"B": B, "T": T, "U1": U + 1, "J": J, "V": V,
               "dtype": str(cd).replace("torch.", ""), "rel_err": rel,
               "bitwise_repeat": same, "digest": digest,
               "plain_ms": cs.device_ms(
                   lambda: jf.joint_lp_bwd_reference(*args), reps=2),
               "kernel_ms": [cs.device_ms(lambda: jf.joint_lp_bwd(*args),
                                          reps=5) for _ in range(2)],
               "by_kernel_ms": by_kernel_ms(lambda: jf.joint_lp_bwd(*args))}
        if with_events:
            # kernel A, B's zb pass, B's main launch, the ordered sums
            row["events_ms"] = dict(zip(
                ("a", "b_zb", "b_main", "sums"), cs.event_split_ms(
                    lambda i, ev: jf.joint_lp_bwd(*args, events=ev), 5)))
            if cd == torch.bfloat16:
                row["plan"] = dataclasses.asdict(bf.device_bwd_b_plan(
                    B * T * (U + 1), J, V, dev))
        print("joint_bwd " + json.dumps(row), flush=True)
        rows.append(row)
        del args, gb, gy, base
        torch.cuda.empty_cache()
    return rows


def train_step(cs, dev) -> dict:
    step, state, batch, result = cs.train_run(0, dev, "auto", cs.TRAIN_U)
    state, steady = steady_ms(step, state, batch)
    _, prof = cs.profile_step(step, state, batch, None)
    return {"ms_per_step": result["ms_per_step"],
            "slope_times_s": result["slope_times_s"],
            "steady_ms_per_step": steady,
            "utt_per_s": result["utt_per_s"],
            "peak_mem_gb": result["peak_mem_gb"],
            "launches_joint_bwd": result["launches"]["joint_bwd"],
            "steps": result["steps"], **profiled(prof)}


def conformer_step(cs, dev) -> dict:
    from rnn_transducer_tpu_torch.models.config import (
        config_libri100_conformer)

    step, state, batch, result = cs.train_run(
        0, dev, "auto", cs.CONF_U, config_libri100_conformer(), cs.CONF_B)
    _, prof = cs.profile_step(step, state, batch, None,
                              "train_conformer_step")
    return {"ms_per_step": result["ms_per_step"],
            "utt_per_s": result["utt_per_s"],
            "peak_mem_gb": result["peak_mem_gb"],
            "steps": result["steps"], "profile_wall_ms": prof["wall_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_ms": prof["device_ms"],
            "device_launches": prof["device_launches"]}


def lstm_fwd(cs, dev) -> dict:
    """The rows and the step fit of the lstm_fwd part."""
    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import lstm_cuda
    from rnn_transducer_tpu_torch.ops.lstm import _dot

    H = 512
    cases = ([(*c[:4], False) for c in cs.CASES
              if c[0] in ("l0_b800", "l1_b800", "l0_b400")]
             + [(*c[:4], True) for c in cs.TRAIN_LSTM_CASES
                if c[0] in ("l0_train", "l1_train", "pred_b32", "pred_b64")])
    rng = np.random.default_rng(12)
    rows = []
    for name, B, T, I, with_acts in cases:
        k = 1.0 / np.sqrt(H)
        w_ih = torch.from_numpy(rng.uniform(-k, k, (I, 4 * H))).float().to(dev)
        w_hh = torch.from_numpy(rng.uniform(-k, k, (H, 4 * H))).float().to(dev)
        b = torch.from_numpy(rng.uniform(-2 * k, 2 * k, 4 * H)).float().to(dev)
        x = torch.from_numpy(rng.normal(size=(B, T, I))).float().to(dev)
        h0 = torch.zeros(B, H, device=dev)
        fn, ref = ((lstm_cuda.lstm_recurrence_with_acts,
                    lstm_cuda.lstm_recurrence_with_acts_reference)
                   if with_acts else (lstm_cuda.lstm_recurrence,
                                      lstm_cuda.lstm_recurrence_reference))
        for cd in (torch.bfloat16, torch.float32):
            args = ((_dot(x, w_ih, cd) + b).contiguous(),
                    w_hh.to(cd).contiguous(), h0, h0)
            got = torch.utils._pytree.tree_leaves(fn(*args))
            again = torch.utils._pytree.tree_leaves(fn(*args))
            want = torch.utils._pytree.tree_leaves(ref(*args))
            torch.cuda.synchronize()
            row = {"case": name, "B": B, "T": T, "H": H,
                   "with_acts": with_acts,
                   "dtype": str(cd).replace("torch.", ""),
                   "max_abs_err": max(cs.max_abs(g, r)
                                      for g, r in zip(got, want)),
                   "bitwise_repeat": all(torch.equal(g, a)
                                         for g, a in zip(got, again)),
                   "finite": all(bool(torch.isfinite(g).all()) for g in got),
                   # the outputs' bits, to compare trees on the same inputs
                   "digest": [hashlib.sha256(g.cpu().numpy().tobytes())
                              .hexdigest()[:16] for g in got],
                   "kernel_ms": [cs.device_ms(lambda: fn(*args), reps=5)
                                 for _ in range(2)],
                   **cs.bound(cs.nbytes(args, got), 2 * B * T * H * 4 * H,
                              cd)}
            if hasattr(lstm_cuda, "device_fwd_plan"):
                row["plan"] = dataclasses.asdict(lstm_cuda.device_fwd_plan(
                    B, H, cd, dev))
            print("lstm_fwd " + json.dumps(row), flush=True)
            rows.append(row)
            del got, again, want, args
        torch.cuda.empty_cache()
    return {"rows": rows, "step_fit": {
        str(cd).replace("torch.", ""): step_fit(cs.device_ms, dev, cd)
        for cd in (torch.bfloat16, torch.float32)}}


def lstm_int8(cs, dev) -> dict:
    """The rows, the step fits and the int8 serving of the lstm_int8
    part."""
    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
    from rnn_transducer_tpu_torch.ops.lstm import _dot
    from rnn_transducer_tpu_torch.ops.quant import (quantize_params,
                                                    quantize_tensor)

    H = 512
    rng = np.random.default_rng(16)
    rows = []
    for name, B, T, I, with_state in cs.INT8_CASES:
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
        for cd in (torch.bfloat16, torch.float32):
            args = ((_dot(x, w_ih, cd) + b).to(cd).contiguous(), qw.q,
                    qw.scale, h0, c0)
            got = q8.lstm_recurrence_int8(*args)
            again = q8.lstm_recurrence_int8(*args)
            want = q8.lstm_recurrence_int8_reference(*args)
            torch.cuda.synchronize()
            outs = {"hs": (got[0], again[0], want[0]),
                    "c": (got[1][1], again[1][1], want[1][1])}
            row = {"case": name, "B": B, "T": T, "H": H,
                   "dtype": str(cd).replace("torch.", ""),
                   "max_abs_err": max(cs.max_abs(g, r)
                                      for g, _, r in outs.values()),
                   "bitwise_repeat": all(torch.equal(g, a)
                                         for g, a, _ in outs.values()),
                   "finite": bool(torch.isfinite(got[0]).all()),
                   # the outputs' bits, to compare trees on the same inputs
                   "digest": {n: hashlib.sha256(
                       g.cpu().numpy().tobytes()).hexdigest()[:16]
                       for n, (g, _, _) in outs.items()},
                   "kernel_ms": [cs.device_ms(
                       lambda: q8.lstm_recurrence_int8(*args), reps=5)
                       for _ in range(2)],
                   **cs.bound(cs.nbytes(args, got[0], got[1][1]),
                              2 * B * T * H * 4 * H, torch.int8)}
            if hasattr(q8, "device_groups"):
                row["groups"] = [
                    {"rows": [b0, b1], **dataclasses.asdict(plan)}
                    for b0, b1, plan in q8.device_groups(B, H, dev)]
            print("lstm_int8 " + json.dumps(row), flush=True)
            rows.append(row)
            del got, again, want, outs, args
        torch.cuda.empty_cache()
    fits = {str(cd).replace("torch.", ""): step_fit(cs.device_ms, dev, cd,
                                                    int8=True)
            for cd in (torch.bfloat16, torch.float32)}
    serving = cs.serving_setup(0, 24, dev)
    _, result, counts = cs.serve_all(
        serving, quantize_params(serving["params"]), dev)
    return {"rows": rows, "step_fit": fits, "serve": {
        **{k: result[k] for k in ("requests", "p50_ms", "p95_ms", "wall_s",
                                  "mean_batch", "batches")},
        "launches_lstm_fwd_int8": counts["lstm_fwd_int8"],
        "launches_lstm_fwd": counts["lstm_fwd"]}}


def step_fit(device_ms, dev, cd, B: int = 8, H: int = 512,
             int8: bool = False) -> dict:
    """lstm_recurrence's device ms (by `device_ms`, chip_smoke's) at B, H
    against T = 100 .. 800 (x_proj random, zero state) and the
    least-squares line through them: µs a step and the fixed cost of a
    call (its intercept). With `int8`, the same for
    lstm_recurrence_int8 (K7) on quantize_tensor's wq, x_proj in `cd`.
    chip_smoke.py prints both for its serving shape too."""
    import statistics

    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import lstm_cuda
    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
    from rnn_transducer_tpu_torch.ops.quant import quantize_tensor

    rng = np.random.default_rng(13)
    k = 1.0 / np.sqrt(H)
    w = torch.from_numpy(rng.uniform(-k, k, (H, 4 * H)))
    h0 = torch.zeros(B, H, device=dev)
    if int8:
        qw = quantize_tensor(w.float().to(dev))

        def call(x_proj):
            return q8.lstm_recurrence_int8(x_proj, qw.q, qw.scale, h0, h0)
    else:
        w = w.to(dev, cd)

        def call(x_proj):
            return lstm_cuda.lstm_recurrence(x_proj, w, h0, h0)
    ts, ms = (100, 200, 400, 800), []
    for T in ts:
        x_proj = torch.from_numpy(rng.normal(size=(B, T, 4 * H))).float().to(
            dev)
        if int8:
            x_proj = x_proj.to(cd)
        call(x_proj)
        ms.append(device_ms(lambda: call(x_proj), reps=5))
    mt, mm = statistics.mean(ts), statistics.mean(ms)
    slope = (sum((t - mt) * (m - mm) for t, m in zip(ts, ms))
             / sum((t - mt) ** 2 for t in ts))
    return {"B": B, "H": H, "T": ts, "ms": ms, "us_a_step": slope * 1e3,
            "fixed_us": (mm - slope * mt) * 1e3}


def greedy_batch(cs, serving, n: int, dev):
    """The first n served utterances padded to the largest bucket, as the
    engine pads a batch: feats (n, 800, 80) and lengths."""
    import numpy as np
    import torch

    feats = np.zeros((n, cs.BUCKETS[-1], serving["cfg"].input_dim),
                     np.float32)
    lens = np.zeros((n,), np.int32)
    for i in range(n):
        feats[i, :serving["lengths"][i]] = serving["utts"][i]
        lens[i] = serving["lengths"][i]
    return torch.from_numpy(feats).to(dev), torch.from_numpy(lens).to(dev)


def greedy_fused(cs, dev) -> dict:
    """The greedy_fused part: K9 on chip_smoke's served batches (B = 1, 8,
    16 utterances at the 800-frame bucket, max_symbols 100), bf16 and
    f32."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.decode import greedy_fused as gf
    from rnn_transducer_tpu_torch.models import transducer as m

    serving = cs.serving_setup(0, 24, dev)
    cfg, params = serving["cfg"], serving["params"]
    rows = []
    for n in (8, 1, 16):
        feats, lens = greedy_batch(cs, serving, n, dev)
        for cd in (("bfloat16", "float32") if n == 8 else ("bfloat16",)):
            c = dataclasses.replace(cfg, compute_dtype=cd)
            with torch.inference_mode():
                enc, enc_lens = m.encode(params, c, feats, lens)
                f, flens, weights = gf.fused_inputs(params, c, enc, enc_lens)
                args = (f, flens, weights, cs.MAX_SYMBOLS, cfg.blank,
                        c.cdtype)
                got = gf.greedy_fused_tokens(*args)
                again = gf.greedy_fused_tokens(*args)
                want = gf.greedy_fused_tokens_reference(*args)
                torch.cuda.synchronize()
                ms = [cs.device_ms(lambda: gf.greedy_fused_tokens(*args),
                                   reps=5) for _ in range(2)]
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    cs.pad_profiler_window()
                    gf.greedy_fused_tokens(*args)
                    torch.cuda.synchronize()
                    cs.pad_profiler_window()
            kernels = {}
            for evt in prof.key_averages():
                if evt.device_type == DeviceType.CUDA and "greedy" in evt.key:
                    kernels[evt.key[:60]] = getattr(
                        evt, "self_device_time_total",
                        getattr(evt, "self_cuda_time_total", 0)) / 1e3
            max_steps = int(got[1].max())
            row = {"B": n, "dtype": cd, "T": f.shape[1],
                   "max_symbols": cs.MAX_SYMBOLS,
                   "tokens_equal_plain": torch.equal(got[0], want[0]),
                   "steps_equal_plain": torch.equal(got[1], want[1]),
                   "row_agreement": float((got[0] == want[0]).all(1).float()
                                          .mean()),
                   "bitwise_repeat": all(torch.equal(a, b)
                                         for a, b in zip(got, again)),
                   # the outputs' bits, to compare trees on the same inputs
                   "digest": {k: hashlib.sha256(
                       v.cpu().numpy().tobytes()).hexdigest()[:16]
                       for k, v in (("tokens", got[0]), ("steps", got[1]))},
                   "tokens": int((got[0] != cfg.blank).sum()),
                   "steps": got[1].tolist(), "max_steps": max_steps,
                   "kernel_ms": ms, "kernels_ms": kernels,
                   "us_per_step": min(ms) * 1e3 / max(max_steps, 1)}
            if hasattr(gf, "cluster_plan"):
                plan = gf.cluster_plan(weights[0].shape[1],
                                       weights[2].shape[0], f.shape[2],
                                       weights[0].shape[0])
                row["plan"] = dataclasses.asdict(plan)
                row["clusters_at_once"] = gf.device_clusters(plan, dev)
            print("greedy_fused " + json.dumps(row), flush=True)
            rows.append(row)
    return {"rows": rows}


def ar_step(cs, dev) -> dict:
    from rnn_transducer_tpu_torch.models.config import config_libri100

    step, state, batch, result = cs.train_run(
        0, dev, "auto", cs.TRAIN_U, config_libri100(), ar_range=cs.AR_S)
    _, prof = cs.profile_step(step, state, batch, None, "train_ar_step")
    return {"ms_per_step": result["ms_per_step"],
            "utt_per_s": result["utt_per_s"],
            "peak_mem_gb": result["peak_mem_gb"],
            "steps": result["steps"], "profile_wall_ms": prof["wall_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_ms": prof["device_ms"],
            "device_launches": prof["device_launches"]}


def serve(cs, dev) -> dict:
    serving = cs.serving_setup(0, 24, dev)
    _, result, counts = cs.serve_all(serving, serving["params"], dev)
    return {**{k: result[k] for k in ("requests", "p50_ms", "p95_ms",
                                      "wall_s", "req_per_s", "mean_batch",
                                      "batches")},
            "launches_lstm_fwd": counts["lstm_fwd"]}


def kernels_by_name(call, fragment: str, reps: int = 5) -> dict:
    """Device ms a call of each CUDA kernel whose name holds `fragment`,
    by torch.profiler over `reps` calls after a warm one, the window
    padded at both ends; keyed by the kernel's name up to its argument
    list."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.pad_profiler_window()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        cs.pad_profiler_window()
    ms = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or fragment not in evt.key:
            continue
        name = evt.key.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0]
        ms[name] = ms.get(name, 0.0) + getattr(
            evt, "self_device_time_total",
            getattr(evt, "self_cuda_time_total", 0)) / 1e3 / reps
    return ms


def sha16(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


# K8's rows: chip_smoke's LN_CASES (a served batch's and the conformer
# step's), D = 512
LN_ROWS, LN_D = (1600, 6400), 512


def ln_problem(dev) -> dict:
    """K8's inputs: N -> x (N, D), g, b (D,), dy (N, D) f32 for each N of
    LN_ROWS, from one numpy seed in that order. numpy's normals are the
    same on any machine, so the outputs' digests compare the kernels of
    two trees (and the card tests' record of the parent's)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(18)
    out = {}
    for N in LN_ROWS:
        out[N] = tuple(torch.from_numpy(a).float().to(dev) for a in (
            3 * rng.normal(size=(N, LN_D)) + 1,
            1 + 0.5 * rng.normal(size=LN_D), 0.5 * rng.normal(size=LN_D),
            rng.normal(size=(N, LN_D))))
    return out


def fused_ln(cs, dev) -> list:
    import torch

    from rnn_transducer_tpu_torch.ops import fused_ln as fl

    D = LN_D
    rows = []
    for N, (x, g, b, dy) in ln_problem(dev).items():
        n_cp = max(2, -(-3 * cs.L2_BYTES // cs.nbytes(x)))
        xs = [x.clone() for _ in range(n_cp)]
        dys = [dy.clone() for _ in range(n_cp)]
        for act in fl.ACTS:
            y, mu, rstd = fl.fln_fwd(x, g, b, act)
            got = fl.fln_bwd(x, g, b, mu, rstd, dy, act)
            again = fl.fln_bwd(x, g, b, mu, rstd, dy, act)
            leaves = [a.clone().requires_grad_(True) for a in (x, g, b)]
            ref = fl.layer_norm_reference(*leaves, act)
            want = torch.autograd.grad(ref, leaves, dy)
            torch.cuda.synchronize()

            def fwd(i):
                return fl.fln_fwd(xs[i], g, b, act)

            def bwd(i):
                return fl.fln_bwd(xs[i], g, b, mu, rstd, dys[i], act)

            row = {"N": N, "D": D, "act": act,
                   "y_max_abs_err": cs.max_abs(y, ref.detach()),
                   "bwd_rel_err": {n: cs.rel_err(a, e) for n, a, e in zip(
                       ("dx", "dg", "db"), got, want)},
                   "bwd_bitwise_repeat": all(torch.equal(a, e) for a, e in
                                             zip(got, again)),
                   # the outputs' bits, to compare trees on the same inputs
                   "digest": {n: sha16(t) for n, t in zip(
                       ("y", "mu", "rstd", "dx", "dg", "db"),
                       (y, mu, rstd, *got))},
                   "fwd_ms": [cs.device_ms(cs.cycled(fwd, n_cp))
                              for _ in range(2)],
                   "bwd_ms": [cs.device_ms(cs.cycled(bwd, n_cp))
                              for _ in range(2)],
                   "fwd_kernels_ms": kernels_by_name(cs.cycled(fwd, n_cp),
                                                     "ln_"),
                   "bwd_kernels_ms": kernels_by_name(cs.cycled(bwd, n_cp),
                                                     "ln_"),
                   "fwd_bound": cs.bound(cs.nbytes(x, g, b, y, mu, rstd),
                                         (12 if act == "silu" else 8) * N * D,
                                         torch.float32),
                   "bwd_bound": cs.bound(
                       cs.nbytes(x, g, b, mu, rstd, dy, got),
                       (22 if act == "silu" else 14) * N * D, torch.float32)}
            print("fused_ln " + json.dumps(row), flush=True)
            rows.append(row)
        del xs, dys
        torch.cuda.empty_cache()
    return rows


# (B, T, U) of the lattice part: the fused, two-pass and pruned steps'
# lattices (chip_smoke's TRAIN_U, PALLAS_U, PRUNED_U at B=32, T'=200),
# U+1 = 200 and 513 (two and five cells a lane of four walkers) and a
# diagonal longer than a block of 1024 threads
LATTICE_CASES = ((32, 200, 40), (32, 200, 80), (32, 200, 100), (8, 100, 199),
                 (4, 60, 512), (3, 5, 1100))


def lattice_problem(B: int, T: int, U: int, dev, seed: int = 0):
    """K3's inputs: masked scores, acceptance scores (B, T, U+1) f32 and
    frame lengths (B,) int32 of a ragged batch (row 0 full, row 1 without
    frames, row 2 without labels, the rest from [T/2, T] and [U/2, U]).
    The scores are -k / 16 for integers k in [1, 48] from a numpy seed:
    exact in f32 and made without a transcendental function, so they have
    the same bits on any machine, and the outputs' digests compare the
    kernels of two trees (and the card tests' record of the parent's)."""
    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import rnnt_loss as rl

    rng = np.random.default_rng(seed)
    lpb, lpy = (torch.from_numpy(-rng.integers(1, 49, (B, T, U + 1)) / 16.0)
                .float().to(dev) for _ in range(2))
    fl = rng.integers(T // 2, T + 1, B)
    ll = rng.integers(U // 2, U + 1, B)
    fl[0], ll[0] = T, U
    fl[1:2], ll[2:3] = 0, 0
    fl = torch.from_numpy(fl).int().to(dev)
    ll = torch.from_numpy(ll).int().to(dev)
    lpb_m, lpy_m = rl._masked_transitions(lpb, lpy, fl, ll)
    accept = rl._accept_scores(lpb, fl, ll)
    return lpb_m.contiguous(), lpy_m.contiguous(), accept.contiguous(), fl


def enqueue_us(fn, reps: int = 50) -> float:
    """Host µs a call takes to return, its launches queued behind a spin
    kernel of ~0.1 s, so that the host never waits for the device."""
    import torch

    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def lattice(cs, dev) -> list:
    import torch

    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat

    rows = []
    for B, T, U in LATTICE_CASES:
        lpb_m, lpy_m, accept, fl = lattice_problem(B, T, U, dev)
        alpha = lat.alpha_wavefront(lpb_m, lpy_m)
        beta, gb, gy = lat.beta_occupancies(lpb_m, lpy_m, accept, alpha, fl)
        beta_only = lat.beta_wavefront(lpb_m, lpy_m, accept)
        want_a = lat.alpha_wavefront_reference(lpb_m, lpy_m)
        want_b = lat.beta_occupancies_reference(lpb_m, lpy_m, accept, want_a,
                                                fl)
        torch.cuda.synchronize()
        err_a, rel_a, unreach_a = cs.lattice_err(alpha, want_a)
        err_b, rel_b, unreach_b = cs.lattice_err(beta, want_b[0])
        a_args = (lpb_m, lpy_m)
        b_args = (lpb_m, lpy_m, accept, alpha, fl)
        row = {"B": B, "T": T, "U1": U + 1, "diagonals": T + U,
               "alpha_max_abs_err": err_a, "alpha_rel_err": rel_a,
               "beta_max_abs_err": err_b, "beta_rel_err": rel_b,
               "unreachable_ok": unreach_a and unreach_b,
               "occ_max_abs_err": max(cs.max_abs(gb, want_b[1]),
                                      cs.max_abs(gy, want_b[2])),
               "beta_alone_equal": torch.equal(beta_only, beta),
               # the outputs' bits, to compare trees on the same inputs
               "digest": {n: sha16(t) for n, t in zip(
                   ("alpha", "beta", "g_blank", "g_y"),
                   (alpha, beta, gb, gy))},
               "alpha_ms": [cs.device_ms(lambda: lat.alpha_wavefront(
                   *a_args)) for _ in range(2)],
               "beta_occ_ms": [cs.device_ms(lambda: lat.beta_occupancies(
                   *b_args)) for _ in range(2)],
               "beta_walk_ms": [cs.device_ms(lambda: lat.beta_wavefront(
                   *b_args[:3])) for _ in range(2)],
               "alpha_enqueue_us": enqueue_us(
                   lambda: lat.alpha_wavefront(*a_args)),
               "beta_occ_enqueue_us": enqueue_us(
                   lambda: lat.beta_occupancies(*b_args)),
               "alpha_bound": cs.bound(cs.nbytes(a_args, alpha),
                                       8 * B * T * (U + 1), torch.float32),
               "beta_bound": cs.bound(cs.nbytes(b_args, beta, gb, gy),
                                      16 * B * T * (U + 1), torch.float32)}
        print("lattice " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


MEASURE = {"band_fwd": functools.partial(band, which="fwd"),
           "band_bwd_a": functools.partial(band, which="a"),
           "band_bwd_b": functools.partial(band, which="b"),
           "pruned_step": pruned_step, "joint_fwd": joint_fwd,
           "joint_bwd": joint_bwd, "train_step": train_step,
           "conformer_step": conformer_step,
           "lstm_fwd": lstm_fwd, "lstm_int8": lstm_int8,
           "greedy_fused": greedy_fused, "ar_step": ar_step, "serve": serve,
           "fused_ln": fused_ln, "lattice": lattice}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trees", nargs="+",
                   default=[os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__)))])
    p.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    p.add_argument("--out", default=None)
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print("RESULT " + json.dumps(one(os.path.abspath(args.one),
                                         args.parts)), flush=True)
        return
    results = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.abspath(tree), "--parts", *args.parts],
            capture_output=True, text=True,
            check=False)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            sys.stdout.write(proc.stdout[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        res = json.loads(lines[-1][len("RESULT "):])
        print(json.dumps(res), flush=True)
        results.append(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
