#!/usr/bin/env python3
"""The joint's dW / db kernels (K6-B, the band joint's; K2-B, the fused
joint's) and the training steps that run them, timed on one CUDA card for
one or more checkouts of this repository, in turns.

    python3 -m rnn_transducer_tpu_torch.bench_band_bwd_b \
        [--trees DIR [DIR ...]] [--parts PART [PART ...]] [--out RESULTS.json]

run from the root of a checkout. Each tree runs in a process of its own,
in the order given (default: this checkout), so that two versions of the
kernels are compared on one card: pass `--trees OLD NEW NEW OLD`. A
process puts the tree's root first on the import path (its package and
its chip_smoke.py), builds that tree's kernels, then runs the parts
(default: all four, in this order):

  band_bwd_b   holds `band_lp_bwd_b` against its plain version at the
               pruned step's band (B=32, T'=200, S=8, J=512, bf16) with
               V=8192 and at the AR step's V=1024 (max |err| over the
               largest |value|, two runs bit for bit), and times it: device
               ms a call behind a spin kernel, g_w cycled through copies
               three times the L2's size; where the tree's wrapper takes
               `events`, its zb pass and main launch apart;
  pruned_step  trains libri100 with V=8192, S=8, U=100 at B=32, T=400
               (chip_smoke.train_run: ms/step by the slope of two runs),
               then profiles one step (device ms by kernel family);
  joint_bwd    holds `joint_lp_bwd` (K2) against its plain version at the
               libri100 joint (B=32, T'=200, U+1=41, J=512, V=1024), bf16
               and f32, with ragged lengths and the real lattice's
               occupancies, and times it: device ms a call behind a spin
               kernel, and by torch.profiler its kernels by name (kernel
               A, kernel B, B's zb pass where it has one, the ordered
               sums); where the tree's wrapper takes `events`, the same
               split by CUDA events;
  train_step   trains libri100 at B=32, T=400, U=40 through the default
               (fused) loss, then profiles one step.

Prints one JSON line per tree and writes them all to --out if given.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import subprocess
import sys


PARTS = ("band_bwd_b", "pruned_step", "joint_bwd", "train_step")


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


def band_bwd_b(cs, dev) -> list:
    import numpy as np
    import torch

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    rows = []
    with_events = "events" in inspect.signature(bf.band_lp_bwd_b).parameters
    rng = np.random.default_rng(9)
    B, T, S, J = cs.TRAIN_B, cs.TRAIN_T // 2, cs.PRUNED_S, 512
    for V in (cs.PRUNED_V, 1024):
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
        base = bf.band_lp_fwd_reference(f, g_w, lab_w, w, b)[2]
        args = (f, g_w, lab_w, w, b, base, cb, cy)
        got = bf.band_lp_bwd_b(*args)
        again = bf.band_lp_bwd_b(*args)
        want = bf.band_lp_bwd_b_reference(*args)
        torch.cuda.synchronize()
        rel = {n: cs.rel_err(x, y) for n, x, y in zip(("dw", "db"), got,
                                                       want)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del got, again, want
        n_cp = max(2, -(-3 * cs.L2_BYTES // cs.nbytes(g_w)))
        gws = [g_w.clone() for _ in range(n_cp)]

        def call(i, **kw):
            return bf.band_lp_bwd_b(f, gws[i], lab_w, w, b, base, cb, cy,
                                    **kw)

        row = {"B": B, "T": T, "S": S, "J": J, "V": V, "dtype": "bfloat16",
               "rel_err": rel, "bitwise_repeat": same,
               "plain_ms": cs.device_ms(lambda: bf.band_lp_bwd_b_reference(
                   *args), reps=2),
               "kernel_ms": [cs.device_ms(cs.cycled(call, n_cp), reps=5)
                             for _ in range(2)]}
        if with_events:
            row["zb_ms"], row["main_ms"] = cs.bwd_b_split_ms(
                lambda i, ev: call(i, events=ev), n_cp)
            row["plan"] = dataclasses.asdict(bf.device_bwd_b_plan(
                B * T * S, J, V, dev))
        print("band_bwd_b " + json.dumps(row), flush=True)
        rows.append(row)
        del gws, args, f, g_w, w, base
        torch.cuda.empty_cache()
    return rows


def pruned_step(cs, dev) -> dict:
    from rnn_transducer_tpu_torch.models.config import config_libri100

    cfg = dataclasses.replace(config_libri100(), vocab_size=cs.PRUNED_V,
                              pruned_range=cs.PRUNED_S)
    step, state, batch, result = cs.train_run(0, dev, "pruned", cs.PRUNED_U,
                                              cfg)
    _, prof = cs.profile_step(step, state, batch, None, "train_pruned_step")
    return {"ms_per_step": result["ms_per_step"],
            "utt_per_s": result["utt_per_s"],
            "peak_mem_gb": result["peak_mem_gb"],
            "launches_band_lp_bwd_b": result["launches"]["band_lp_bwd_b"],
            "steps": result["steps"], "profile_wall_ms": prof["wall_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_ms": prof["device_ms"]}


# joint_lp_bwd's kernels by name, as torch.profiler reports them: the first
# family whose fragment the name holds (B's zb pass before B itself).
K2_KERNELS = (("a", "joint_bwd_a"), ("b_zb", "joint_bwd_b_zb"),
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
        del got, again, want
        row = {"B": B, "T": T, "U1": U + 1, "J": J, "V": V,
               "dtype": str(cd).replace("torch.", ""), "rel_err": rel,
               "bitwise_repeat": same,
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
    _, prof = cs.profile_step(step, state, batch, None)
    return {"ms_per_step": result["ms_per_step"],
            "utt_per_s": result["utt_per_s"],
            "peak_mem_gb": result["peak_mem_gb"],
            "launches_joint_bwd": result["launches"]["joint_bwd"],
            "steps": result["steps"], "profile_wall_ms": prof["wall_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_ms": prof["device_ms"],
            "device_launches": prof["device_launches"]}


MEASURE = {"band_bwd_b": band_bwd_b, "pruned_step": pruned_step,
           "joint_bwd": joint_bwd, "train_step": train_step}


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
