#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rnn_transducer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--requests 24]

Drives the port's serving path once at the full width of the libri100
config (4x512 LSTM encoder, 1x512 predictor, vocab 1024, bf16) with random
weights from --seed, through the entry points a user calls: BatchingEngine
behind http_server, with serve.py's CLI defaults. Phases, in order:

  1. card   require CUDA; print the card's name and power limit
  2. build  build the kernel library from csrc/ with nvcc
  3. kernel each kernel against its plain PyTorch version on the card, at
            the serving path's shapes, in f32 and bf16 (max abs error,
            kernel ms and plain ms from CUDA events, in turns
            plain, kernel, kernel, plain)
  4. e2e    concurrent HTTP /recognize requests; every kernel of the path
            must have launched while they were served; the f32 tokens of
            the kernel path and the plain path must be identical
  5. the kernels' JSON line, then {"ok": true, "device": {...}} last

TF32 is off for matmuls and cuDNN: every float32 product runs in float32.
Any failed check exits non-zero; with no CUDA device it exits before any
result is printed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import config_libri100
from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.serve import BatchingEngine, http_server
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
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in (
                (got[0], want[0]), (got[1][0], want[1][0]),
                (got[1][1], want[1][1])))
            ok = bool(torch.isfinite(got[0]).all()) and err <= ATOL[cd]
            times = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = (lstm_cuda.lstm_recurrence if which == "kernel"
                      else lstm_cuda.lstm_recurrence_reference)
                times[which].append(cuda_ms(lambda: fn(*args)))
            row = {"case": name, "B": B, "T": T, "I": I, "H": H,
                   "dtype": str(cd).replace("torch.", ""),
                   "max_abs_err": err, "atol": ATOL[cd],
                   "kernel_ms": statistics.mean(times["kernel"]),
                   "plain_ms": statistics.mean(times["plain"])}
            print("kernel lstm_fwd " + json.dumps(row))
            check(ok, f"lstm_fwd {name} {cd}: max abs err {err} > "
                      f"{ATOL[cd]} or non-finite output")
            rows.append(row)
            worst = max(worst, err)
            if (name, cd) == MAIN_CASE:
                main = row
    return {"rows": rows, "max_abs_err": worst, "main": main}


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
    ctx = (mock.patch.object(lstm_cuda, "lstm_recurrence",
                             lstm_cuda.lstm_recurrence_reference)
           if plain else contextlib.nullcontext())
    with ctx, torch.inference_mode():
        enc, _ = m.encode(params, cfg, feats, lens)
        tok, n = recognize_greedy(params, cfg, feats, lens, MAX_SYMBOLS)
    return enc, [tok[b, :n[b]].tolist() for b in range(len(n))]


def end_to_end(seed: int, n_requests: int, dev) -> dict:
    rng = np.random.default_rng(seed)
    cfg = config_libri100()
    params = m.init_params(cfg, rng, dev)
    offset = blank_offset(params, cfg, dev, rng)
    params["joint"]["out"]["b"][cfg.blank] += offset
    lengths = rng.integers(150, 801, size=n_requests)
    lengths[:2] = (150, 800)
    utts = [rng.normal(size=(int(T), cfg.input_dim)).astype(np.float32)
            for T in lengths]

    engine = BatchingEngine(params, cfg, max_symbols=MAX_SYMBOLS,
                            frame_buckets=BUCKETS, max_batch=MAX_BATCH,
                            window_ms=WINDOW_MS, device=dev)
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        lstm_cuda.LAUNCHES = 0  # count only the served requests' launches
        t0 = time.perf_counter()
        answers = serve_requests(engine, utts)
        wall_s = time.perf_counter() - t0
        launches = lstm_cuda.LAUNCHES
        stats = engine.stats.summary()
    finally:
        engine.close()

    codes = [a[0] for a in answers]
    check(all(c == 200 for c in codes), f"HTTP codes {codes}")
    for (_, out, _), T in zip(answers, lengths):
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
    check(launches > 0, "the served path never launched lstm_fwd")
    lat = sorted(a[2] * 1e3 for a in answers)
    tokens = [len(a[1]["tokens"]) for a in answers]
    result = {"requests": len(answers), "warmup_s": warmup_s,
              "wall_s": wall_s, "req_per_s": len(answers) / wall_s,
              "mean_batch": stats["mean_batch"],
              "batches": stats["batches"],
              "p50_ms": lat[len(lat) // 2],
              "p95_ms": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
              "mean_tokens": statistics.mean(tokens),
              "blank_offset": offset, "launches": launches}
    print("e2e " + json.dumps(result))

    # One batch of the served utterances: kernel path vs plain path.
    B, tb = MAX_BATCH, BUCKETS[-1]
    feats = np.zeros((B, tb, cfg.input_dim), np.float32)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        feats[i, :lengths[i]] = utts[i]
        lens[i] = lengths[i]
    feats_d = torch.from_numpy(feats).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    for cd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        enc_k, tok_k = decode_batch(params, c, feats_d, lens_d, plain=False)
        enc_p, tok_p = decode_batch(params, c, feats_d, lens_d, plain=True)
        agree = sum(a == b for a, b in zip(tok_k, tok_p)) / B
        row = {"dtype": cd, "enc_max_abs_err": float(
            (enc_k - enc_p).abs().max()), "token_agreement": agree,
            "tokens_per_utt": [len(t) for t in tok_k]}
        print("kernel_vs_plain_decode " + json.dumps(row))
        if cd == "float32":
            check(tok_k == tok_p, "f32 tokens differ between the kernel "
                                  "path and the plain path")
            check(row["enc_max_abs_err"] <= ATOL[torch.float32],
                  "f32 encoder output differs between kernel and plain")
            enc_f32 = enc_k

    # The kernel path on the card against the port on the CPU (plain
    # recurrence, another matmul library), two utterances, f32.
    c = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    enc_cpu, _ = m.encode(cpu_params, c, feats_d[:2].cpu(), lens_d[:2].cpu())
    err = float((enc_cpu - enc_f32[:2].cpu()).abs().max())
    print(f"cpu_reference enc_max_abs_err {err}")
    check(err <= ATOL[torch.float32], f"card vs CPU encoder output {err}")
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=24)
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
        if "ptxas info" in line:
            print(f"build: {line.strip()}")

    # phase 3: each kernel against its plain version
    k = kernel_vs_plain(np.random.default_rng(args.seed + 1), dev)

    # phase 4: end to end
    e2e = end_to_end(args.seed, args.requests, dev)

    # phase 5: results
    main_row = k["main"]
    print(json.dumps({"kernels": [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "rnn_transducer_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "rnn_transducer_tpu/ops/lstm_pallas.py:119",
        "launches": e2e["launches"], "max_abs_err": k["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
