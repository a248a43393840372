"""Serving runtime: dynamic request batching over HTTP (PyTorch port of
`rnn_transducer_tpu/serve.py`, offline recognition).

`BatchingEngine` queues requests on the host; a worker thread drains up to
`max_batch` of them inside a `window_ms` batching window, pads them to a
fixed (max_batch, bucket_frames) shape and runs one decode for the whole
group on the engine's device: greedy (`mode="greedy"`) or beam search
with prefix merging (`mode="beam"`, decode/beam.py), which answers the
top beam's tokens, score, confidences and frames and the n-best list.
In beam mode the engine takes shallow fusion as the JAX engine does:
`lm=(params, LMConfig or TransformerLMConfig, weight[, ilm_weight])`,
`context=` a decode/context.py ContextBias and `ngram=(NgramLM, weight)`
(`--ngram FILE --ngram-weight W` on the CLI). `http_server` exposes the
engine over stdlib HTTP with JSON bodies.

`--config libri100_conformer` serves the conformer encoder (every
LayerNorm in the K8 kernel, `csrc/fused_ln.cu`). `--quantize int8` serves
post-training int8 weights (`ops/quant.py`): the encoder's LSTM layers run
the W8A8 recurrence (CUDA kernel `csrc/lstm_fwd_q.cu`) at batch sizes that
are a multiple of 8, such as the default `--max-batch 8`, and the
dequantized weights elsewhere; a conformer dequantizes every weight, as in
the JAX package.

Not ported yet, each with its ROADMAP item (queue 1): streaming sessions
(item 4: the session routes answer 404, as the JAX server does with
streaming off), raw-audio bodies and `--boost-file` (item 5: the FBANK
frontend and the tokenizer), and `--lm-ckpt` / `--lm-weight` /
`--ilm-weight` (item 18: the LM checkpoints are orbax files, which the
port does not read; the engine's `lm=` takes an LM's params directly).

    python -m rnn_transducer_tpu_torch.serve --config libri100 --port 8000
    python -m rnn_transducer_tpu_torch.serve --config libri100 --mode beam
    python -m rnn_transducer_tpu_torch.serve --config libri100 --mode beam \
        --ngram lm3.npz --ngram-weight 0.3
    python -m rnn_transducer_tpu_torch.serve --config libri100 --quantize int8
    python -m rnn_transducer_tpu_torch.serve --config libri100_conformer
    curl -XPOST localhost:8000/recognize -d '{"feats": [[...80 floats...]]}'
    curl localhost:8000/stats
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import sys
import threading
import time

import numpy as np
import torch

from rnn_transducer_tpu_torch.decode.beam import recognize_beam
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.models import transducer as m


class EngineStats:
    LAT_WINDOW = 1024  # bounded latency history (p50 over recent batches)

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.max_batch = 0
        self.latency_s = collections.deque(maxlen=self.LAT_WINDOW)

    def record(self, batch_size: int, latency: float):
        with self.lock:
            self.requests += batch_size
            self.batches += 1
            self.max_batch = max(self.max_batch, batch_size)
            self.latency_s.append(latency)

    def summary(self) -> dict:
        with self.lock:
            lat = sorted(self.latency_s)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "mean_batch": (self.requests / self.batches
                               if self.batches else 0.0),
                "max_batch": self.max_batch,
                "p50_batch_latency_ms": (
                    round(lat[len(lat) // 2] * 1e3, 3) if lat else None),
            }


class BatchingEngine:
    """Dynamic batching for offline recognition.

    submit() blocks the calling thread until its utterance's result is
    ready; concurrent callers landing within the batching window share one
    device decode.
    """

    def __init__(self, params, cfg, *, mode: str = "greedy", beam: int = 8,
                 expansions: int = 3, max_symbols: int = 100,
                 frame_buckets=(200, 400, 800), max_batch: int = 8,
                 window_ms: float = 5.0, lm=None, context=None, ngram=None,
                 device: str | torch.device = "cuda"):
        if mode == "greedy":
            if context is not None or ngram is not None:
                raise ValueError("contextual biasing / n-gram fusion "
                                 "require mode='beam'")
        elif mode != "beam":
            raise ValueError(f"unknown mode {mode!r}")
        m.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.mode = mode
        self.device = torch.device(device)
        self.beam = beam
        self.expansions = expansions
        self.lm = lm
        # the tables ride to the engine's device once, not every batch
        self.context = None if context is None else context.to(self.device)
        self.ngram = (None if ngram is None
                      else (ngram[0].to(self.device), ngram[1]))
        self.max_symbols = max_symbols
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.frame_buckets = tuple(sorted(frame_buckets))
        self.stats = EngineStats()
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # Guards the closed-check + enqueue against close(): an item is
        # either queued BEFORE the shutdown sentinel (the worker drains it
        # with an "engine closed" error) or the submit raises.
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _decode(self, feats: np.ndarray, lens: np.ndarray):
        """(max_batch, T, D) feats -> numpy (tokens, lens, confs, frames),
        in beam mode (tokens, lens, scores, confs, frames) of every beam."""
        with torch.inference_mode():
            f = torch.from_numpy(feats).to(self.device)
            n = torch.from_numpy(lens).to(self.device)
            if self.mode == "greedy":
                out = recognize_greedy(
                    self.params, self.cfg, f, n,
                    max_symbols=self.max_symbols, with_confidence=True,
                    with_timestamps=True)
            else:
                out = recognize_beam(
                    self.params, self.cfg, f, n, beam=self.beam,
                    max_symbols=self.max_symbols,
                    expansions=self.expansions, lm=self.lm,
                    context=self.context, ngram=self.ngram,
                    with_confidence=True, with_timestamps=True)
            return tuple(a.cpu().numpy() for a in out)

    def warmup(self):
        """Run every bucket shape once before serving traffic. On a card
        this builds and loads the kernel library and creates the cuBLAS
        handles, so the worker thread never builds."""
        D = self.cfg.input_dim
        for tb in self.frame_buckets:
            f = np.zeros((self.max_batch, tb, D), np.float32)
            l = np.full((self.max_batch,), tb, np.int32)
            self._decode(f, l)

    def submit(self, feats: np.ndarray) -> list[int]:
        """feats: (T, input_dim) float32 -> token id list. Blocking."""
        return self.submit_full(feats)["tokens"]

    def submit_full(self, feats: np.ndarray) -> dict:
        """feats -> {"tokens", "confidence", "frames", and for beam engines
        "score" + "nbest": [{"tokens", "score"}, ...]}. Blocking.

        "frames" holds each token's emission timestamp as an INPUT
        feature-frame index (encoder frame x cfg.time_reduction).
        Validation happens here, in the caller's thread, so a malformed
        request fails alone instead of poisoning its co-batched group.
        """
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.cfg.input_dim:
            raise ValueError(
                f"feats must be (T, {self.cfg.input_dim}); got "
                f"{feats.shape}")
        T = feats.shape[0]
        if T < 1:
            raise ValueError("empty utterance")
        if T > self.frame_buckets[-1]:
            raise ValueError(
                f"utterance of {T} frames exceeds the largest serving "
                f"bucket {self.frame_buckets[-1]}")
        done = threading.Event()
        item = {"feats": feats, "done": done, "result": None, "error": None}
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine closed")
            self._q.put(item)
        done.wait()
        if item["error"]:
            raise RuntimeError(item["error"])
        return item["result"]

    def close(self):
        """Stop the worker: queued requests fail with "engine closed"."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=30)

    def _drain_closed(self, extra=()):
        """Fail every still-queued waiter on shutdown (never strand)."""
        items = list(extra)
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                items.append(it)
        for it in items:
            it["error"] = "engine closed"
            it["done"].set()

    # -- worker ------------------------------------------------------------

    def _bucket_for(self, T: int) -> int:
        for tb in self.frame_buckets:
            if T <= tb:
                return tb
        return self.frame_buckets[-1]

    def _run(self):
        while True:
            item = self._q.get()
            if item is None or self._closed:
                self._drain_closed([item] if item is not None else [])
                return
            batch = [item]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-arm the sentinel for the top
                    break
                batch.append(nxt)
            try:
                self._process(batch)
            except Exception as e:  # deliver the failure to every waiter
                for it in batch:
                    it["error"] = repr(e)
                    it["done"].set()

    NEG_INF_HALF = -5.0e29  # beams below this are dead (decode/beam.py)

    def _process(self, batch):
        D = self.cfg.input_dim
        tb = max(self._bucket_for(it["feats"].shape[0]) for it in batch)
        feats = np.zeros((self.max_batch, tb, D), np.float32)
        lens = np.zeros((self.max_batch,), np.int32)
        for i, it in enumerate(batch):
            f = it["feats"]
            feats[i, : f.shape[0]] = f
            lens[i] = f.shape[0]
        t0 = time.perf_counter()
        out = self._decode(feats, lens)
        self.stats.record(len(batch), time.perf_counter() - t0)
        tr = self.cfg.time_reduction
        if self.mode == "greedy":
            toks, tlens, confs, frames = out
            for i, it in enumerate(batch):
                n = tlens[i]
                it["result"] = {
                    "tokens": toks[i, :n].tolist(),
                    "confidence": np.round(confs[i, :n], 4).tolist(),
                    "frames": (frames[i, :n] * tr).tolist(),
                }
                it["done"].set()
            return
        # beam: the n-best, the top beam's score, confidences and frames
        toks, tlens, scores, confs, frames = out
        for i, it in enumerate(batch):
            n0 = tlens[i, 0]
            nbest = [
                {"tokens": toks[i, k, : tlens[i, k]].tolist(),
                 "score": round(float(scores[i, k]), 4)}
                for k in range(toks.shape[1])
                if scores[i, k] > self.NEG_INF_HALF
            ]
            it["result"] = {
                "tokens": toks[i, 0, :n0].tolist(),
                "score": round(float(scores[i, 0]), 4),
                "confidence": np.round(confs[i, 0, :n0], 4).tolist(),
                "frames": (frames[i, 0, :n0] * tr).tolist(),
                "nbest": nbest,
            }
            it["done"].set()


# --------------------------------------------------------------------------
# HTTP transport (stdlib)
# --------------------------------------------------------------------------

def _feats_from_body(body: dict) -> np.ndarray:
    """Request body -> (T, input_dim) features ({"feats": [[...]]})."""
    if "feats" in body:
        return np.asarray(body["feats"], np.float32)
    if "audio" in body:
        raise ValueError("'audio' bodies are not yet ported (ROADMAP queue "
                         "1, item 5: FBANK frontend); send 'feats'")
    raise ValueError("body needs 'feats'")


def http_server(host: str, port: int, offline: BatchingEngine,
                max_body_bytes: int = 32 << 20):
    """Build (not start) a ThreadingHTTPServer exposing the engine.

    POST /recognize  {"feats": [[...]]}  -> {"tokens", "confidence", "frames"}
                     (beam engines also "score" and "nbest")
    GET  /stats | /healthz

    Bodies above `max_body_bytes` are rejected with 413 before being read.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _TooLarge(Exception):
        pass

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n > max_body_bytes:
                # Discard the body in bounded chunks so the client can read
                # the 413, but give up draining past 4x the cap.
                left = min(n, 4 * max_body_bytes)
                while left > 0:
                    chunk = self.rfile.read(min(left, 1 << 16))
                    if not chunk:
                        break
                    left -= len(chunk)
                raise _TooLarge(
                    f"body of {n} bytes exceeds cap {max_body_bytes}")
            return json.loads(self.rfile.read(n)) if n else {}

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, {"offline": offline.stats.summary()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                if self.path == "/recognize":
                    feats = _feats_from_body(self._body())
                    self._json(200, offline.submit_full(feats))
                else:
                    self._json(404, {"error": "not found"})
            except _TooLarge as e:
                self.close_connection = True
                self._json(413, {"error": str(e)})
            except Exception as e:
                self._json(400, {"error": repr(e)})

        def do_DELETE(self):
            self._json(404, {"error": "not found"})

    return ThreadingHTTPServer((host, port), Handler)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def get_model_config(name: str | None):
    """--config value -> TransducerConfig: "smoke" (the JAX CLIs' default),
    a NAMED_CONFIGS key, or a JSON file of TransducerConfig fields."""
    from rnn_transducer_tpu_torch.models.config import (NAMED_CONFIGS,
                                                        TransducerConfig)
    if name is None or name == "smoke":
        return TransducerConfig(enc_layers=1, enc_hidden=64, pred_layers=1,
                                pred_hidden=64, embed_dim=32, joint_dim=64,
                                vocab_size=32, input_dim=80)
    if name in NAMED_CONFIGS:
        return NAMED_CONFIGS[name]()
    with open(name) as f:
        return TransducerConfig(**json.load(f))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="RNN-T recognition server (PyTorch, CUDA)")
    p.add_argument("--config", default=None,
                   help="named config or JSON file (default: smoke)")
    p.add_argument("--state-dict", default=None,
                   help="torch-layout .pt from tools/export_torch_ckpt.py; "
                        "omit for fresh weights from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--mode", default="greedy", choices=["greedy", "beam"])
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--max-symbols", type=int, default=100)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--frame-buckets", type=int, nargs="+",
                   default=[200, 400, 800])
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="post-training weight quantization: symmetric "
                        "per-channel int8 on every 2-D weight "
                        "(ops/quant.py)")
    p.add_argument("--ngram", default=None,
                   help="n-gram LM artifact (the JAX package's "
                        "tools/train_ngram.py writes one; models/ngram.py "
                        "save_ngram too), fused in beam mode")
    p.add_argument("--ngram-weight", type=float, default=0.3)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_model_config(args.config)
    ngram = None
    if args.ngram:
        if args.mode != "beam":
            raise SystemExit("--ngram requires --mode beam")
        from rnn_transducer_tpu_torch.models.ngram import load_ngram
        ng_lm = load_ngram(args.ngram)
        if ng_lm.lp.shape[1] != cfg.vocab_size:
            raise SystemExit(f"n-gram vocab {ng_lm.lp.shape[1]} != model "
                             f"vocab {cfg.vocab_size}")
        ngram = (ng_lm, args.ngram_weight)
        print(f"n-gram fusion: {args.ngram} ({ng_lm.lp.shape[0]} states)",
              file=sys.stderr)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this server runs on the GPU")
    from rnn_transducer_tpu_torch.weights import load_state_dict

    if args.state_dict:
        params = load_state_dict(args.state_dict, cfg, "cuda")
    else:
        params = m.init_params(cfg, np.random.default_rng(args.seed), "cuda")
    if args.quantize == "int8":
        from rnn_transducer_tpu_torch.ops.quant import (quantize_params,
                                                        quantized_bytes)
        params = quantize_params(params)
        qb, fb = quantized_bytes(params)
        print(f"int8 weights: {qb / 1e6:.1f} MB (fp32 {fb / 1e6:.1f} MB)",
              file=sys.stderr)
    engine = BatchingEngine(params, cfg, mode=args.mode, beam=args.beam,
                            max_symbols=args.max_symbols,
                            frame_buckets=args.frame_buckets,
                            max_batch=args.max_batch,
                            window_ms=args.window_ms, ngram=ngram,
                            device="cuda")
    print("warming up (one decode per bucket)...", file=sys.stderr)
    engine.warmup()
    srv = http_server(args.host, args.port, engine)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"(mode={args.mode}, max_batch={args.max_batch}, "
          f"{torch.cuda.get_device_name(0)})", file=sys.stderr)
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.close()
        print("drained and closed", file=sys.stderr)


if __name__ == "__main__":
    main()
