"""Serving runtime: dynamic request batching over HTTP (PyTorch port of
`rnn_transducer_tpu/serve.py`, greedy offline recognition).

`BatchingEngine` queues requests on the host; a worker thread drains up to
`max_batch` of them inside a `window_ms` batching window, pads them to a
fixed (max_batch, bucket_frames) shape and runs one greedy decode for the
whole group on the engine's device. `http_server` exposes it over stdlib
HTTP with JSON bodies.

Not ported yet, each with its ROADMAP item (queue 1): beam mode (item 3),
streaming sessions (item 4: the session routes answer 404, as the JAX
server does with streaming off), raw-audio bodies (item 5: the FBANK
frontend), LM / n-gram / context fusion (item 14) and int8 (item 15).

    python -m rnn_transducer_tpu_torch.serve --config libri100 --port 8000
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

    def __init__(self, params, cfg, *, mode: str = "greedy",
                 max_symbols: int = 100, frame_buckets=(200, 400, 800),
                 max_batch: int = 8, window_ms: float = 5.0,
                 device: str | torch.device = "cpu"):
        if mode != "greedy":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet (ROADMAP queue 1, item 3: "
                "beam decode)")
        m.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
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
        """(max_batch, T, D) feats -> numpy (tokens, lens, confs, frames)."""
        with torch.inference_mode():
            out = recognize_greedy(
                self.params, self.cfg,
                torch.from_numpy(feats).to(self.device),
                torch.from_numpy(lens).to(self.device),
                max_symbols=self.max_symbols, with_confidence=True,
                with_timestamps=True)
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
        """feats -> {"tokens", "confidence", "frames"}. Blocking.

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
        toks, tlens, confs, frames = self._decode(feats, lens)
        self.stats.record(len(batch), time.perf_counter() - t0)
        tr = self.cfg.time_reduction
        for i, it in enumerate(batch):
            n = tlens[i]
            it["result"] = {
                "tokens": toks[i, :n].tolist(),
                "confidence": np.round(confs[i, :n], 4).tolist(),
                "frames": (frames[i, :n] * tr).tolist(),
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
    p.add_argument("--max-symbols", type=int, default=100)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--frame-buckets", type=int, nargs="+",
                   default=[200, 400, 800])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this server runs on the GPU")
    from rnn_transducer_tpu_torch.weights import load_state_dict

    cfg = get_model_config(args.config)
    if args.state_dict:
        params = load_state_dict(args.state_dict, cfg, "cuda")
    else:
        params = m.init_params(cfg, np.random.default_rng(args.seed), "cuda")
    engine = BatchingEngine(params, cfg, max_symbols=args.max_symbols,
                            frame_buckets=args.frame_buckets,
                            max_batch=args.max_batch,
                            window_ms=args.window_ms, device="cuda")
    print("warming up (one decode per bucket)...", file=sys.stderr)
    engine.warmup()
    srv = http_server(args.host, args.port, engine)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"(greedy, max_batch={args.max_batch}, "
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
