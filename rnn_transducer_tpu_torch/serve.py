"""Serving runtime: dynamic request batching and streaming session slots
over HTTP (PyTorch port of `rnn_transducer_tpu/serve.py`).

Two engines, each running its decodes on the engine's device from a worker
thread of its own:

  * `BatchingEngine` queues offline requests on the host; the worker
    drains up to `max_batch` of them inside a `window_ms` batching window,
    pads them to a fixed (max_batch, bucket_frames) shape and runs one
    decode for the whole group: greedy (`mode="greedy"`) or beam search
    with prefix merging (`mode="beam"`, decode/beam.py), which answers the
    top beam's tokens, score, confidences and frames and the n-best list.
  * `StreamingEngine` serves live sessions on fixed slots. The stream
    state of all S slots is one tree of (S, ...) tensors; a tick feeds
    every session with a chunk pending through one `encode_chunk` and one
    decode step of all S rows (decode/streaming.py), and the idle slots'
    rows are re-selected from the old state, so they do not move. Opening a
    session takes a free slot.

In beam mode both engines take shallow fusion as the JAX engines do:
`lm=(params, LMConfig or TransformerLMConfig, weight[, ilm_weight])`,
`context=` a decode/context.py ContextBias and `ngram=(NgramLM, weight)`
(`--ngram FILE --ngram-weight W` on the CLI; `--boost-file` phrases,
encoded with the checkpoint's tokenizer, for `context=`). `http_server`
exposes the engines over stdlib HTTP with JSON bodies: precomputed
features, or raw 16 kHz PCM featurized by `ops/logmel.log_mel` on the
engine's device (a PcmFeaturizer a session for PCM sessions), with
"text" and word segments (decode/words.py) whenever a tokenizer is known.

`--ckpt-dir` serves a directory written by the port's trainer (`python -m
rnn_transducer_tpu_torch.train --ckpt-dir D [--tokenizer SPEC]`), LSTM
or conformer: the model config, the tokenizer and the global CMVN stats
come from its meta.json, and a `--config` that differs is refused;
`--use-ema` serves its Polyak average (a run with --ema-decay).
`--config libri100_conformer` serves the conformer encoder (every
LayerNorm in the K8 kernel, `csrc/fused_ln.cu`); its streaming twins
`libri100_conformer_stream` (causal) and `libri100_conformer_chunked`
(chunked attention, `--chunk-frames 128`) serve sessions too. `--quantize
int8` serves post-training int8 weights (`ops/quant.py`): the encoder's
LSTM layers run the W8A8 recurrence (CUDA kernel `csrc/lstm_fwd_q.cu`) at
batch sizes that are a multiple of 8, such as the default `--max-batch 8`
and `--stream-slots 8`, and the dequantized weights elsewhere; a
conformer dequantizes every weight, as in the JAX package.

Not ported yet, each with its ROADMAP item (queue 1): `--lm-ckpt` /
`--lm-weight` / `--ilm-weight` (item 18: the LM
checkpoints are orbax files, which the port does not read; the engines'
`lm=` takes an LM's params directly) and `--exported-streaming` (item 18:
the export tool).

    python -m rnn_transducer_tpu_torch.serve --ckpt-dir ckpt --port 8000
    python -m rnn_transducer_tpu_torch.serve --config libri100 --port 8000
    python -m rnn_transducer_tpu_torch.serve --config libri100 --mode beam
    python -m rnn_transducer_tpu_torch.serve --config libri100 --mode beam \
        --ngram lm3.npz --ngram-weight 0.3
    python -m rnn_transducer_tpu_torch.serve --ckpt-dir ckpt --mode beam \
        --boost-file phrases.txt
    python -m rnn_transducer_tpu_torch.serve --config libri100 --quantize int8
    python -m rnn_transducer_tpu_torch.serve --config libri100_conformer
    python -m rnn_transducer_tpu_torch.serve \
        --config libri100_conformer_chunked --chunk-frames 128
    curl -XPOST localhost:8000/recognize -d '{"feats": [[...80 floats...]]}'
    curl -XPOST localhost:8000/recognize -d '{"audio": [...16 kHz PCM...]}'
    curl -XPOST localhost:8000/session                      # -> {"sid": ...}
    curl -XPOST localhost:8000/session/<sid> -d '{"feats": [[...]]}'
    curl -XPOST localhost:8000/session/<sid> -d '{"audio": [...PCM...]}'
    curl -XPOST localhost:8000/session/<sid> \
        -d '{"feats": [[...]], "last": true}'          # the last chunk
    curl -XDELETE localhost:8000/session/<sid>
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
import uuid

import numpy as np
import torch

from rnn_transducer_tpu_torch.data.cmvn import apply_cmvn
from rnn_transducer_tpu_torch.data.pcm_stream import PcmFeaturizer
from rnn_transducer_tpu_torch.data.tokenizer import decode_to_text
from rnn_transducer_tpu_torch.decode import streaming as st
from rnn_transducer_tpu_torch.decode.beam import (recognize_beam,
                                                  sorted_confidence,
                                                  sorted_frames)
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.decode.words import attach_words
from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.ops.logmel import featurize


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


class _WorkerEngine:
    """The queue, the batching window and the shutdown that both engines
    share: callers enqueue items ({"done", "result", "error", ...}) and
    block; one worker thread gathers up to `_cap` of them inside
    `window_s` and hands them to `_process(batch)`, which sets each
    item's result. After close() queued and later items fail with
    "engine closed"."""

    def _start(self, cap: int, window_ms: float):
        self._cap = cap
        self.window_s = window_ms / 1e3
        self.stats = EngineStats()
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # Guards the closed-check + enqueue against close(): an item is
        # either queued BEFORE the shutdown sentinel (the worker drains it
        # with an "engine closed" error) or the submit raises.
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _submit(self, item: dict):
        """Queue `item`, wait for the worker, return its result."""
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine closed")
            self._q.put(item)
        item["done"].wait()
        if item["error"]:
            raise RuntimeError(item["error"])
        return item["result"]

    def close(self):
        """Stop the worker: queued items fail with "engine closed"."""
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

    def _defer(self, batch: list, item: dict) -> bool:
        """True to hold `item` for a later batch."""
        return False

    def _run(self):
        while True:
            item = self._q.get()
            if item is None or self._closed:
                self._drain_closed([item] if item is not None else [])
                return
            batch, deferred = [item], []
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self._cap:
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
                (deferred if self._defer(batch, nxt) else batch).append(nxt)
            try:
                self._process(batch)
            except Exception as e:  # deliver the failure to every waiter
                for it in batch:
                    if not it["done"].is_set():
                        it["error"] = repr(e)
                        it["done"].set()
            for it in deferred:  # re-queue for the next batch
                self._q.put(it)


class BatchingEngine(_WorkerEngine):
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
        self.frame_buckets = tuple(sorted(frame_buckets))
        self._start(max_batch, window_ms)

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
        return self._submit({"feats": feats, "done": threading.Event(),
                             "result": None, "error": None})

    # -- worker ------------------------------------------------------------

    def _bucket_for(self, T: int) -> int:
        for tb in self.frame_buckets:
            if T <= tb:
                return tb
        return self.frame_buckets[-1]

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


def make_masked_chunk_step(cfg, *, slots: int, max_symbols: int = 200,
                           mode: str = "greedy", beam: int = 8,
                           expansions: int = 3, lm_cfg=None,
                           lm_weight: float = 0.3, ilm_weight: float = 0.0,
                           context=None, ngram=None,
                           device: str | torch.device = "cuda"):
    """The StreamingEngine's step as a standalone function.

    Returns (init_state_fn, gstep):
      init_state_fn(params, lm_params=None, decode_weights=None) -> the
        stream state of all slots on `device`;
      gstep(params, lm_params, state, chunks (S, C, D), lens (S,), active
        (S,) bool, decode_weights=None) -> (new_state, out), out a dict:
        greedy: {"tokens" (S, U), "lens" (S,), "confidence" (S, U),
                 "frames" (S, U), the global encoder frames of emission};
        beam:   {"tokens" (S, K, U), "lens" (S, K), "scores" (S, K),
                 "confidence" (S, K, U), "frames" (S, K, U)}, beams best
                 first.
    The rows of inactive slots are re-selected from `state`, so they pass
    through unchanged. `decode_weights`, a DecodeWeights of the params,
    spares a step building it. `context` and `ngram` (beam mode) are a
    ContextBias and (NgramLM, weight) whose tables lie on `device`.
    """
    S = slots
    lm_t = None
    if mode == "greedy":
        if context is not None or ngram is not None or lm_cfg is not None:
            raise ValueError("LM fusion / contextual biasing / n-gram fusion "
                             "require mode='beam'")

        def init_state_fn(params, lm_params=None, decode_weights=None):
            return st.init_stream(params, cfg, S, max_symbols, device=device,
                                  decode_weights=decode_weights)

        def chunk_step(p, lmp, state, chunks, lens, dw):
            new, toks, tok_lens = st.stream_chunk(p, cfg, state, chunks, lens,
                                                  max_symbols,
                                                  decode_weights=dw)
            return new, {"tokens": toks, "lens": tok_lens,
                         "confidence": new.decode_state[2],
                         "frames": new.decode_state[3]}
    elif mode == "beam":
        def lm_tuple(lmp):
            return (None if lm_cfg is None
                    else (lmp, lm_cfg, lm_weight, ilm_weight))

        def init_state_fn(params, lm_params=None, decode_weights=None):
            return st.init_stream_beam(
                params, cfg, S, beam=beam, max_symbols=max_symbols,
                lm=lm_tuple(lm_params), context=context, ngram=ngram,
                device=device, decode_weights=decode_weights)

        def chunk_step(p, lmp, state, chunks, lens, dw):
            new, toks, tok_lens, scores = st.stream_chunk_beam(
                p, cfg, state, chunks, lens, beam=beam,
                max_symbols=max_symbols, expansions=expansions,
                lm=lm_tuple(lmp), context=context, ngram=ngram,
                decode_weights=dw)
            return new, {"tokens": toks, "lens": tok_lens, "scores": scores,
                         "confidence": sorted_confidence(new.decode_state,
                                                         context),
                         "frames": sorted_frames(new.decode_state, context)}
    else:
        raise ValueError(f"unknown mode {mode!r}")

    def gstep(p, lmp, state, chunks, lens, active, decode_weights=None):
        new, out = chunk_step(p, lmp, state, chunks, lens, decode_weights)
        return st.select_rows(active, new, state), out

    return init_state_fn, gstep


class StreamingEngine(_WorkerEngine):
    """Continuous batching over fixed streaming-session slots.

    All S slots' stream state lives on the engine's device as one tree of
    (S, ...) tensors; a tick runs the chunk step for every slot with a
    per-slot active mask, so idle slots' state is carried through
    unchanged.

    Chunk contract: every chunk is exactly `chunk_frames` long except the
    LAST one (`feed(..., last=True)` or a short chunk, which implies last):
    the encoder's carried state past a partial chunk is undefined, so a
    short chunk in mid-stream would corrupt the session. After its last
    chunk a session only takes close_session().

    Sessions quiet for `session_ttl_s` are reaped when a new open_session()
    needs their slot, so abandoned clients cannot hold slots forever.

    endpoint_frames: when set, every feed_full result carries
    "trailing_frames" (input frames since the decoder's last emission,
    from the carried timestamps) and "endpoint": trailing_frames >=
    endpoint_frames. The caller decides whether to end the session.
    """

    NEG_INF_HALF = -5.0e29  # beams below this are dead (decode/beam.py)

    def __init__(self, params, cfg, *, slots: int = 8,
                 chunk_frames: int = 32, max_symbols: int = 200,
                 window_ms: float = 5.0, session_ttl_s: float = 600.0,
                 mode: str = "greedy", beam: int = 8, expansions: int = 3,
                 lm=None, context=None, ngram=None, endpoint_frames=None,
                 device: str | torch.device = "cuda"):
        m.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.mode = mode
        self.slots = slots
        self.chunk_frames = chunk_frames
        self.max_symbols = max_symbols
        self.session_ttl_s = session_ttl_s
        self.endpoint_frames = endpoint_frames
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._free = set(range(slots))
        self._live: dict[str, int] = {}  # sid -> slot
        self._last: dict[str, list[int]] = {}  # sid -> tokens so far
        self._fed: dict[str, int] = {}  # sid -> input frames fed so far
        self._finished: set[str] = set()  # saw their last (short) chunk
        self._seen: dict[str, float] = {}  # sid -> last activity time
        self._lm_params = lm[0] if lm else None
        if mode == "beam":  # the tables ride to the engine's device once
            if context is not None:
                context = context.to(self.device)
            if ngram is not None:
                ngram = (ngram[0].to(self.device), ngram[1])
        init_state_fn, self._step = make_masked_chunk_step(
            cfg, slots=slots, max_symbols=max_symbols, mode=mode, beam=beam,
            expansions=expansions, context=context, ngram=ngram,
            lm_cfg=None if lm is None else lm[1],
            lm_weight=0.3 if lm is None else lm[2],
            ilm_weight=lm[3] if lm is not None and len(lm) > 3 else 0.0,
            device=self.device)
        with torch.inference_mode():
            # the decode weights once an engine (the JAX step's jit
            # hoists them), not once a tick
            self._weights = m.DecodeWeights(params, cfg)
            self._init_state = init_state_fn(params, self._lm_params,
                                             self._weights)
        self.state = self._init_state
        self._state_lock = threading.Lock()  # ticks vs slot resets
        self._start(slots, window_ms)

    def _gstep(self, state, chunks, lens, active):
        with torch.inference_mode():
            return self._step(
                self.params, self._lm_params, state,
                torch.from_numpy(chunks).to(self.device),
                torch.from_numpy(lens).to(self.device),
                torch.from_numpy(active).to(self.device), self._weights)

    def warmup(self):
        """One tick with every slot idle, before serving traffic: on a card
        it builds and loads the kernel library and creates the cuBLAS
        handles. The state does not move."""
        D = self.cfg.input_dim
        chunks = np.zeros((self.slots, self.chunk_frames, D), np.float32)
        lens = np.zeros((self.slots,), np.int32)
        active = np.zeros((self.slots,), bool)
        with self._state_lock:
            self.state, out = self._gstep(self.state, chunks, lens, active)
            out["tokens"].cpu()

    def open_session(self) -> str:
        if self._closed:
            raise RuntimeError("engine closed")
        with self._lock:
            if not self._free:
                self._reap_expired_locked()
            if not self._free:
                raise RuntimeError(f"all {self.slots} streaming slots busy")
            slot = self._free.pop()
            sid = uuid.uuid4().hex[:12]
            self._live[sid] = slot
            self._last[sid] = []
            self._fed[sid] = 0
            self._seen[sid] = time.monotonic()
        return sid

    def _reap_expired_locked(self):
        now = time.monotonic()
        stale = [sid for sid, t in self._seen.items()
                 if sid in self._live and now - t > self.session_ttl_s]
        for sid in stale:
            self._release_locked(sid)

    def _release_locked(self, sid: str):
        slot = self._live.pop(sid)
        final = self._last.pop(sid, [])
        self._seen.pop(sid, None)
        self._fed.pop(sid, None)
        self._finished.discard(sid)
        mask = torch.zeros((self.slots,), dtype=torch.bool)
        mask[slot] = True
        with self._state_lock, torch.inference_mode():
            self.state = st.select_rows(mask.to(self.device),
                                        self._init_state, self.state)
        self._free.add(slot)
        return final

    def feed(self, sid: str, chunk: np.ndarray, last: bool = False):
        """chunk: (C, input_dim); C == chunk_frames unless this is the
        session's last chunk. Blocks for the tick; returns the cumulative
        token ids of the session."""
        return self.feed_full(sid, chunk, last)["tokens"]

    def feed_full(self, sid: str, chunk: np.ndarray, last: bool = False):
        """Like feed() but returns the whole partial result: {"tokens",
        "confidence", "frames", "stable_len", and in beam mode "score" and
        "nbest"}. stable_len is the length of the prefix every live beam
        agrees on, which no later chunk retracts (greedy output is final:
        stable_len == len(tokens)). "frames" are the tokens' emission
        times as input feature frames (encoder frame x time_reduction)."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[1] != self.cfg.input_dim:
            raise ValueError(
                f"chunk must be (C, {self.cfg.input_dim}); got "
                f"{chunk.shape}")
        C = chunk.shape[0]
        if C < 1 or C > self.chunk_frames:
            raise ValueError(
                f"chunk of {C} frames outside [1, {self.chunk_frames}]")
        last = last or C < self.chunk_frames
        with self._lock:
            if sid not in self._live:
                raise KeyError(f"unknown session {sid!r}")
            if sid in self._finished:
                raise ValueError(
                    f"session {sid!r} already received its last chunk "
                    "(a short chunk ends the stream); close it")
            if last:
                self._finished.add(sid)
            self._seen[sid] = time.monotonic()
            slot = self._live[sid]
        result = self._submit({"sid": sid, "slot": slot, "chunk": chunk,
                               "done": threading.Event(), "result": None,
                               "error": None})
        with self._lock:
            if self._live.get(sid) == slot:  # still the owner
                self._last[sid] = result["tokens"]
                self._seen[sid] = time.monotonic()
                self._fed[sid] = self._fed.get(sid, 0) + C
            fed = self._fed.get(sid, 0)
        if self.endpoint_frames is not None:
            # trailing silence from the timestamps: input frames past the
            # last emission's span (time_reduction input frames a token)
            frames = result["frames"]
            tr = self.cfg.time_reduction
            trailing = fed - (frames[-1] + tr) if frames else fed
            result["trailing_frames"] = trailing
            result["endpoint"] = trailing >= self.endpoint_frames
        return result

    def close_session(self, sid: str) -> list[int]:
        with self._lock:
            if sid not in self._live:
                raise KeyError(f"unknown session {sid!r}")
            return self._release_locked(sid)

    # -- worker ------------------------------------------------------------

    def _defer(self, batch: list, item: dict) -> bool:
        # a session's next chunk waits for the tick after its last one
        return any(it["slot"] == item["slot"] for it in batch)

    def _process(self, items: list):
        batch = {it["slot"]: it for it in items}
        # The ownership check and the step are one under _lock (lock order
        # _lock -> _state_lock, as in _release_locked): a chunk whose
        # session closed, or whose slot was reassigned, between feed() and
        # this tick must not advance the slot's state.
        with self._lock:
            stale = [slot for slot, it in batch.items()
                     if self._live.get(it["sid"]) != slot]
            for slot in stale:
                it = batch.pop(slot)
                it["error"] = f"session {it['sid']!r} closed"
                it["done"].set()
            if not batch:
                return
            D = self.cfg.input_dim
            chunks = np.zeros((self.slots, self.chunk_frames, D),
                              np.float32)
            lens = np.zeros((self.slots,), np.int32)
            active = np.zeros((self.slots,), bool)
            for slot, it in batch.items():
                c = it["chunk"]
                chunks[slot, : c.shape[0]] = c
                lens[slot] = c.shape[0]
                active[slot] = True
            t0 = time.perf_counter()
            with self._state_lock:
                self.state, out = self._gstep(self.state, chunks, lens,
                                              active)
            out = {k: v.cpu().numpy() for k, v in out.items()}
        self.stats.record(len(batch), time.perf_counter() - t0)
        for slot, it in batch.items():
            it["result"] = self._slot_result(out, slot)
            it["done"].set()

    def _slot_result(self, out, slot: int) -> dict:
        """A slot's partial result from the tick's output arrays."""
        tr = self.cfg.time_reduction
        if self.mode == "greedy":
            n = out["lens"][slot]
            toks = out["tokens"][slot, :n].tolist()
            return {"tokens": toks,
                    "confidence": np.round(
                        out["confidence"][slot, :n], 4).tolist(),
                    "frames": (out["frames"][slot, :n] * tr).tolist(),
                    "stable_len": len(toks)}  # greedy output is final
        toks, lens = out["tokens"][slot], out["lens"][slot]
        scores, confs = out["scores"][slot], out["confidence"][slot]
        alive = [k for k in range(toks.shape[0])
                 if scores[k] > self.NEG_INF_HALF]
        top = toks[0, : lens[0]].tolist()
        # the stable prefix: the longest prefix all live beams agree on; a
        # later chunk only extends live beams, it never rewrites that
        stable = len(top)
        for k in alive[1:]:
            n = min(stable, lens[k])
            agree = int(np.argmin(np.concatenate(
                [toks[0, :n] == toks[k, :n], [False]])))
            stable = min(stable, agree)
        return {"tokens": top,
                "score": round(float(scores[0]), 4),
                "confidence": np.round(confs[0, : lens[0]], 4).tolist(),
                "frames": (out["frames"][slot][0, : lens[0]] * tr).tolist(),
                "nbest": [{"tokens": toks[k, : lens[k]].tolist(),
                           "score": round(float(scores[k]), 4)}
                          for k in alive],
                "stable_len": stable}


# --------------------------------------------------------------------------
# HTTP transport (stdlib)
# --------------------------------------------------------------------------

def _feats_from_body(body: dict, cfg, cmvn=None,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Request body -> (T, input_dim) features.

    Accepts precomputed {"feats": [[...]]} or raw 16 kHz PCM
    {"audio": [...]}, featurized by `log_mel` on `device` (the engine's:
    on a card engine the frontend runs on the card or the request fails).
    `cmvn`: global stats from the checkpoint's meta (data/cmvn.py),
    applied to BOTH body forms, so a client sending raw audio needs no
    knowledge of the training-time normalization. Audio shorter than one
    window gives no frame, which the engine refuses as an empty
    utterance."""
    if "feats" in body:
        feats = np.asarray(body["feats"], np.float32)
    else:
        if "audio" not in body:
            raise ValueError("body needs 'feats' or 'audio'")
        audio = np.asarray(body["audio"], np.float32)
        if audio.ndim != 1:
            raise ValueError(f"audio must be 1-D PCM; got {audio.shape}")
        feats = featurize(audio, device=device, n_mels=cfg.input_dim)
    if cmvn is not None:
        feats = apply_cmvn(feats, cmvn)
    return feats


def http_server(host: str, port: int, offline: BatchingEngine,
                streaming: StreamingEngine | None = None, tok=None,
                max_body_bytes: int = 32 << 20, cmvn=None,
                frame_hop_s: float = 0.01):
    """Build (not start) a ThreadingHTTPServer exposing the engines.

    POST /recognize        {"feats": [[...]]} or {"audio": [...16 kHz PCM]}
                           -> {"tokens", "confidence", "frames"} (beam
                           engines also "score", "nbest"), with "text" and
                           "words" when a tokenizer is known
    POST /session                             -> {"sid": ...}
    POST /session/<sid>    {"feats"|"audio", "last"?} -> the cumulative
                           partial result (feed_full)
    DELETE /session/<sid>                     -> {"tokens": final tokens}
    GET  /stats | /healthz

    Audio is featurized on the engine's device. A session POSTing
    {"audio"} gets a PcmFeaturizer of its own (data/pcm_stream.py: exact
    against offline featurization under any split) and a feature buffer:
    whole `chunk_frames` slices feed the engine, the rest waits for more
    audio, a POST that completes no slice answers the session's last
    result with "pending_frames", and {"last": true} flushes the short
    tail. `frame_hop_s` times the word segments. With streaming=None
    every /session route answers 404. Bodies above `max_body_bytes` are
    rejected with 413 before being read.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _TooLarge(Exception):
        pass

    # -- raw-PCM streaming sessions: sid -> featurizer, buffer, result ----
    pcm_lock = threading.Lock()
    pcm_sess: dict[str, dict] = {}

    def _pcm_state(sid: str) -> dict:
        with pcm_lock:
            st = pcm_sess.get(sid)
            if st is None:
                d = streaming.cfg.input_dim
                st = pcm_sess[sid] = {
                    "fe": PcmFeaturizer(d, device=streaming.device),
                    "buf": np.zeros((0, d), np.float32),
                    "res": {"tokens": [], "confidence": [], "frames": [],
                            "stable_len": 0},
                    "lock": threading.Lock(),
                }
            return st

    def _pcm_drop(sid: str):
        with pcm_lock:
            pcm_sess.pop(sid, None)
            # engine sessions also die by TTL reaping without a DELETE:
            # purge the adapters of sids the engine no longer knows
            with streaming._lock:
                live = set(streaming._live)
            for stale in [s for s in pcm_sess if s not in live]:
                del pcm_sess[stale]

    def _pcm_feed(sid: str, audio: np.ndarray, last: bool) -> dict:
        st = _pcm_state(sid)
        with st["lock"]:
            new = st["fe"].feed(audio)
            if cmvn is not None and new.shape[0]:
                new = apply_cmvn(new, cmvn)
            buf = np.concatenate([st["buf"], new], axis=0)
            C = streaming.chunk_frames
            slices = []
            while buf.shape[0] >= C:
                slices.append(buf[:C])
                buf = buf[C:]
            if last and buf.shape[0]:
                slices.append(buf)  # a short final slice ends the stream
                buf = buf[:0]
            st["buf"] = buf
            res = None
            try:
                for i, s in enumerate(slices):
                    res = streaming.feed_full(
                        sid, s, last=last and i == len(slices) - 1)
            except KeyError:
                _pcm_drop(sid)
                raise
            if res is not None:
                st["res"] = res
            else:
                res = dict(st["res"])
                res["pending_frames"] = int(st["buf"].shape[0])
            return res

    def result(r):
        """r: a token id list (close_session) or a result dict -> the JSON
        payload, with "text" (and each n-best entry's) and "words" (when
        the payload has frames) whenever a tokenizer is known."""
        out = dict(r) if isinstance(r, dict) else {"tokens": r}
        if tok is not None:
            out["text"] = decode_to_text(tok, out["tokens"])
            for h in out.get("nbest", []):
                h["text"] = decode_to_text(tok, h["tokens"])
            attach_words(out, tok, hop_s=frame_hop_s)
        return out

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
                out = {"offline": offline.stats.summary()}
                if streaming is not None:
                    out["streaming"] = streaming.stats.summary()
                self._json(200, out)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                if self.path == "/recognize":
                    feats = _feats_from_body(self._body(), offline.cfg, cmvn,
                                             offline.device)
                    self._json(200, result(offline.submit_full(feats)))
                elif self.path == "/session" and streaming is not None:
                    # read any body: a reply over unread request bytes
                    # makes the close reset the connection under it
                    self._body()
                    self._json(200, {"sid": streaming.open_session()})
                elif (self.path.startswith("/session/")
                      and streaming is not None):
                    sid = self.path.split("/")[2]
                    body = self._body()
                    last = bool(body.get("last", False))
                    if "audio" in body and "feats" not in body:
                        audio = np.asarray(body["audio"], np.float32)
                        if audio.ndim != 1:
                            raise ValueError(
                                f"audio must be 1-D PCM; got {audio.shape}")
                        self._json(200, result(_pcm_feed(sid, audio, last)))
                    else:
                        feats = _feats_from_body(body, streaming.cfg, cmvn,
                                                 streaming.device)
                        self._json(200, result(streaming.feed_full(
                            sid, feats, last=last)))
                else:
                    self._json(404, {"error": "not found"})
            except _TooLarge as e:
                self.close_connection = True
                self._json(413, {"error": str(e)})
            except Exception as e:
                self._json(400, {"error": repr(e)})

        def do_DELETE(self):
            try:
                if self.path.startswith("/session/") and streaming is not None:
                    sid = self.path.split("/")[2]
                    out = result(streaming.close_session(sid))
                    _pcm_drop(sid)
                    self._json(200, out)
                else:
                    self._json(404, {"error": "not found"})
            except Exception as e:
                self._json(400, {"error": repr(e)})

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
    p.add_argument("--ckpt-dir", default=None,
                   help="a checkpoint directory of the port's trainer "
                        "(python -m rnn_transducer_tpu_torch.train "
                        "--ckpt-dir): the model config, tokenizer and "
                        "CMVN come from its meta.json; omit for fresh "
                        "weights (--config)")
    p.add_argument("--config", default=None,
                   help="named config or JSON file (default: the "
                        "checkpoint's, else smoke); must match --ckpt-dir's")
    p.add_argument("--state-dict", default=None,
                   help="torch-layout .pt from tools/export_torch_ckpt.py "
                        "(LSTM encoders); omit for fresh weights from --seed")
    p.add_argument("--use-ema", action="store_true",
                   help="serve --ckpt-dir's EMA params (trained with "
                        "--ema-decay > 0)")
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
    p.add_argument("--stream-slots", type=int, default=8,
                   help="0 disables the streaming endpoints")
    p.add_argument("--chunk-frames", type=int, default=32)
    p.add_argument("--endpoint-frames", type=int, default=None,
                   help="end-of-utterance detector for streaming "
                        "sessions: add 'endpoint'/'trailing_frames' to "
                        "partial results once this many input frames "
                        "pass without a decoder emission (10 ms/frame)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="post-training weight quantization: symmetric "
                        "per-channel int8 on every 2-D weight "
                        "(ops/quant.py)")
    p.add_argument("--ngram", default=None,
                   help="n-gram LM artifact (the JAX package's "
                        "tools/train_ngram.py writes one; models/ngram.py "
                        "save_ngram too), fused in beam mode")
    p.add_argument("--ngram-weight", type=float, default=0.3)
    p.add_argument("--boost-file", default=None,
                   help="contextual-biasing phrase list (beam mode): one "
                        "phrase per line, optional <TAB><per-token boost>; "
                        "encoded with the checkpoint's tokenizer and "
                        "boosted in both beam engines (decode/context.py)")
    p.add_argument("--boost-score", type=float, default=2.0,
                   help="default per-token boost for --boost-file phrases")
    p.add_argument("--max-body-bytes", type=int, default=32 << 20)
    p.add_argument("--frame-hop-s", type=float, default=0.01,
                   help="feature frame hop in seconds, for the word-level "
                        "segment times in responses (default 10 ms)")
    return p.parse_args(argv)


def model_meta(args):
    """The model's config, tokenizer and global CMVN stats, from
    --ckpt-dir's meta.json (else --config): (cfg, tok, cmvn). Reads no
    weights, so the CLIs' refusals come before any device work. A
    --config that differs from the checkpoint's is refused. The decode
    CLI (recognize.py) shares it and `load_params`."""
    from rnn_transducer_tpu_torch.data.tokenizer import tokenizer_from_meta
    from rnn_transducer_tpu_torch.train import checkpoint as ckpt

    if args.ckpt_dir and getattr(args, "state_dict", None):
        raise SystemExit("--ckpt-dir and --state-dict are two sources of "
                         "weights; give one")
    saved = ckpt.load_model_config(args.ckpt_dir) if args.ckpt_dir else None
    if args.ckpt_dir and saved is None:
        raise SystemExit(f"--ckpt-dir {args.ckpt_dir}: no meta.json with "
                         "its model config")
    if args.config is not None:
        cfg = get_model_config(args.config)
        if saved is not None and saved != cfg:
            raise SystemExit("--config does not match the checkpoint")
    else:
        cfg = saved if saved is not None else get_model_config(None)
    meta = (ckpt.load_meta(args.ckpt_dir) or {}) if args.ckpt_dir else {}
    tok = (tokenizer_from_meta(meta["tokenizer"]) if meta.get("tokenizer")
           else None)
    return cfg, tok, meta.get("cmvn") or None


def load_params(args, cfg, device: str | torch.device = "cuda"):
    """The served weights on `device`: --ckpt-dir's latest step (its EMA
    under --use-ema), --state-dict's .pt, or fresh ones from --seed; int8
    under --quantize."""
    from rnn_transducer_tpu_torch.train import checkpoint as ckpt
    from rnn_transducer_tpu_torch.weights import load_state_dict

    use_ema = getattr(args, "use_ema", False)
    if use_ema and not args.ckpt_dir:
        raise SystemExit("--use-ema needs --ckpt-dir")
    if args.ckpt_dir:
        try:
            params, _, step, _ = ckpt.load_plain_params(
                args.ckpt_dir, cfg, prefer_ema=use_ema, device=device)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        print(f"loaded checkpoint step {step}"
              + (" (EMA params)" if use_ema else ""), file=sys.stderr)
    elif getattr(args, "state_dict", None):  # serve.py's flag alone
        params = load_state_dict(args.state_dict, cfg, device)
    else:
        params = m.init_params(cfg, np.random.default_rng(args.seed), device)
    if args.quantize == "int8":
        from rnn_transducer_tpu_torch.ops.quant import (quantize_params,
                                                        quantized_bytes)
        params = quantize_params(params)
        qb, fb = quantized_bytes(params)
        print(f"int8 weights: {qb / 1e6:.1f} MB (fp32 {fb / 1e6:.1f} MB)",
              file=sys.stderr)
    return params


def main(argv=None):
    args = parse_args(argv)
    cfg, tok, cmvn = model_meta(args)
    if cmvn is not None:
        print("applying global CMVN from checkpoint meta", file=sys.stderr)
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
    context = None
    if args.boost_file:
        if args.mode != "beam":
            raise SystemExit("--boost-file requires --mode beam")
        if tok is None:
            raise SystemExit("--boost-file needs a checkpoint with a "
                             "tokenizer in meta.json")
        from rnn_transducer_tpu_torch.decode.context import (
            build_context_bias, load_boost_phrases)
        phrases, boosts = load_boost_phrases(
            args.boost_file, tok, default_boost=args.boost_score)
        context = build_context_bias(phrases, cfg.vocab_size,
                                     blank=cfg.blank, boosts=boosts)
        print(f"boosting {len(phrases)} phrases from {args.boost_file}",
              file=sys.stderr)
    # streaming needs a streamable encoder (a unidirectional LSTM, or a
    # causal or chunked-attention conformer): an offline-only model serves
    # /recognize with streaming off
    stream = args.stream_slots > 0 and cfg.streamable
    if stream and cfg.enc_type == "conformer" and cfg.enc_chunk_att > 0:
        # chunked-attention exactness needs chunk starts on the grid
        enc_chunk = args.chunk_frames // max(cfg.time_reduction, 1)
        if enc_chunk % cfg.enc_chunk_att != 0:
            raise SystemExit(
                f"--chunk-frames {args.chunk_frames} gives {enc_chunk} "
                f"encoded frames/chunk, not a multiple of enc_chunk_att "
                f"{cfg.enc_chunk_att}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this server runs on the GPU")
    params = load_params(args, cfg, "cuda")
    engine = BatchingEngine(params, cfg, mode=args.mode, beam=args.beam,
                            max_symbols=args.max_symbols,
                            frame_buckets=args.frame_buckets,
                            max_batch=args.max_batch,
                            window_ms=args.window_ms, context=context,
                            ngram=ngram, device="cuda")
    streaming = None
    if stream:
        streaming = StreamingEngine(
            params, cfg, slots=args.stream_slots,
            chunk_frames=args.chunk_frames, max_symbols=args.max_symbols,
            mode=args.mode, beam=args.beam, context=context, ngram=ngram,
            endpoint_frames=args.endpoint_frames, device="cuda")
    print("warming up (one decode per bucket)...", file=sys.stderr)
    engine.warmup()
    if streaming is not None:
        streaming.warmup()
    srv = http_server(args.host, args.port, engine, streaming, tok,
                      max_body_bytes=args.max_body_bytes, cmvn=cmvn,
                      frame_hop_s=args.frame_hop_s)
    print(f"serving on http://{args.host}:{srv.server_address[1]} "
          f"(mode={args.mode}, max_batch={args.max_batch}, "
          f"stream_slots={args.stream_slots if stream else 0}, "
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
        if streaming is not None:
            streaming.close()
        print("drained and closed", file=sys.stderr)


if __name__ == "__main__":
    main()
