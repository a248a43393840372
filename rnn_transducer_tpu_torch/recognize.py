"""Decoding / evaluation CLI of the PyTorch port (port of the JAX package's
recognize.py).

    python -m rnn_transducer_tpu_torch.recognize --config smoke \\
        --mode greedy --data synthetic
    python -m rnn_transducer_tpu_torch.recognize --ckpt-dir ckpt \\
        --mode beam --beam 8 --data manifest:test.jsonl

Decodes synthetic batches (`data/synthetic.learnable_batch`, from --seed)
or a JSONL manifest of features or audio (data/manifest.py: audio through
`ops/logmel.log_mel` on --device), bucketed into fixed shapes
(data/bucketing.py), with the greedy, beam, streaming or streaming-beam
decoder, or through the CTC head alone (ctc_greedy, ctc_beam:
decode/ctc.py; a checkpoint without the head is refused), and prints one
JSON line: the mode, the token WER, RtfMeter's RTF and p50 / p90 latency, the beam in beam mode and the word WER when a
tokenizer is known. Each bucket shape is decoded once before it is
timed, and the clock stops when the tokens are on the host.

--ckpt-dir reads a directory of the port's trainer: its config (an
explicit --config must match it), its tokenizer and its CMVN stats
(--tokenizer and --cmvn override them). --device defaults to cuda, and a
run asked for cuda on a machine without a card fails rather than fall
back to the CPU.

--data-parallel N (greedy, beam and the CTC modes) decodes every batch
on N ranks (parallel/mesh.py): each decodes its contiguous slice of the
batch and rank 0 gathers the hypotheses (through the host) and writes
them in single-device order. N > 1 starts N - 1 worker processes beside
this one, or joins a torchrun environment when RANK and WORLD_SIZE are
set; a batch size that N does not divide and the streaming modes are
refused, as in recognize.py.

--use-ema decodes a checkpoint's Polyak average (a run of the trainer
with --ema-decay) instead of its params.

--loader native reads a manifest with the C++ prefetch threads of
data/native_loader.py (manifest order; two threads, so the batches come
in the order the threads finish them, and one under several ranks, so
that every rank cuts the same batch; audio featurized by log_mel on
--device, CMVN applied to the padded batch).

--mode ctc_beam fuses --ngram and --length-bonus (a bonus a token) into
the prefix search. Not ported yet, refused with its ROADMAP item (queue
1): --lm-ckpt and --lm-rescore (item 18).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RNN-T decoding + eval "
                                            "(PyTorch port)")
    p.add_argument("--config", default=None,
                   help="named config; defaults to the config stored in "
                        "--ckpt-dir's meta.json, else 'smoke'")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' or 'manifest:<path.jsonl>'")
    p.add_argument("--mode", default="greedy",
                   choices=["greedy", "beam", "streaming", "streaming_beam",
                            "ctc_greedy", "ctc_beam"])
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--expansions", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--max-symbols", type=int, default=100)
    p.add_argument("--chunk-frames", type=int, default=32)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--data-parallel", type=int, default=1,
                   help="decode each batch over N ranks (greedy, beam)")
    p.add_argument("--loader", default="python",
                   choices=["python", "native"],
                   help="manifest input pipeline ('native': C++ "
                        "prefetch threads, csrc/loader.cpp)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cmvn", default=None,
                   help="global CMVN stats JSON; defaults to the stats "
                        "recorded in the checkpoint's meta.json (if any)")
    p.add_argument("--use-ema", action="store_true",
                   help="decode the checkpoint's EMA params (trained with "
                        "--ema-decay > 0)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="post-training weight quantization for decode: "
                        "symmetric per-channel int8 on every 2-D weight "
                        "(ops/quant.py)")
    p.add_argument("--frame-hop-s", type=float, default=0.01,
                   help="seconds of audio per encoder input frame (for RTF "
                        "and word times)")
    p.add_argument("--lm-ckpt", default=None,
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--lm-weight", type=float, default=0.3)
    p.add_argument("--ilm-weight", type=float, default=0.0)
    p.add_argument("--lm-rescore", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--ngram", default=None,
                   help="n-gram LM artifact (models/ngram.py) for shallow "
                        "fusion in beam / streaming_beam modes")
    p.add_argument("--ngram-weight", type=float, default=0.3)
    p.add_argument("--length-bonus", type=float, default=0.0,
                   help="ctc_beam: additive bonus per emitted token")
    p.add_argument("--boost-file", default=None,
                   help="contextual-biasing phrase list for beam / "
                        "streaming_beam modes: one phrase per line, "
                        "optional <TAB><per-token boost>; phrases are "
                        "encoded with the model tokenizer")
    p.add_argument("--boost-score", type=float, default=2.0,
                   help="default per-token boost for --boost-file phrases")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer spec (char | phone | bpe:<model.json>) "
                        "for text output + word-level WER; defaults to the "
                        "tokenizer stored in --ckpt-dir's meta.json")
    p.add_argument("--confidence", action="store_true",
                   help="per-token emission log-probs in --hyps-file "
                        "records as 'confs' (greedy, beam)")
    p.add_argument("--nbest", type=int, default=1,
                   help="with --hyps-file and a beam mode: also write the "
                        "top-N hypotheses + scores per utterance")
    p.add_argument("--hyps-file", default=None,
                   help="write per-utterance {ref, hyp} JSONL here "
                        "(text when a tokenizer is available, else ids)")
    p.add_argument("--timestamps", action="store_true",
                   help="per-token emission frames in --hyps-file records "
                        "as 'frames' (input feature frames), 'times_s' and, "
                        "with a tokenizer, 'words'")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback to cpu)")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Options of the JAX CLI the port does not run yet, each with its
    ROADMAP item (queue 1)."""
    if args.lm_ckpt or args.lm_rescore:
        raise SystemExit("--lm-ckpt / --lm-rescore are not ported yet "
                         "(ROADMAP queue 1, item 18: LM checkpoints)")


def make_decoder(args, params, cfg, device, context=None, ngram=None):
    """decode(feats, lens) on `device` -> numpy (tokens (B, U), lens (B,),
    frames (B, U) encoder frames or None, confs (B, U) or None, nbest
    (tokens (B, K, U), lens (B, K), scores (B, K)) or None)."""
    from rnn_transducer_tpu_torch.decode.beam import recognize_beam
    from rnn_transducer_tpu_torch.decode.ctc import recognize_ctc
    from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
    from rnn_transducer_tpu_torch.decode.streaming import (
        stream_transcribe, stream_transcribe_beam)

    ts, conf_on = args.timestamps, args.confidence
    ms = args.max_symbols

    def host(*arrays):
        return [None if a is None else a.cpu().numpy() for a in arrays]

    if args.mode == "greedy":
        def decode(f, l):
            out = list(recognize_greedy(params, cfg, f, l, max_symbols=ms,
                                        with_confidence=conf_on,
                                        with_timestamps=ts))
            toks, lens = out[:2]
            confs = out[2] if conf_on else None
            frames = out[-1] if ts else None
            return (*host(toks, lens, frames, confs), None)
    elif args.mode == "beam":
        def decode(f, l):
            out = list(recognize_beam(
                params, cfg, f, l, beam=args.beam, max_symbols=ms,
                expansions=args.expansions, context=context, ngram=ngram,
                with_confidence=conf_on, with_timestamps=ts))
            toks, lens, scores = host(*out[:3])
            rest = host(*out[3:])
            confs = rest.pop(0) if conf_on else None
            frames = rest.pop(0) if ts else None
            return (toks[:, 0], lens[:, 0],
                    None if frames is None else frames[:, 0],
                    None if confs is None else confs[:, 0],
                    (toks, lens, scores))
    elif args.mode == "ctc_greedy":
        def decode(f, l):
            out = host(*recognize_ctc(params, cfg, f, l, mode="greedy",
                                      max_symbols=ms,
                                      with_confidence=conf_on,
                                      with_timestamps=ts))
            return (out[0], out[1], out[-1] if ts else None,
                    out[2] if conf_on else None, None)
    elif args.mode == "ctc_beam":
        def decode(f, l):
            toks, lens, scores = host(*recognize_ctc(
                params, cfg, f, l, mode="beam", beam=args.beam,
                max_symbols=ms, ngram=ngram, length_bonus=args.length_bonus))
            return toks[:, 0], lens[:, 0], None, None, (toks, lens, scores)
    elif args.mode == "streaming_beam":
        def decode(f, l):
            out = host(*stream_transcribe_beam(
                params, cfg, f, l, args.chunk_frames, beam=args.beam,
                max_symbols=ms, expansions=args.expansions, context=context,
                ngram=ngram, with_timestamps=ts, device=device))
            frames = out[3][:, 0] if ts else None
            return (out[0][:, 0], out[1][:, 0], frames, None,
                    (out[0], out[1], out[2]))
    else:  # streaming
        def decode(f, l):
            out = host(*stream_transcribe(params, cfg, f, l,
                                          args.chunk_frames, ms,
                                          with_timestamps=ts, device=device))
            return out[0], out[1], (out[2] if ts else None), None, None
    return decode


def _gathered(parts):
    """The ranks' decode outputs joined row-wise in rank order: the
    single-device batch's."""
    def cat(xs):
        return None if xs[0] is None else np.concatenate(xs)

    nb = (None if parts[0][4] is None else
          tuple(cat([p[4][j] for p in parts]) for j in range(3)))
    return (*(cat([p[i] for p in parts]) for i in range(4)), nb)


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    if args.loader == "native" and not args.data.startswith("manifest:"):
        raise SystemExit("--loader native reads manifest data (--data "
                         "manifest:<path>)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device available "
                         "(pass --device cpu to decode on the CPU)")
    dp = args.data_parallel
    if dp <= 1:
        return _decode(None, args)
    if args.mode not in ("greedy", "beam", "ctc_greedy", "ctc_beam"):
        raise SystemExit("--data-parallel supports --mode "
                         "greedy|beam|ctc_greedy|ctc_beam (streaming "
                         "decode is a host-driven chunk loop)")
    if args.batch_size % dp:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"--data-parallel {dp}")
    from rnn_transducer_tpu_torch.parallel import mesh as meshlib
    return meshlib.launch(_decode, dp, device.type, args=(args,))


def _decode(mesh, args):
    """The decode run of one rank (of `mesh`, or the only one when mesh
    is None); rank 0's output dict, None on the other ranks."""
    from rnn_transducer_tpu_torch.data.bucketing import bucket_stream
    from rnn_transducer_tpu_torch.data.cmvn import load_cmvn
    from rnn_transducer_tpu_torch.data.synthetic import learnable_batch
    from rnn_transducer_tpu_torch.data.tokenizer import (decode_to_text,
                                                         tokenizer_from_spec)
    from rnn_transducer_tpu_torch.decode.metrics import (RtfMeter,
                                                         error_rate,
                                                         tokens_to_lists)
    from rnn_transducer_tpu_torch.decode.words import word_segments
    from rnn_transducer_tpu_torch.models.config import TrainConfig
    from rnn_transducer_tpu_torch.parallel import mesh as meshlib
    from rnn_transducer_tpu_torch.serve import load_params, model_meta

    device = mesh.device if mesh is not None else torch.device(args.device)
    lead = mesh is None or mesh.rank == 0
    # the config, tokenizer and CMVN of --ckpt-dir (a --config that differs
    # is refused) and its weights, int8 under --quantize: serve.py's
    cfg, tok, cmvn_stats = model_meta(args)
    if args.mode.startswith("ctc_") and not cfg.ctc_head:
        if args.ckpt_dir:
            raise SystemExit("--mode ctc_* needs a checkpoint trained with "
                             "a CTC head (--ctc-pretrain-steps)")
        cfg = dataclasses.replace(cfg, ctc_head=True)  # fresh weights
    if args.mode == "ctc_beam" and args.timestamps:
        raise SystemExit("--timestamps is not supported with ctc_beam "
                         "(prefix scores sum over alignments)")
    if args.length_bonus and args.mode != "ctc_beam":
        raise SystemExit("--length-bonus requires --mode ctc_beam")
    if args.mode.startswith("streaming"):
        # a BiLSTM or a full-attention conformer: the JAX package's words
        from rnn_transducer_tpu_torch.models.transducer import (
            _check_streamable)
        try:
            _check_streamable(cfg)
        except ValueError as e:
            raise SystemExit(f"--mode {args.mode}: {e}") from None
    params = load_params(args, cfg, device)
    if mesh is not None:
        params = meshlib.replicate(mesh, params)
    if args.cmvn:
        cmvn_stats = load_cmvn(args.cmvn)
    if args.tokenizer:
        tok = tokenizer_from_spec(args.tokenizer)

    context = None
    if args.boost_file:
        if args.mode not in ("beam", "streaming_beam"):
            raise SystemExit("--boost-file requires --mode "
                             "beam|streaming_beam")
        if tok is None:
            raise SystemExit("--boost-file needs a tokenizer (--tokenizer "
                             "or a checkpoint with one in meta.json)")
        from rnn_transducer_tpu_torch.decode.context import (
            build_context_bias, load_boost_phrases)
        phrases, boosts = load_boost_phrases(
            args.boost_file, tok, default_boost=args.boost_score)
        context = build_context_bias(phrases, cfg.vocab_size,
                                     blank=cfg.blank,
                                     boosts=boosts).to(device)
        if lead:
            print(f"boosting {len(phrases)} phrases from {args.boost_file} "
                  f"(default per-token boost {args.boost_score})",
                  file=sys.stderr)
    ngram = None
    if args.ngram:
        if args.mode not in ("beam", "streaming_beam", "ctc_beam"):
            raise SystemExit("--ngram requires --mode "
                             "beam|streaming_beam|ctc_beam")
        from rnn_transducer_tpu_torch.models.ngram import load_ngram
        ng_lm = load_ngram(args.ngram)
        if ng_lm.lp.shape[1] != cfg.vocab_size:
            raise SystemExit(f"n-gram vocab {ng_lm.lp.shape[1]} != model "
                             f"vocab {cfg.vocab_size}")
        ngram = (ng_lm.to(device), args.ngram_weight)
        if lead:
            print(f"n-gram fusion: {args.ngram} ({ng_lm.lp.shape[0]} "
                  f"states) weight={args.ngram_weight}", file=sys.stderr)
    if args.confidence and args.mode not in ("greedy", "beam", "ctc_greedy"):
        raise SystemExit("--confidence supports --mode "
                         "greedy|beam|ctc_greedy")
    decode = make_decoder(args, params, cfg, device, context, ngram)

    if args.data.startswith("manifest:") and args.loader == "native":
        from rnn_transducer_tpu_torch.data.native_loader import NativeLoader
        man_path = args.data.split(":", 1)[1]

        def batches():
            with NativeLoader(man_path, cfg, TrainConfig().buckets,
                              args.batch_size, loop=False, seed=None,
                              n_threads=1 if mesh is not None else 2,
                              cmvn=cmvn_stats, device=device) as ld:
                yield from ld
    elif args.data.startswith("manifest:"):
        from rnn_transducer_tpu_torch.data.manifest import manifest_examples
        man_path = args.data.split(":", 1)[1]

        def batches():
            yield from bucket_stream(
                manifest_examples(man_path, cfg, cmvn=cmvn_stats,
                                  device=device),
                TrainConfig().buckets, args.batch_size, blank=cfg.blank,
                with_valid=True)
    elif args.data == "synthetic":
        def batches():
            rng = np.random.default_rng(args.seed + 1)
            for _ in range(args.batches):
                yield learnable_batch(rng, args.batch_size, n_labels=10,
                                      input_dim=cfg.input_dim,
                                      vocab=cfg.vocab_size,
                                      frames_per_label=4) + (args.batch_size,)
    else:
        raise SystemExit(f"--data {args.data!r}: 'synthetic' or "
                         "'manifest:<path>'")

    meter = RtfMeter()
    refs, hyps, hyp_frames, hyp_confs, hyp_nbest = [], [], [], [], []
    warmed: set[tuple] = set()
    with torch.inference_mode():
        for feats, fl, labels, ll, n_valid in batches():
            if mesh is not None:  # this rank's rows of the batch
                f, l = meshlib.shard_batch(mesh, (feats, fl))
            else:
                f = torch.from_numpy(feats).to(device)
                l = torch.from_numpy(fl).to(device)
            if feats.shape not in warmed:
                # each bucket shape once outside the timed region
                warmed.add(feats.shape)
                decode(f, l)
            t0 = time.perf_counter()
            out = decode(f, l)  # on the host
            if mesh is not None:
                out = _gathered(meshlib.all_gather_objects(mesh, out))
            wall = time.perf_counter() - t0
            if not lead:
                continue
            toks, lens, frames, confs, nb = out
            # padding rows (drained partial batches repeat real
            # utterances) are left out of WER and RTF
            audio_s = float(np.sum(fl[:n_valid])) * args.frame_hop_s
            meter.add(wall, audio_s, n_utts=n_valid)
            hyps.extend(tokens_to_lists(toks[:n_valid], lens[:n_valid]))
            refs.extend(tokens_to_lists(labels[:n_valid], ll[:n_valid]))
            if frames is not None:
                hyp_frames.extend(
                    (frames[i, : lens[i]] * cfg.time_reduction).tolist()
                    for i in range(n_valid))
            if confs is not None:
                hyp_confs.extend(
                    [round(float(c), 4) for c in confs[i, : lens[i]]]
                    for i in range(n_valid))
            if args.nbest > 1 and nb is not None:
                nb_t, nb_l, nb_s = nb
                for i in range(n_valid):
                    hyp_nbest.append([
                        (nb_t[i, k, : nb_l[i, k]].tolist(),
                         float(nb_s[i, k]))
                        for k in range(min(args.nbest, nb_t.shape[1]))
                        if nb_s[i, k] > -1e29])
    if not lead:
        return None
    wer = error_rate(refs, hyps)
    out = {"mode": args.mode, "wer": round(wer, 4), **{
        k: round(v, 5) for k, v in meter.summary().items()}}
    if args.mode == "beam":
        out["beam"] = args.beam

    ref_texts = hyp_texts = None
    if tok is not None:
        ref_texts = [decode_to_text(tok, r) for r in refs]
        hyp_texts = [decode_to_text(tok, h) for h in hyps]
        words: dict[str, int] = {}

        def wids(t):
            return [words.setdefault(w, len(words)) for w in t.split()]

        out["word_wer"] = round(error_rate([wids(t) for t in ref_texts],
                                           [wids(t) for t in hyp_texts]), 4)
    if args.hyps_file:
        with open(args.hyps_file, "w") as f:
            for i in range(len(hyps)):
                rec = ({"ref": ref_texts[i], "hyp": hyp_texts[i]}
                       if tok is not None
                       else {"ref": refs[i], "hyp": hyps[i]})
                if hyp_confs:
                    rec["confs"] = hyp_confs[i]
                if args.timestamps:
                    rec["frames"] = hyp_frames[i]
                    rec["times_s"] = [round(fr * args.frame_hop_s, 3)
                                      for fr in hyp_frames[i]]
                    if tok is not None:
                        rec["words"] = word_segments(
                            tok, hyps[i], hyp_frames[i],
                            hyp_confs[i] if hyp_confs else None,
                            hop_s=args.frame_hop_s)
                if hyp_nbest:
                    rec["nbest"] = [
                        {"hyp": (decode_to_text(tok, ids)
                                 if tok is not None else ids),
                         "score": round(sc, 4)}
                        for ids, sc in hyp_nbest[i]]
                f.write(json.dumps(rec) + "\n")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
