"""Training CLI of the PyTorch port, mirroring the JAX package's train.py.

    python -m rnn_transducer_tpu_torch.train --config libri100 \\
        --data synthetic --steps 100 --batch-size 32 --ckpt-dir ckpt
    python -m rnn_transducer_tpu_torch.train --config libri100_conformer \\
        --data synthetic --steps 100 --batch-size 64 --max-frames 400
    python -m rnn_transducer_tpu_torch.train --config libri100 \\
        --pruned-range 8 --steps 100        # the pruned two-pass loss
    python -m rnn_transducer_tpu_torch.train --config libri100 \\
        --ar-range 8 [--ar-left N] [--ar-align-from CKPT_DIR]  # AR band

Runs the standard training step (`train/loop.py`) on the `learnable_batch`
stream of train.py (features that encode their labels, drawn from
--seed), logs one JSON line per --log-every steps to stderr, checkpoints
every --ckpt-every steps and at the end, and prints
{"final_loss": ..., "steps": ...} as the last line of stdout. --resume
continues from the latest checkpoint in --ckpt-dir; the synthetic stream
restarts from the seed, as in train.py. --pruned-range S sets the config's
pruned_range and trains the pruned two-pass loss (--simple-loss-scale
weighs its first pass); --ar-range S trains the alignment-restricted band
around the live model's Viterbi path, or around that of the checkpoint
--ar-align-from names (a port checkpoint with its meta.json). --device
defaults to cuda, and a
run asked for cuda on a machine without a card fails rather than fall
back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from rnn_transducer_tpu_torch.data.synthetic import learnable_batch
from rnn_transducer_tpu_torch.models.config import (NAMED_CONFIGS,
                                                    TrainConfig,
                                                    TransducerConfig)
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train.loop import (LOSS_IMPLS,
                                                 init_train_state,
                                                 make_train_step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RNN-T training (PyTorch port)")
    p.add_argument("--config", default="smoke",
                   help="named config: smoke|" + "|".join(NAMED_CONFIGS)
                        + ", or a JSON file path")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' (manifest data is not ported yet)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-schedule", default="warmup_cosine",
                   choices=["warmup_cosine", "noam", "step_decay",
                            "constant"])
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--grad-clip", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=200)
    p.add_argument("--max-labels", type=int, default=20)
    p.add_argument("--loss-impl", default="auto", choices=LOSS_IMPLS,
                   help="auto: fused on cuda where the joint width allows, "
                        "else pallas (two passes over materialised "
                        "logits); xla on cpu; pruned needs --pruned-range")
    p.add_argument("--pruned-range", type=int, default=0,
                   help="band width S of the pruned two-pass loss; implies "
                        "--loss-impl pruned when > 0")
    p.add_argument("--simple-loss-scale", type=float, default=0.5,
                   help="weight of the simple first pass in the pruned "
                        "objective")
    p.add_argument("--ar-range", type=int, default=0,
                   help="alignment-restricted RNN-T: train on an N-wide "
                        "band around a Viterbi alignment (0 = off)")
    p.add_argument("--ar-left", type=int, default=-1,
                   help="band positions behind the aligned path; -1 = "
                        "centred")
    p.add_argument("--ar-align-from", default=None,
                   help="checkpoint dir of the aligner for --ar-range (same "
                        "vocab, blank and time_reduction); omit to "
                        "self-align")
    p.add_argument("--fastemit-lambda", type=float, default=0.0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback to cpu)")
    return p.parse_args(argv)


def get_model_config(name: str) -> TransducerConfig:
    """A named config, train.py's "smoke", or a JSON file of fields."""
    if name == "smoke":
        return TransducerConfig(enc_layers=1, enc_hidden=64, pred_layers=1,
                                pred_hidden=64, embed_dim=32, joint_dim=64,
                                vocab_size=32, input_dim=80)
    if name in NAMED_CONFIGS:
        return NAMED_CONFIGS[name]()
    with open(name) as f:
        return TransducerConfig(**json.load(f))


def synthetic_batches(args, cfg: TransducerConfig, batch_size: int):
    """train.py's synthetic stream: learnable batches from --seed."""
    rng = np.random.default_rng(args.seed)
    n_labels = min(args.max_labels, 20)
    while True:
        yield learnable_batch(rng, batch_size, n_labels=n_labels,
                              input_dim=cfg.input_dim, vocab=cfg.vocab_size,
                              frames_per_label=max(
                                  2, args.max_frames // n_labels // 2))


def main(argv=None):
    args = parse_args(argv)
    if args.data != "synthetic":
        raise NotImplementedError(
            f"--data {args.data!r} is not ported yet (ROADMAP queue 1, item "
            "13: training data)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device available "
                         "(pass --device cpu to train on the CPU)")
    cfg = get_model_config(args.config)
    if args.pruned_range > 0:
        cfg = dataclasses.replace(cfg, pruned_range=args.pruned_range)
        args.loss_impl = "pruned"
    elif args.loss_impl == "pruned" and cfg.pruned_range <= 0:
        raise SystemExit("--loss-impl pruned requires --pruned-range N")
    tcfg = TrainConfig(batch_size=args.batch_size, learning_rate=args.lr,
                       warmup_steps=args.warmup_steps,
                       total_steps=max(args.steps, args.warmup_steps + 1),
                       grad_clip_norm=args.grad_clip, seed=args.seed,
                       loss_impl=args.loss_impl, lr_schedule=args.lr_schedule,
                       fastemit_lambda=args.fastemit_lambda,
                       simple_loss_scale=args.simple_loss_scale,
                       ar_range=args.ar_range, ar_left=args.ar_left)
    teacher_params = teacher_cfg = None
    if args.ar_align_from:
        if args.ar_range <= 0:
            raise SystemExit("--ar-align-from needs --ar-range N")
        teacher_cfg = ckpt.load_model_config(args.ar_align_from)
        if teacher_cfg is None:
            raise SystemExit(f"--ar-align-from: {args.ar_align_from} has no "
                             "meta.json with its model config")
        aligner, a_step = ckpt.restore_checkpoint(args.ar_align_from,
                                                  device=device)
        teacher_params = aligner.params
        print(f"ar band from {args.ar_align_from} (step {a_step}, range "
              f"{args.ar_range}, left {args.ar_left})", file=sys.stderr)

    state = init_train_state(np.random.default_rng(args.seed), cfg, tcfg,
                             device)
    start_step = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) \
            is not None:
        meta = ckpt.load_meta(args.ckpt_dir) or {}
        saved = meta.get("model_config")
        if saved is not None and saved != json.loads(json.dumps(
                dataclasses.asdict(cfg))):
            raise SystemExit(f"--resume: {args.ckpt_dir} holds a checkpoint "
                             "of another model config")
        state, start_step = ckpt.restore_checkpoint(args.ckpt_dir,
                                                    device=device)
        print(f"resumed from step {start_step}", file=sys.stderr)
    step_fn = make_train_step(cfg, tcfg, teacher_cfg=teacher_cfg)
    extra = () if teacher_params is None else (teacher_params,)

    def save(step_no, st):
        ckpt.save_checkpoint(args.ckpt_dir, step_no, st, model_cfg=cfg,
                             train_config=dataclasses.asdict(tcfg))

    t_start = time.perf_counter()
    utts = 0
    step_no = start_step
    info = {"loss": float("nan"), "grad_norm": float("nan")}
    batches = synthetic_batches(args, cfg, tcfg.batch_size)
    for i, batch in enumerate(batches):
        if i >= args.steps - start_step:
            break
        feats, fl, labels, ll = (torch.from_numpy(x).to(device)
                                 for x in batch)
        state, info = step_fn(state, feats, fl, labels, ll, *extra)
        utts += feats.shape[0]
        step_no = start_step + i + 1
        if step_no % args.log_every == 0:
            dt = time.perf_counter() - t_start
            print(json.dumps({"step": step_no,
                              "loss": round(float(info["loss"]), 4),
                              "grad_norm": round(float(info["grad_norm"]), 4),
                              "utt_per_sec": round(utts / dt, 2)}),
                  file=sys.stderr, flush=True)
        if args.ckpt_dir and step_no % args.ckpt_every == 0:
            save(step_no, state)
    if args.ckpt_dir:
        save(step_no, state)
        print(f"saved final checkpoint at step {step_no} to {args.ckpt_dir}",
              file=sys.stderr)
    print(json.dumps({"final_loss": round(float(info["loss"]), 4),
                      "steps": step_no}))
    return state


if __name__ == "__main__":
    main()
