"""Training CLI of the PyTorch port, mirroring the JAX package's train.py.

    python -m rnn_transducer_tpu_torch.train --config libri100 \\
        --data synthetic --steps 100 --batch-size 32 --ckpt-dir ckpt
    python -m rnn_transducer_tpu_torch.train --config libri100_conformer \\
        --data synthetic --steps 100 --batch-size 64 --max-frames 400
    python -m rnn_transducer_tpu_torch.train --config libri100 \\
        --pruned-range 8 --steps 100        # the pruned two-pass loss
    python -m rnn_transducer_tpu_torch.train --config libri100 \\
        --ar-range 8 [--ar-left N] [--ar-align-from CKPT_DIR]  # AR band
    python -m rnn_transducer_tpu_torch.train --config libri100 \\
        --data manifest:data/train/manifest.jsonl --batch-size 32 \\
        --sortagrad --cmvn cmvn.json --spec-augment \\
        --speed-perturb 0.9,1.0,1.1 --dropout 0.1 --ema-decay 0.999 \\
        --ckpt-dir ckpt --log-file train.jsonl   # configs[2]
    python -m rnn_transducer_tpu_torch.train --config libri100 \
        --data manifest:data/train/manifest.jsonl --loader native \
        --distill-from teacher_ckpt --mwer-steps 100 --steps 1000
    python -m rnn_transducer_tpu_torch.train --config libri100 \
        --pred-type stateless --ctc-pretrain-steps 500 --ctc-weight 0.3 \
        --steps 5000 --ckpt-dir ckpt     # CTC first, then CTC-hybrid RNN-T
    python -m rnn_transducer_tpu_torch.train --config libri100 \
        --big-blanks 2,4,8 --ckpt-dir ckpt    # multi-blank; or the TDT:
        # --tdt-durations 0,1,2,4 (both train at the xla loss tier)

Runs the standard training step (`train/loop.py`) on the `learnable_batch`
stream of train.py (features that encode their labels, drawn from
--seed), or with --data manifest:<path> on a JSONL manifest
(data/manifest.py; `python -m
rnn_transducer_tpu_torch.tools.prepare_manifest` writes one) in TrainConfig's length buckets, (400, 50),
(800, 100) and (1600, 200) frames and labels: --sortagrad makes the first
epoch shortest-first, every later one is shuffled from --seed, and the
first --batch-size examples are held out as the dev batch when the corpus
has more (or --dev-manifest's first batch is). --cmvn applies global CMVN
stats (data/cmvn.py) and records them in meta.json. --speed-perturb and
--spec-augment (--spec-augment-warp W) augment every batch from draws
keyed by the global step, before it is split over ranks; --dropout,
--embed-dropout, --weight-noise and --ema-decay are the step's
regularizers. Logs one JSON record per --log-every steps to stderr (and
--log-file), dev loss and dev PER (greedy decode) every --eval-every
steps, checkpoints every --ckpt-every steps and at the end, and prints
{"final_loss": ..., "steps": ...} as the last line of stdout. --resume
continues from the latest checkpoint in --ckpt-dir; on manifest data
the stream is fast-forwarded past the restored steps on metadata alone
(--resume-data exact, the default; fresh restarts the stream), so that a
resumed run trains on the batches and draws of an uninterrupted one,
while the synthetic stream restarts from the seed, as in train.py.
SIGTERM with --ckpt-dir finishes the step, checkpoints and exits 0; under
--data-parallel the ranks agree on the step to stop at.
--pruned-range S sets the config's pruned_range and trains the pruned two-pass loss (--simple-loss-scale
weighs its first pass); --ar-range S trains the alignment-restricted band
around the live model's Viterbi path, or around that of the checkpoint
--ar-align-from names (a port checkpoint with its meta.json).
--loader native reads the manifest with the C++ prefetch threads of
data/native_loader.py (csrc/loader.cpp, built by g++ at first use; two
threads, one under several ranks so that every rank sees the same batch
sequence): the batches of the python loader in another order, a shuffle
of --seed every epoch, CMVN applied to the padded batch, audio records
featurized by log_mel on --device. It has no SortaGrad (--sortagrad is
refused) and no fast-forward (--resume-data exact is refused; a plain
--resume restarts its stream from epoch 0). --distill-from CKPT_DIR adds
--distill-weight times the lattice KL(teacher || student) at temperature
--distill-temp (train/loop.distill_loss_fn; the teacher a port checkpoint
with the student's vocab, blank and time_reduction, run under no_grad;
the student always on the xla loss route); it excludes --ar-range.
--mwer-steps N makes the last N of --steps MWER fine-tuning steps
(train/mwer.py: the expected edit count over the live --mwer-beam
N-best, --mwer-nll-weight of NLL beside it) with the same optimizer
state. --ctc-pretrain-steps N makes the first N steps CTC steps on the
encoder's auxiliary head (train/loop.ctc_loss_fn), --ctc-weight W adds W
times that CTC loss to every RNN-T step (either switches the config's
ctc_head on); --pred-type stateless [--pred-context C] trains the
bounded-context predictor. --big-blanks D,... (each > 1) trains a
multi-blank transducer and --tdt-durations D,... a TDT one, each only
with --loss-impl auto|xla (train.py's checks); meta.json carries the
durations, so --resume, the decode CLI and serve.py --ckpt-dir rebuild
the config. The phase of a step (ctc, then rnnt, then
mwer) follows from its global step alone, so a resumed run crosses the
boundaries where an uninterrupted one would, and every log record names
it. Each step's log record carries `load_ms`, the host ms the
training thread waited for its batch, and `step_ms`, the host ms from
the batch's arrival to the logged loss (one step's at --log-every 1).
--tokenizer SPEC records the tokenizer in meta.json, as train.py does, so
`python -m rnn_transducer_tpu_torch.serve --ckpt-dir` answers with text;
one whose vocabulary exceeds the model's is refused. --device
defaults to cuda, and a
run asked for cuda on a machine without a card fails rather than fall
back to the CPU.

--data-parallel N trains on N ranks (parallel/mesh.py): each takes its
contiguous slice of every --batch-size batch, and the gradients are
averaged over the ranks every step. 0, the default as in train.py, is
every local device (the visible cards on cuda, 1 on the CPU). N > 1
starts N - 1 worker processes beside this one, or joins a torchrun
environment when RANK and WORLD_SIZE are set; ranks on cards of their
own talk over NCCL, ranks on the CPU over gloo. Rank 0 alone logs and
writes checkpoints; --resume loads on every rank. A batch size that N
does not divide, and an N above the visible cards, are refused. Every
rank reads the manifest and keeps its rows of each batch.

    python -m rnn_transducer_tpu_torch.train --config libri960 \
        --batch-size 64 --max-frames 400 --max-labels 60 --data-parallel 2

--model-parallel M (> 1) trains on a (data, model) mesh of
--data-parallel N rows of M ranks (parallel/mesh.make_mesh_2d; N defaults
to the visible cards over M, at least 1; the ranks share the cards when
there are fewer, over gloo) with --parallel-mode sp (sequence parallel:
replicated params, the lattice's frames sharded over the model ranks) or
ep (expert parallel: sp plus the MoE joint's experts sharded; the config
needs joint_experts > 0), parallel/tp.py. tp and pp are not ported
(items 16(b) and 16(c)), nor --microbatches, which is pp's. train.py's
checks hold: --mwer-steps only under sp, the duration families not
under ep, --loss-impl pruned, --distill-from and --ar-range not under ep
(and, item 16(b), not yet under sp). meta.json records {"parallel":
{"mode", "mp"}}; --resume refuses a checkpoint of another topology. Rank
0 saves the ep state in JAX's stacked TPParams layout ({"rep", "shd"},
the experts (M, E / M, ...)), which `train/checkpoint.load_plain_params`
merges, so the decode CLI and serve.py --ckpt-dir read it.

    python -m rnn_transducer_tpu_torch.train --config moe.json \
        --model-parallel 2 --parallel-mode ep --ckpt-dir ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from rnn_transducer_tpu_torch.data import augment
from rnn_transducer_tpu_torch.data.cmvn import load_cmvn
from rnn_transducer_tpu_torch.data.manifest import (manifest_batches,
                                                    manifest_dev_batch,
                                                    read_manifest)
from rnn_transducer_tpu_torch.data.native_loader import NativeLoader
from rnn_transducer_tpu_torch.data.synthetic import learnable_batch
from rnn_transducer_tpu_torch.data.tokenizer import (tokenizer_from_spec,
                                                     tokenizer_to_meta)
from rnn_transducer_tpu_torch.models.config import (NAMED_CONFIGS,
                                                    TrainConfig,
                                                    TransducerConfig)
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.parallel import tp
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.decode.metrics import (error_rate,
                                                     tokens_to_lists)
from rnn_transducer_tpu_torch.train.loop import (LOSS_IMPLS,
                                                 init_train_state,
                                                 make_eval_step,
                                                 make_train_step)
from rnn_transducer_tpu_torch.utils.logging import MetricsLogger
from rnn_transducer_tpu_torch.utils.seeds import generator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RNN-T training (PyTorch port)")
    p.add_argument("--config", default="smoke",
                   help="named config: smoke|" + "|".join(NAMED_CONFIGS)
                        + ", or a JSON file path")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' or 'manifest:<jsonl path>'")
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
    p.add_argument("--distill-from", default=None,
                   help="teacher checkpoint dir for knowledge distillation "
                        "(same vocab, blank and time_reduction): adds "
                        "--distill-weight times the lattice KL(teacher || "
                        "student) of the temperature-softened joint "
                        "posteriors to the loss")
    p.add_argument("--distill-weight", type=float, default=0.3,
                   help="weight of the KD term (with --distill-from)")
    p.add_argument("--distill-temp", type=float, default=1.0,
                   help="KD softmax temperature tau (the term is scaled by "
                        "tau^2)")
    p.add_argument("--mwer-steps", type=int, default=0,
                   help="MWER fine-tuning (expected edit count over the "
                        "live N-best, train/mwer.py) for the LAST N steps")
    p.add_argument("--mwer-beam", type=int, default=4)
    p.add_argument("--mwer-nll-weight", type=float, default=0.0,
                   help="interpolate this much NLL into the MWER objective")
    p.add_argument("--ctc-pretrain-steps", type=int, default=0,
                   help="warm up the encoder with CTC loss for N steps "
                        "before switching to the RNN-T loss")
    p.add_argument("--ctc-weight", type=float, default=0.0,
                   help="joint CTC + RNN-T multitask: add this much CTC "
                        "(auxiliary encoder head) to the RNN-T loss every "
                        "step (typical 0.1-0.3)")
    p.add_argument("--pred-type", default=None, choices=["lstm", "stateless"],
                   help="prediction network type override: 'stateless' = "
                        "k2-style bounded-context decoder (see "
                        "--pred-context)")
    p.add_argument("--pred-context", type=int, default=0,
                   help="stateless decoder context size (labels of history "
                        "per position; 0 = config default)")
    p.add_argument("--tdt-durations", default=None,
                   help="token-and-duration transducer: comma-separated "
                        "duration set (e.g. '0,1,2,3,4') predicted by a "
                        "second joint head; greedy decode advances by the "
                        "predicted duration after every emission (trains "
                        "at the xla loss tier)")
    p.add_argument("--big-blanks", default=None,
                   help="multi-blank transducer: comma-separated big-blank "
                        "frame durations (e.g. '2,4,8') appended as extra "
                        "joint output classes; greedy decode skips that "
                        "many frames when one wins (trains at the xla "
                        "loss tier)")
    p.add_argument("--fastemit-lambda", type=float, default=0.0)
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer spec (char | phone | bpe:<model.json>); "
                        "stored inline in the checkpoint's meta.json so the "
                        "server and the decode CLI can emit text")
    p.add_argument("--spec-augment", action="store_true",
                   help="SpecAugment time / frequency masks on the features")
    p.add_argument("--spec-augment-warp", type=int, default=0,
                   help="with --spec-augment: time-warp each utterance too "
                        "(Park et al.'s W, e.g. 80; 0 = masks only)")
    p.add_argument("--speed-perturb", default=None,
                   help="feature-domain speed perturbation, a factor a row "
                        "from this comma-separated set (e.g. "
                        "'0.9,1.0,1.1'); before SpecAugment")
    p.add_argument("--cmvn", default=None,
                   help="global CMVN stats JSON (data/cmvn.py): normalize "
                        "the features with the corpus mean / std; recorded "
                        "in meta.json for the decode CLI and the server")
    p.add_argument("--sortagrad", action="store_true",
                   help="first epoch shortest-first (manifest data, the "
                        "python loader)")
    p.add_argument("--loader", default="python",
                   choices=["python", "native"],
                   help="manifest input pipeline: 'python' reads each "
                        "batch on the training thread, 'native' prefetches "
                        "with C++ threads (csrc/loader.cpp)")
    p.add_argument("--dev-manifest", default=None,
                   help="JSONL manifest whose first batch is the dev batch; "
                        "with manifest training data and none, the first "
                        "batch of examples is held out instead")
    p.add_argument("--eval-every", type=int, default=100,
                   help="dev loss and dev PER every N steps (0 = never)")
    p.add_argument("--log-file", default=None,
                   help="append the JSONL metrics records here (mirrored "
                        "to stderr)")
    p.add_argument("--resume-data", choices=["exact", "fresh"], default=None,
                   help="with --resume and manifest data: 'exact' (the "
                        "default) fast-forwards the batch stream past the "
                        "restored steps on metadata alone; 'fresh' restarts "
                        "it from epoch 0. Synthetic data restarts always")
    p.add_argument("--weight-noise", type=float, default=0.0,
                   help="Graves weight noise std (gradients at params + "
                        "N(0, std))")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout between the LSTM layers (encoder and "
                        "predictor)")
    p.add_argument("--embed-dropout", type=float, default=0.0,
                   help="dropout on the predictor's label embeddings")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep a Polyak average of the params (e.g. 0.999); "
                        "decode it with --use-ema")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback to cpu)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="mesh size; 0 = all local devices")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model-axis size of a 2-D (data, model) mesh; "
                        "> 1 enables --parallel-mode")
    p.add_argument("--parallel-mode", default="tp", choices=list(tp.MODES),
                   help="model-axis strategy: sequence parallel (sp: the "
                        "lattice's frames sharded) or expert parallel (ep: "
                        "sp plus the MoE joint's experts sharded; needs "
                        "joint_experts > 0); tp and pp are not ported")
    p.add_argument("--microbatches", type=int, default=0,
                   help="pp only: microbatches per step (not ported)")
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


def _manifest_path(args) -> str | None:
    return (args.data.split(":", 1)[1] if args.data.startswith("manifest:")
            else None)


def _setup(args):
    """(cfg, tcfg, tokenizer meta or None) from the arguments; refuses
    what the run cannot do before any rank starts."""
    if args.data != "synthetic" and _manifest_path(args) is None:
        raise SystemExit(f"--data {args.data!r}: 'synthetic' or "
                         "'manifest:<path>'")
    if args.cmvn and not (_manifest_path(args) or args.dev_manifest):
        raise SystemExit("--cmvn requires manifest data (synthetic "
                         "features are already standardized draws)")
    if args.resume_data == "exact" and _manifest_path(args) is None:
        raise SystemExit("--resume-data exact requires manifest data "
                         "(synthetic batches are i.i.d. draws; the stream "
                         "restarts deterministically from the seed)")
    if args.loader == "native":
        if _manifest_path(args) is None:
            raise SystemExit("--loader native reads manifest data "
                             "(--data manifest:<path>)")
        if args.sortagrad:
            raise SystemExit("--sortagrad is not supported with --loader "
                             "native (its C++ pipeline shuffles every epoch "
                             "and has no shortest-first epoch); use the "
                             "python loader")
    if args.distill_from and args.ar_range > 0:
        raise SystemExit("--distill-from and --ar-range are mutually "
                         "exclusive (one teacher slot)")
    cfg = get_model_config(args.config)
    if (args.ctc_pretrain_steps > 0 or args.ctc_weight > 0) \
            and not cfg.ctc_head:
        cfg = dataclasses.replace(cfg, ctc_head=True)
    if args.pred_type:
        cfg = dataclasses.replace(cfg, pred_type=args.pred_type)
    if args.pred_context > 0:
        cfg = dataclasses.replace(cfg, pred_context=args.pred_context)
    if args.big_blanks:  # train.py's checks (:230-241)
        durs = tuple(int(d) for d in args.big_blanks.split(","))
        if any(d <= 1 for d in durs):
            raise SystemExit("--big-blanks durations must be > 1")
        cfg = dataclasses.replace(cfg, big_blank_durations=durs)
        if args.loss_impl not in ("auto", "xla"):
            raise SystemExit("--big-blanks requires --loss-impl auto|xla")
    if args.tdt_durations:
        durs = tuple(int(d) for d in args.tdt_durations.split(","))
        cfg = dataclasses.replace(cfg, tdt_durations=durs)
        if args.loss_impl not in ("auto", "xla"):
            raise SystemExit("--tdt-durations requires --loss-impl "
                             "auto|xla")
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
                       ctc_weight=args.ctc_weight,
                       simple_loss_scale=args.simple_loss_scale,
                       ar_range=args.ar_range, ar_left=args.ar_left,
                       mwer_beam=args.mwer_beam,
                       mwer_nll_weight=args.mwer_nll_weight,
                       distill_weight=(args.distill_weight
                                       if args.distill_from else 0.0),
                       distill_temp=args.distill_temp,
                       data_parallel=args.data_parallel,
                       weight_noise_std=args.weight_noise,
                       dropout=args.dropout,
                       embed_dropout=args.embed_dropout,
                       ema_decay=args.ema_decay)
    tok_meta = None
    if args.tokenizer:
        tok = tokenizer_from_spec(args.tokenizer)
        if tok.vocab_size > cfg.vocab_size:
            raise SystemExit(
                f"--tokenizer {args.tokenizer} needs vocab {tok.vocab_size} "
                f"> model vocab_size {cfg.vocab_size}")
        tok_meta = tokenizer_to_meta(tok)
    if args.ar_align_from and args.ar_range <= 0:
        raise SystemExit("--ar-align-from needs --ar-range N")
    _check_parallel(args, cfg)
    return cfg, tcfg, tok_meta


def _par_mode(args) -> str | None:
    """The model-parallel mode, None without --model-parallel > 1."""
    return args.parallel_mode if args.model_parallel > 1 else None


def _check_parallel(args, cfg: TransducerConfig) -> None:
    """train.py's model-parallel checks (:275-350) as they apply to sp and
    ep, in its words; tp and pp refused, naming their items."""
    mode = _par_mode(args)
    if mode is not None:
        try:
            tp.check_mode(mode)
        except NotImplementedError as e:
            raise SystemExit(str(e)) from None
    if args.microbatches:  # pp's, and pp is refused above
        raise SystemExit("--microbatches applies to --parallel-mode pp only")
    if mode is None:
        return
    if args.distill_from:
        if mode == "ep":
            raise SystemExit("--distill-from supports single-device, "
                             "data-parallel, and --parallel-mode sp|tp "
                             "training (not pp/ep)")
        raise SystemExit("--distill-from with --parallel-mode sp is not "
                         "ported yet (ROADMAP queue 1, item 16(b))")
    if args.ar_range > 0:
        if mode == "ep":
            raise SystemExit("--ar-range supports single-device, "
                             "data-parallel, and --parallel-mode sp|tp "
                             "training (not pp/ep) — parallel/tp.py "
                             "sp/tp_ar_loss_fn")
        raise SystemExit("--ar-range with --parallel-mode sp is not ported "
                         "yet (ROADMAP queue 1, item 16(b))")
    if args.mwer_steps > 0 and mode != "sp":
        raise SystemExit("--mwer-steps with --model-parallel requires "
                         "--parallel-mode sp (or data parallelism)")
    if (cfg.big_blank_durations or cfg.tdt_durations) and mode == "ep":
        raise SystemExit("--big-blanks/--tdt-durations with "
                         "--model-parallel require --parallel-mode sp, tp, "
                         "or pp (or data parallelism)")
    if args.loss_impl == "pruned":
        if mode == "ep":
            raise SystemExit("--loss-impl pruned with --model-parallel "
                             "requires --parallel-mode sp, tp, or pp (or "
                             "data parallelism)")
        raise SystemExit("--loss-impl pruned with --parallel-mode sp is not "
                         "ported yet (ROADMAP queue 1, item 16(b))")
    if mode == "ep":
        if cfg.joint_experts <= 0:
            raise SystemExit("--parallel-mode ep needs an MoE joint "
                             "(joint_experts > 0 in --config)")
        if cfg.joint_experts % args.model_parallel:
            raise SystemExit(f"experts {cfg.joint_experts} not divisible by "
                             f"--model-parallel {args.model_parallel}")


def _check_topology(args) -> None:
    """--resume into a checkpoint of another (mode, mp) is refused, as
    train.py refuses it."""
    if not (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        return
    saved = (ckpt.load_meta(args.ckpt_dir) or {}).get("parallel") or {}
    mode = _par_mode(args)
    want = (mode, args.model_parallel if mode else None)
    if (saved.get("mode"), saved.get("mp")) != want:
        raise SystemExit(
            f"checkpoint topology {saved} does not match --parallel-mode "
            f"{mode} --model-parallel {args.model_parallel}")


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device available "
                         "(pass --device cpu to train on the CPU)")
    mp = args.model_parallel
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n = args.data_parallel or (max(1, cards // mp) if mp > 1 else cards)
    if n > 1 and args.batch_size % n:
        raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                         f"--data-parallel {n}")
    args.data_parallel = n
    _setup(args)  # refuse here, before any rank starts
    _check_topology(args)
    if _par_mode(args) is not None:
        return meshlib.launch(_train, n * mp, device.type, args=(args,),
                              n_model=mp)
    if n == 1:
        return _train(None, args)
    return meshlib.launch(_train, n, device.type, args=(args,))


def _train(mesh, args):
    """The training run of one rank (of `mesh`, or the only one when
    mesh is None); rank 0's final TrainState."""
    cfg, tcfg, tok_meta = _setup(args)
    device = mesh.device if mesh is not None else torch.device(args.device)
    lead = mesh is None or mesh.rank == 0

    def log(msg):
        if lead:
            print(msg, file=sys.stderr, flush=True)

    teacher_params = teacher_cfg = None
    teacher_dir = args.distill_from or args.ar_align_from
    if teacher_dir:
        flag = "--distill-from" if args.distill_from else "--ar-align-from"
        teacher_cfg = ckpt.load_model_config(teacher_dir)
        if teacher_cfg is None:
            raise SystemExit(f"{flag}: {teacher_dir} has no meta.json with "
                             "its model config")
        teacher, t_step = ckpt.restore_checkpoint(teacher_dir, device=device)
        teacher_params = teacher.params
        log(f"distilling from {teacher_dir} (step {t_step}, weight "
            f"{args.distill_weight}, tau {args.distill_temp})"
            if args.distill_from else
            f"ar band from {teacher_dir} (step {t_step}, range "
            f"{args.ar_range}, left {args.ar_left})")

    mode = _par_mode(args)
    if mode == "ep":
        state = tp.init_ep_train_state(np.random.default_rng(args.seed), cfg,
                                       tcfg, mesh.n_model, mesh.model_rank,
                                       device)
    elif mode == "sp":
        state = tp.init_sp_train_state(np.random.default_rng(args.seed), cfg,
                                       tcfg, device)
    else:
        state = init_train_state(np.random.default_rng(args.seed), cfg, tcfg,
                                 device)
    start_step = 0
    resuming = (args.resume and args.ckpt_dir
                and ckpt.latest_step(args.ckpt_dir) is not None)
    if resuming:
        meta = ckpt.load_meta(args.ckpt_dir) or {}
        saved = meta.get("model_config")
        if saved is not None and saved != json.loads(json.dumps(
                dataclasses.asdict(cfg))):
            raise SystemExit(f"--resume: {args.ckpt_dir} holds a checkpoint "
                             "of another model config")
        restored, start_step = ckpt.restore_checkpoint(args.ckpt_dir,
                                                       device=device)
        if mode == "ep":
            restored = tp.ep_state_from_checkpoint(restored, mesh.model_rank)
        ema = restored.ema if tcfg.ema_decay > 0 else None
        if tcfg.ema_decay > 0 and ema is None:  # a run without one: start
            ema = torch.utils._pytree.tree_map(torch.clone, restored.params)
        state = dataclasses.replace(restored, ema=ema)
        log(f"resumed from step {start_step}")
    if mesh is not None and mode is None:
        state = dataclasses.replace(
            state, params=meshlib.replicate(mesh, state.params),
            opt_state=meshlib.replicate(mesh, state.opt_state),
            ema=(None if state.ema is None
                 else meshlib.replicate(mesh, state.ema)))
        if teacher_params is not None:
            teacher_params = meshlib.replicate(mesh, teacher_params)
    if mode is None:
        def build_step(kind, **kw):
            return make_train_step(cfg, tcfg, mesh=mesh, device=device,
                                   loss_kind=kind, **kw)
    else:
        def build_step(kind, **kw):
            return tp.make_tp_train_step(cfg, tcfg, mesh, mode,
                                         loss_kind=kind)
    step_fn = build_step("rnnt", teacher_cfg=teacher_cfg)
    extra = () if teacher_params is None else (teacher_params,)
    # CTC pretraining: the first --ctc-pretrain-steps steps, and MWER
    # fine-tuning: the last --mwer-steps; one optimizer state throughout
    ctc_step_fn = (build_step("ctc") if args.ctc_pretrain_steps > 0
                   else None)
    mwer_step_fn = build_step("mwer") if args.mwer_steps > 0 else None
    meta_extra = {"train_config": dataclasses.asdict(tcfg)}
    if mode is not None:
        meta_extra["parallel"] = {"mode": mode, "mp": args.model_parallel}
    if tok_meta is not None:
        meta_extra["tokenizer"] = tok_meta
    cmvn = load_cmvn(args.cmvn) if args.cmvn else None
    if cmvn is not None:  # the decode CLI and the server apply the same
        meta_extra["cmvn"] = {"mean": cmvn["mean"], "std": cmvn["std"]}
    batches, dev_batch = _data(args, cfg, tcfg, cmvn, device, log,
                               resume_skip=start_step if resuming else 0)
    run_eval = _evaluator(args, cfg, tcfg, dev_batch, device)
    mlog = MetricsLogger(args.log_file if lead else None, mirror=lead)

    def save(step_no, st):
        if mode == "ep":  # every rank gathers the experts; rank 0 saves
            st = tp.ep_checkpoint_state(mesh, st)
        if lead:
            ckpt.save_checkpoint(args.ckpt_dir, step_no, st, model_cfg=cfg,
                                 **meta_extra)

    # preemption: SIGTERM finishes the step, checkpoints, and exits 0
    stop = {"flag": False}
    previous = None
    if args.ckpt_dir:
        def _on_term(signum, frame):
            stop["flag"] = True
        try:
            previous = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread (embedded use)

    t_start = time.perf_counter()
    utts = 0
    step_no = start_step
    info = {"loss": float("nan"), "grad_norm": float("nan")}
    t_prev = time.perf_counter()
    try:
        for i, batch in enumerate(batches):
            if i >= args.steps - start_step:
                break
            t_got = time.perf_counter()
            feats, fl, labels, ll = train_batch(args, batch, start_step + i,
                                                 mesh, device)
            phase = _phase(args, start_step + i)
            if phase == "ctc":
                state, info = ctc_step_fn(state, feats, fl, labels, ll)
            elif phase == "mwer":
                state, info = mwer_step_fn(state, feats, fl, labels, ll)
            else:
                state, info = step_fn(state, feats, fl, labels, ll, *extra)
            utts += tcfg.batch_size
            step_no = start_step + i + 1
            if step_no % args.log_every == 0:
                loss = float(info["loss"])  # waits for the step
                now = time.perf_counter()
                mlog.log(step=step_no, phase=phase,
                         loss=round(loss, 4),
                         grad_norm=round(float(info["grad_norm"]), 4),
                         utt_per_sec=round(utts / (now - t_start), 2),
                         frames=int(feats.shape[1]),
                         skipped_nonfinite=int(info["skipped_nonfinite"]),
                         load_ms=round((t_got - t_prev) * 1e3, 3),
                         step_ms=round((now - t_got) * 1e3, 3))
            if args.eval_every and step_no % args.eval_every == 0:
                plain = tp.plain_params(mesh, state.params, mode, cfg)
                if lead:
                    dev_loss, per = run_eval(plain)
                    mlog.log(step=step_no, dev_loss=round(dev_loss, 4),
                             dev_per=round(per, 4))
            if args.ckpt_dir and step_no % args.ckpt_every == 0:
                save(step_no, state)
            if args.ckpt_dir and _agreed(mesh, stop["flag"]):
                rank = 0 if mesh is None else mesh.rank
                print(f"SIGTERM: rank {rank} stops after step {step_no}",
                      file=sys.stderr, flush=True)
                break
            t_prev = time.perf_counter()
    finally:
        batches.close()  # the native loader's threads are joined here
        mlog.close()
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    if args.ckpt_dir:
        save(step_no, state)
        log(f"saved final checkpoint at step {step_no} to {args.ckpt_dir}")
    if lead:
        print(json.dumps({"final_loss": round(float(info["loss"]), 4),
                          "steps": step_no}), flush=True)
    return state


def _phase(args, step: int) -> str:
    """The objective of the step after `step` steps (train.py's order):
    ctc for the first --ctc-pretrain-steps, mwer for the last
    --mwer-steps outside those, rnnt between."""
    if step < args.ctc_pretrain_steps:
        return "ctc"
    if args.mwer_steps > 0 and step >= args.steps - args.mwer_steps:
        return "mwer"
    return "rnnt"


def _agreed(mesh, flag: bool) -> bool:
    """Whether any rank was asked to stop: one all-reduce (MAX) of the
    flag a step, so that every rank stops after the same step."""
    if mesh is None or mesh.size == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def _data(args, cfg, tcfg, cmvn, device, log, resume_skip: int):
    """(the stream of numpy training batches, the dev batch (feats,
    feat_lens, labels, label_lens, n_valid)), as train.py builds them."""
    path = _manifest_path(args)
    dev_batch = None
    if args.dev_manifest:
        dev_batch = manifest_dev_batch(args.dev_manifest, cfg, tcfg,
                                       cmvn=cmvn, device=device)
    if path is not None:
        skip_first = 0
        if not args.dev_manifest:
            # hold the first batch_size examples out of every epoch as the
            # dev batch, when the corpus has more than that; else the dev
            # batch overlaps the training data
            dev_batch = manifest_dev_batch(path, cfg, tcfg, cmvn=cmvn,
                                           device=device)
            n_utts = sum(1 for _ in read_manifest(path))
            skip_first = (tcfg.batch_size if dev_batch is not None
                          and n_utts > tcfg.batch_size else 0)
        skip = resume_skip if args.resume_data != "fresh" else 0
        if args.loader == "native":
            if skip and args.resume_data == "exact":
                raise SystemExit("--resume-data exact is not supported with "
                                 "--loader native; use the python loader "
                                 "or --resume-data fresh")
            if skip:
                log("note: native loader resumes the data stream from epoch "
                    "0 (no exact fast-forward); the model/optimizer state "
                    "is unaffected")
            batches = _native_batches(path, cfg, tcfg, skip_first, args.seed,
                                      cmvn, device, n_threads=(
                                          1 if args.data_parallel
                                          * args.model_parallel > 1
                                          else 2))
        else:
            if skip:
                log(f"fast-forwarding the data stream past {skip} batches "
                    "(--resume-data exact)")
            batches = manifest_batches(path, cfg, tcfg,
                                       skip_first=skip_first,
                                       sortagrad=args.sortagrad,
                                       shuffle_seed=args.seed,
                                       resume_batches=skip, cmvn=cmvn,
                                       device=device)
    else:
        batches = synthetic_batches(args, cfg, tcfg.batch_size)
    if dev_batch is None:
        n = min(tcfg.batch_size, 8)
        dev_batch = learnable_batch(
            np.random.default_rng(args.seed + 12345), n,
            n_labels=min(args.max_labels, 20), input_dim=cfg.input_dim,
            vocab=cfg.vocab_size, frames_per_label=4) + (n,)
    return batches, dev_batch


def _native_batches(path, cfg, tcfg, skip_first: int, seed: int, cmvn,
                    device, n_threads: int):
    """The C++ prefetch loader's endless stream (loop mode, a shuffle of
    `seed` every epoch) as (feats, feat_lens, labels, label_lens), CMVN
    applied to each padded batch after the pipeline; the threads are
    joined when the stream is closed."""
    with NativeLoader(path, cfg, tcfg.buckets, tcfg.batch_size, loop=True,
                      seed=seed, n_threads=n_threads, skip_first=skip_first,
                      cmvn=cmvn, device=device) as loader:
        for b in loader:
            yield b[:4]


def train_batch(args, batch, global_step: int, mesh, device):
    """A numpy batch as this rank's tensors: speed-perturbed and
    SpecAugmented (draws keyed by the global step, on the whole batch)
    when asked, then this rank's rows."""
    aug = args.speed_perturb or args.spec_augment
    shard = (meshlib.shard_batch_2d if isinstance(mesh, meshlib.Mesh2D)
             else meshlib.shard_batch)
    if not aug:
        if mesh is not None:
            return shard(mesh, batch)
        return tuple(torch.from_numpy(x).to(device) for x in batch)
    feats, fl, labels, ll = (torch.from_numpy(x).to(device) for x in batch)
    if args.speed_perturb:
        factors = tuple(float(x) for x in args.speed_perturb.split(","))
        feats, fl = augment.speed_perturb(
            generator(args.seed + 778, global_step), feats, fl, factors)
    if args.spec_augment:
        feats = augment.spec_augment(
            generator(args.seed + 777, global_step), feats, fl,
            time_warp_frames=args.spec_augment_warp)
    batch = (feats, fl, labels, ll)
    return batch if mesh is None else shard(mesh, batch)


def _evaluator(args, cfg, tcfg, dev_batch, device):
    """run_eval(params) -> (dev loss, dev PER by greedy decode) on the real
    rows of the dev batch, as train.py's run_eval."""
    eval_fn = make_eval_step(cfg)
    f, flen, lab, lablen = (torch.from_numpy(np.asarray(x)).to(device)
                            for x in dev_batch[:4])
    nv = int(dev_batch[4])

    def run_eval(params):
        _, per_utt = eval_fn(params, f, flen, lab, lablen)
        with torch.no_grad():
            toks, lens = recognize_greedy(
                params, cfg, f, flen, max_symbols=max(args.max_labels * 2, 8))
        per = error_rate(
            tokens_to_lists(*(x[:nv].cpu().numpy() for x in (lab, lablen))),
            tokens_to_lists(*(x[:nv].cpu().numpy() for x in (toks, lens))))
        return float(per_utt[:nv].mean()), per
    return run_eval


if __name__ == "__main__":
    main()
