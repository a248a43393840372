#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rnn_transducer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--requests 24] [--profile-dir DIR] [--only moe]

Drives the port's main paths at the full width and depth of the libri100
config (4x512 LSTM encoder, 1x512 predictor, joint 512, vocab 1024, bf16)
and of libri100_conformer (8 conformer blocks of d=512, 8 heads, FFN x4,
conv kernel 15, 4x input stacking, the same predictor and joint) with
random weights from --seed, through the entry points a user calls:
serving (BatchingEngine behind http_server, with serve.py's CLI
defaults, and serve.py's CLI itself for the conformer and for beam
search) and training
(init_train_state + make_train_step at bench.py's headline shape, B=32,
T=400, U=40, through the default fused loss, and at U=80 through the
two-pass loss, loss_impl="pallas"; the conformer at bench.py's B=64,
T=400, U=40; the pruned two-pass loss at libri100 with a vocabulary of
8192, U=100, and the alignment-restricted band at U=40; and the training
CLI); int8 serving (serve.py --quantize int8), the greedy decode in one
program (recognize_greedy_fused), beam serving with prefix merging and
its shallow fusion (BatchingEngine(mode="beam")) and streaming sessions
(StreamingEngine behind the /session routes), and raw audio in, text
out (`ops/logmel.log_mel` on the card, PCM sessions, checkpoints of the
port's trainer served by serve.py --ckpt-dir and decoded by
`python -m rnn_transducer_tpu_torch.recognize`). BASELINE.json's
configs[1] (TIMIT: 3x320 BiLSTM encoder, 1x320 predictor, joint 320,
V=63) and configs[4] (libri960: 6x1024 LSTM, 2x stacking, 2x1024
predictor, joint 1024, V=32; trained, served, streamed, and trained on
two data-parallel ranks) run at full width in phase 5f, and configs[2]
(libri100 on manifest data in its three buckets, with SortaGrad, CMVN,
SpecAugment, speed perturbation, dropout, weight noise and EMA) in 5g;
5h adds the C++ prefetch loader, lattice distillation from a BiLSTM
teacher and MWER fine-tuning on that corpus; 5i CTC (pretraining,
multitask, greedy and prefix-beam decode), the stateless predictor
(trained, served, decoded from its checkpoint) and encoder remat; 5j
the duration families (multi-blank and TDT: trained, served, decoded);
5k the MoE joint (libri100 with 8 experts) in one process and on two
model ranks in the sp and ep modes, served and decoded.
Phases, in order:

  1. card   require CUDA; print the card's name and power limit
  2. build  build the kernel library from csrc/ with nvcc
  3. kernel each kernel against its plain PyTorch version on the card, at
            the main paths' shapes, in f32 and bf16 (max error, kernel ms
            and plain ms from CUDA events, one run of each); lstm_fwd (one persistent launch a layer, with and
            without activations, with its tile, two runs giving identical
            bits, and a line through its time against T: µs a step and
            the fixed cost of a launch) and lstm_bwd (one persistent
            launch a layer, at the
            encoder's and the predictor's training shapes, with its tile,
            its barrier count and cuDNN's backward beside it) and
            joint_bwd run twice must give identical bits, joint_bwd with
            kernel A, kernel B's zb pass and ring kernel and the ordered
            sums timed apart, kernel A's W^T pass and ring kernel apart
            by torch.profiler, and kernel B's ring plan; the
            lattice (alpha, beta and the occupancies: up to four warps
            walk an utterance's bands, on its walk plan) at U+1 = 41, 81
            and 101 with ragged lengths and a zero-frame row, device ms
            beside the bound; the W8A8 recurrence
            (lstm_int8: one persistent launch a layer, with its tile,
            two runs giving identical bits, one lstm_q_persistent_kernel a
            call by the profiler and its step fit) at the serving shapes
            and at batch tiles of 16 and 32 rows; the fused greedy decode
            (greedy_fused: the weights' pack and one cluster of 16 blocks
            an utterance, both named by the profiler, with its cluster
            plan, µs a step of the longest row and the digests of tokens
            and steps) on one served batch against its plain version and
            the lock-step loop;
            the fused LayerNorm (fused_ln fwd and bwd, act none and silu)
            at the conformer's serving and training rows, N = 1600 and
            6400, D = 512, against the plain LayerNorm and its autograd,
            dg / db identical over two runs, the backward's one launch with
            its blocks and the blocks an SM holds, device ms beside the
            bound; the band joint (band_fused:
            band_fwd, band_bwd_a, band_bwd_b) at the pruned step's band,
            B=32, T'=200, S=8, J=512, V=8192, lp_blank / lp_y / base,
            df / dg_w and dW / db identical over two runs, with the
            forward's and kernel A's W^T pass and main launch and kernel
            B's plan, zb pass and main launch timed apart
  4. e2e    concurrent HTTP /recognize requests; every serving kernel
            must have launched while they were served; the f32 tokens of
            the kernel path and the plain path must be identical
  4b. e2e_int8  the same requests to an engine holding quantize_params:
            the W8A8 kernel launched and lstm_fwd did not; the f32 tokens
            of the kernel path and the plain path identical; a served
            batch's encode runs one lstm_q_persistent_kernel a layer
            (their names and device ms by the profiler)
  4c. fused recognize_greedy_fused on that batch with float and int8
            params: greedy_fused launched; the f32 tokens equal to
            recognize_greedy's
  4d. e2e_conformer  the same requests to an engine on libri100_conformer:
            fused_ln_fwd launched 48 times a batch (6 LNs x 8 blocks),
            lstm_fwd never; the f32 tokens of the kernel path and the
            plain path identical, and recognize_greedy_fused's equal to
            recognize_greedy's; then serve.py's CLI with --config
            libri100_conformer, float and --quantize int8, and with
            --config libri100 (a /session at the CLI's defaults too),
            answering a request each
  4f. beam (after 5g)  the served model made to emit tens of
            tokens a row (its joint's encoder side and logits scaled,
            blank offset re-set; every check needs a mean top-beam
            length of 5 or more): 8 requests to BatchingEngine(mode="beam")
            (beam 8, 3 expansions): 4 lstm_fwd launches a batch, no K9; a
            served batch at f32 through the kernels and the plain
            versions (the two encoder outputs' rows in one search,
            `decode_beam_pair`), float and int8 (4 K7 launches), and each
            fusion
            (LSTM LM, ILM, transformer LM, trigram, context trie): the
            same n-best, live scores within 1e-3; bf16 host ms at
            buckets 400 and 800 (each fusion at 400), launches a frame
            and the busy share of a profiled batch
  5. train  training steps: finite loss and grad norm on every step, no
            skipped update, the params move, every training kernel
            launched; ms/step by the slope of bench.py and utt/s; one
            torch.profiler step split by layer, with one lstm_fwd and one
            lstm_bwd kernel per LSTM layer call (every training phase:
            5 of each at libri100) and, in the fused
            steps (this one and the conformer's), K2's kernels A and B
            as their two ring kernels each and no K6 kernel; an f32 loss
            and gradient
            through the kernels against the plain versions; the CLI for
            a few steps with a checkpoint round trip
  5b. train_pallas  the same for loss_impl="pallas" at U=80 (extract_lp,
            assemble_grad and the lattice kernels launched), the same
            batch through the fused route for comparison, and the CLI
            with --loss-impl pallas
  5c. train_conformer  libri100_conformer at B=64, T=400, U=40 through the
            default (fused) loss: 48 fused_ln_bwd launches a step, ms/step
            and utt/s, peak memory, a profiled step, the f32 check of the
            kernels against the plain versions, the CLI for 3 steps
  5d. train_pruned  loss_impl="pruned" at libri100 with V=8192, S=8, B=32,
            T=400, U=100: each K6 kernel once a step, K3 three times, no
            K1 / K2; ms/step, a profiled step (K6-A and K6-B two kernels
            a call each, their tensor-core forms), the full lattice's fused
            step on the same batch for context, the f32 check, the CLI
            with --pruned-range 8 on a JSON config
  5e. train_ar  ar_range 8 (self-aligned) at libri100, B=32, T=400, U=40:
            each K6 kernel once a step, K3 once; ms/step, a profiled step
            (K6-A and K6-B two kernels a call each), the f32 check, the
            CLI with --ar-range 8
  5f. configs (a) TIMIT: the BiLSTM encode at B=16, T=300 with ragged
            lengths through the kernels and the plain versions (6 K4-fwd
            launches; f32 within ATOL, bf16 within BILSTM_BF16_ATOL); a
            3-step f32 trajectory, each step's loss and gradients through
            both (LOSS_RTOL, GRAD_RTOL, no skipped step); bf16 steps at
            B=16, T=300, U=40 (slope ms/step, 7 K4-fwd and 7 K4-bwd a
            step, a profiled step with K1 / K2 in their CUDA-core form,
            V=63 being odd, and its busy share); K1 and K2 at that joint
            against their plain versions; 8 served requests, float and
            int8 (which dequantizes w_hh at H=320: K4-fwd, not K7), f32
            tokens equal through kernels and plain. (b) libri960: bf16
            steps at bench.py's B=64, T=400, U=60 on `auto`'s two-pass
            route (8 K4-fwd, 8 K4-bwd, one each of K5's and K3's kernels a
            step; ms/step, peak memory, a profiled step); the f32 check
            at B=8, T=64, U=10; 24 requests at serve.py's defaults, float
            (6 K4-fwd a batch) and int8 (6 K7 a batch), f32 tokens equal
            through kernels and plain; 8 streaming sessions of 32-frame
            chunks (6 K4-fwd a tick, f32 sessions equal to the offline
            answers; bf16 host ms a tick). (c) two gloo ranks share the
            card at libri960 width (`parallel/mesh.spawn`: this process
            is rank 0): the f32 loss and all-reduced gradient of B=64
            split 32 / 32 against one process on the batch (LOSS_RTOL,
            GRAD_RTOL), then bf16 steps with the ranks' params bit-equal
            after each and ms a step beside the one-process step; over
            two cards of their own on NCCL where the machine shows two,
            else a line that NCCL went unchecked; `configs_launches`
  5g. manifest (after 5f) BASELINE.json's configs[2] on manifest data:
            (a) 300 wav files from the seed (0.1 * N(0, 1), 1-18 s,
            README words) through the port's prepare tool on the card
            (BPE <= 1024 ids), CMVN stats, 8 utterances' features within
            1e-3 of log_mel_oracle, two full batches a bucket after the
            held-out dev batch; (b) f32 libri100 through the kernels and
            the plain versions on 4 rows of each bucket's batch (400,
            800, 1600 frames) with the draws fixed (speed perturbation,
            SpecAugment, dropout masks, weight noise): LOSS_RTOL,
            GRAD_RTOL, and the EMA after 2 steps; (c) the training CLI,
            --config libri100 --batch-size 32 with every regularizer, one
            SortaGrad epoch (every bucket, dev loss and PER, no skipped
            step; its launch counts as `manifest_launches`), then in
            process ms a step by slope, peak memory and the host's ms to
            load a batch a bucket, and a profiled 1600 step (5 lstm_fwd,
            5 lstm_bwd, K1 and K2 on their rings, K3, no K5 or K6, each
            family's ms beside its bound); (d) f32 SIGTERM to the CLI in
            a process of its own, exit 0 with a checkpoint, --resume
            --resume-data exact bit-equal to an uninterrupted run; (e)
            serve.py --ckpt-dir --use-ema (an audio /recognize) and the
            decode CLI --use-ema on the dev utterances (wer, rtf)
  5h. recipes (after 5g, on its corpus) the rest of training: (a) the
            C++ prefetch loader (data/native_loader.py, csrc/loader.cpp
            built by g++): one thread, seed=None, the dev batch held out,
            CMVN: every batch bit-equal to the python loader's; the
            configs[2] CLI epoch (libri100 bf16, B=32, 9 steps, the 5g
            regularizers but SortaGrad) with --loader native (two
            threads) and --loader python, each with its launch counts:
            the training thread's wait for a batch and the step's host
            ms a bucket; (b) distillation: a BiLSTM libri100 teacher (2
            CLI steps) into the libri100 student, bf16 steps at B=32,
            T=400, U=40 (ms by slope, peak GB, 9 lstm_fwd, 5 K4 with
            activations, 5 lstm_bwd and one alpha and beta of K3 a step,
            no K1 / K2 / K5), the f32 loss and gradients at B=4 through
            the kernels and the plain versions (LOSS_RTOL, GRAD_RTOL),
            the --distill-from CLI with its launches; (c) MWER on
            libri100 made to emit (emitting_model), B=8 rows of the 400
            bucket, beam 4, 2 expansions, 64 symbols: the f32 N-best
            through both paths (beams_agree) and the risk and gradients
            on it; bf16 steps, host ms, the beam's share, 5 K4 each way
            and K3 once a step; the CLI with --mwer-steps 2 of 3
  5i. ctc (after 5h) CTC, the stateless predictor and encoder remat: (a)
            f32 gates at B=4 rows of bench.py's batch, kernels against
            the plain versions (LOSS_RTOL, GRAD_RTOL): the CTC
            pretraining loss, the fused multitask loss (ctc_weight 0.3),
            the stateless fused loss, libri100_conformer and libri100
            each also with remat_encoder (the same bits expected, the
            gap reported; each encoder layer's forward kernel launched
            twice); (b) bf16 steps: CTC pretraining, the multitask step
            and the stateless hybrid at (32, 400, 40) (ms by slope, peak
            GB, launches a step, a profiled step with the share of the
            `ctc` and `ctc_backward` spans), libri100_conformer at B=64
            and libri960 at B=64, U=60 with and without remat (GB saved,
            ms added); (c) the CLIs on synthetic B=8 data: the training
            CLI (--pred-type stateless --ctc-pretrain-steps 2
            --ctc-weight 0.3, 4 steps: phases ctc, ctc, rnnt, rnnt and
            their K4 / K1 / K2 / K3 launches), the decode CLI on its
            checkpoint in greedy, beam, ctc_greedy and ctc_beam with a
            trigram (4 K4-fwd an encode) and serve.py --ckpt-dir (greedy
            with a /session, --mode beam, --quantize int8); on a fresh
            model of its config made to emit by `emitting_model`: f32
            tokens of the kernel and the plain paths equal for greedy,
            beam (`beams_agree`), CTC greedy and the CTC prefix beam's
            n-best, and the engines in this process (greedy, beam: 4
            K4-fwd a batch; int8: 4 K7; a session: 4 K4-fwd a tick);
            `ctc_launches` joins the kernels line's counts
  5j. duration (after 5i) the duration families at libri100 width,
            multi-blank (big blanks 2, 4, 8) and TDT (0, 1, 2, 4): the
            training CLI 2 steps each into a checkpoint, whose serve.py
            --ckpt-dir processes (8 /recognize, 4 /session streams each)
            run while (a) the f32 gates (each family's loss_fn at B=4 on
            the card against the CPU: LOSS_RTOL, GRAD_RTOL; 5 / 5 K4,
            no K1, K2, K3, K5) and the decode gates (a libri100 model
            made to emit and its twins made to jump: greedy tokens,
            frames and t_over through K4-fwd and the plain LSTM with the
            jumps taken, beams_agree, 4 StreamingEngine sessions equal
            to offline) and the decode CLI (greedy, beam 4) run; (b) bf16
            at (32, 400, 40) with and without ctc_weight 0.3: ms by
            slope, peak GB, 5 / 5 K4 a step, a profiled step's
            `joint_loss` and lattice-walk spans; (c) the lock-step
            greedy iterations of the standard model and its twins on one
            encoder output; `dur_launches` joins the kernels line
  5k. moe (after 5j; `--only moe` runs phases 1-2 and this alone)
            libri100 with 8 experts of 1024, capacity 1.25, aux 0.01:
            (c) the training CLI --model-parallel 2 --parallel-mode ep, 2
            steps into a checkpoint and 1 on --resume (rank 0: 5 / 5 K4,
            one K3 alpha / beta a step), a resume as sp refused
            ("topology"); its serve.py --ckpt-dir processes, float and
            --quantize int8, answer while (a) the f32 gates (B=4 ragged,
            card against CPU: routes equal, LOSS_RTOL, GRAD_RTOL on auto
            and pallas, K5 on pallas; the dense decode step within ATOL),
            the decode CLI greedy / beam and an emitting MoE model in a
            BatchingEngine float and int8 (4 K4-fwd / K7 a batch, f32
            tokens equal through the kernels and the plain LSTM) run;
            then (b) bf16 at (32, 400, 40): the one-process step (ms by
            slope, GB, 5 / 5 K4 and one K3 each a step, the MoE spans'
            host and device shares of a profiled step) and two gloo
            ranks sharing the card (`moe_rank`, a 1x2 mesh): the f32 sp
            and ep steps at capacity 8 against the one-process step,
            which has no warm-up and moves the params (the loss and the
            gradient norm within LOSS_RTOL_MP, each gradient leaf, read
            from Adam's first moment, within GRAD_RTOL of its largest,
            the params within PARAM_ATOL_MP where the gradient is above
            that noise: `step_errs`), bf16 ep and sp ms a step with
            the exchanges' and gathers' host ms, a conformer ep step (48
            / 48 K8); `moe_launches` joins the kernels line
  4g. lattice_tiles (last: no profiled check may follow the plain
            versions' long, nearly idle loops) lattice_alpha and
            lattice_beta with the occupancies at U+1 = 8,001, 11,137 and
            22,401 (B=3, T'=40) in column tiles (tile_plan) against the
            plain versions, kernel and plain ms
  4h. streaming (after every profiled check) StreamingEngine and
            BatchingEngine behind one http_server at the CLI's defaults
            (8 slots, 32-frame chunks): 8 sessions and the same
            utterances' /recognize requests at once, at f32 and bf16:
            greedy float (4 lstm_fwd launches a tick; the f32 sessions
            equal to the offline answers and to the recorded ticks
            replayed through stream_chunk on the plain versions; a
            reopened slot; the f32 encoder gap), int8 (4 K7 launches a
            tick, no lstm_fwd; the plain replay on the same slot layout;
            equal lengths against recognize_greedy), beam with the
            serve_cli trigram on beam_serving_setup's model (beams_agree
            against the offline beam engine and the plain replay),
            libri100_conformer_chunked at 128-frame chunks (48
            fused_ln_fwd launches a tick, the f32 sessions equal to the
            offline answers); bf16 host ms a tick, RTF, the busy share
            of a profiled tick; the streaming phase's launches apart
  4i. audio (last) raw 16 kHz PCM in, text out: the served utterances
            as 0.1 * N(0, 1) audio from the seed (T*160 + 240 samples, T
            frames), global CMVN stats of their features, a BPE tokenizer
            learned from README.md. (a) the card log_mel of 8 utterances
            (<= 8 s) against log_mel_oracle (float64): max abs <= 1e-3,
            frame lens equal; card ms and kernels for the batch and one
            8 s utterance. (b) f32, both engines behind http_server with
            the tokenizer and CMVN: an {"audio"} /recognize gives the
            tokens of its card log_mel sent as {"feats"}; text and words.
            (c) 8 PCM sessions split at uneven points (a POST that
            completes no frame) with their /recognize requests at once:
            the features within 5e-4 of offline, the final tokens the
            offline engine's on those features. (e) serve.py's defaults,
            24 requests, bf16, float and int8: audio and feats bodies, 4
            K4-fwd (K7) launches a batch, p50 of each, host ms to parse an
            8 s body. (d) the training CLI with --tokenizer bpe:...,
            serve.py --ckpt-dir (audio /recognize with text, a PCM
            session; --mode beam --boost-file: an n-best with text) and
            the decode CLI on a manifest of .npy audio (wer, rtf,
            word_wer), libri100 and libri100_conformer
  6. the kernels' JSON line (sixteen kernels) (each kernel with its bound, the least time
     the card could take: bytes over 3.35 TB/s or operations over the
     peak for the operands' type, whichever is larger; and the time of one
     PyTorch call computing the same function where there is one; the
     lattice kernels' `ms` is a call's, with the host's enqueue, and
     their `device_ms` the device's alone), the card line, then
     {"ok": true, ...} last

TF32 is off for matmuls and cuDNN: every float32 product runs in float32.
Any failed check exits non-zero; with no CUDA device it exits before any
result is printed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import collections
import io
import itertools
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from unittest import mock

import numpy as np
import torch

from rnn_transducer_tpu_torch.bench_band_bwd_b import step_fit
from rnn_transducer_tpu_torch.data.bpe import BpeTokenizer
from rnn_transducer_tpu_torch.data.cmvn import apply_cmvn, stats_arrays
from rnn_transducer_tpu_torch.data.tokenizer import (decode_to_text,
                                                     tokenizer_to_meta)
from rnn_transducer_tpu_torch.decode import greedy_fused as gf
from rnn_transducer_tpu_torch.decode.greedy import greedy_decode, recognize_greedy
from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import (
    TrainConfig, config_libri100, config_libri100_conformer,
    config_libri100_conformer_chunked, config_libri960, config_timit)
from rnn_transducer_tpu_torch.ops import fused_ln as fl
from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
from rnn_transducer_tpu_torch.ops import moe
from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as jf
from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat
from rnn_transducer_tpu_torch.ops import rnnt_loss as rl
from rnn_transducer_tpu_torch.ops import rnnt_loss_cuda as lc
from rnn_transducer_tpu_torch.ops.logmel import (featurize, log_mel,
                                                 log_mel_oracle)
from rnn_transducer_tpu_torch.ops.lstm import _dot, w8a8_supported
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.parallel import tp as tpx
from rnn_transducer_tpu_torch.parallel.mesh import shard_batch_2d
from rnn_transducer_tpu_torch.ops.quant import (quantize_params,
                                                quantize_tensor,
                                                quantized_bytes)
from rnn_transducer_tpu_torch.serve import (BatchingEngine, StreamingEngine,
                                            http_server)
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tl
from rnn_transducer_tpu_torch.train.__main__ import main as train_cli
from rnn_transducer_tpu_torch.train.__main__ import parse_args as train_args
from rnn_transducer_tpu_torch.train.__main__ import train_batch
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
# The training path's shapes: bench.py's headline batch, B=32, T=400
# frames (layer 0), T'=200 after 2x stacking (layers 1-3 and the joint),
# U+1=41, J=512, V=1024; the predictor (E=512) sees U+1=41 steps at the
# libri100 batch and at the conformer's B=64.
TRAIN_B, TRAIN_T, TRAIN_U = 32, 400, 40
TRAIN_LSTM_CASES = (("l0_train", 32, 400, 80, False),
                    ("l1_train", 32, 200, 1024, False),
                    ("pred_b32", 32, 41, 512, False),
                    ("pred_b64", 64, 41, 512, False),
                    ("ragged_b3", 3, 37, 80, True))
TRAIN_MAIN = ("l0_train", torch.bfloat16)
# libri960's training recurrences at H=1024, at the B=64 of its timed
# step (phase 5f (b)): layer 0 at T=400 frames of 80 features, layers 1-5
# at T'=200 of 2048 (2x stacking), the predictor (E=512) at U+1=61. B=64
# and H=1024 give the K4 tiles nearest the card's shared-memory limit.
L960_LSTM_CASES = (("l0_libri960", 64, 400, 80, False),
                   ("l1_libri960", 64, 200, 2048, False),
                   ("pred_libri960", 64, 61, 512, False))
# Backward outputs and gradients: max |kernel - plain| over max |plain|.
# f32: summation order only. bf16: both sides round the same operands, but
# a 1-ulp difference before a rounding can flip one bf16 value (2^-8).
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The f32 training step through the kernels against the plain versions:
# the loss within 1e-5 relative, every gradient leaf within 1e-3 of its
# largest value (400 steps of BPTT and lattice sums in another order).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# The two-pass route's label length: bench.py's batch at the U where the
# JAX package's auto turns from fused to two-pass on the TPU.
PALLAS_U = 80
# Lattice kernel vs plain: alpha and beta on reachable cells within
# 1e-5 max(1, |plain|) (float32 sums of up to T + U terms, in the same
# order on both sides), the occupancies within 1e-5 absolute.
LATTICE_RTOL, OCC_ATOL = 1e-5, 1e-5
# Label lengths past one walk plan (beta above U+1 = 7,936, alpha above
# 11,136): the lattice in column tiles.
LATTICE_TILE_U = (8_000, 11_136, 22_400)
SLOPE_STEPS, SLOPE_REPEATS = (2, 6), 1  # bench.py's slope method, shorter
# The W8A8 recurrence against its plain version: (name, B, T, I, nonzero
# h0/c0). libri100 serving at the 800-frame bucket (B = 8: one 8-row batch
# tile, as every served batch), and batch tiles of 32 and 16 rows.
INT8_CASES = (("l0_b800", 8, 800, 80, False), ("l1_b800", 8, 400, 1024, False),
              ("b32_l1", 32, 200, 1024, True),
              ("b16_l1", 16, 200, 1024, True))
INT8_MAIN = ("l0_b800", torch.bfloat16)
# The conformer's training shape: bench.py's B=64, T=400 (T'=100 after 4x
# stacking), U=40. The fused LayerNorm's rows: a served batch of 8 at the
# 800-frame bucket (T'=200) and that training batch, D = 512; 6 LNs in
# each of the 8 blocks.
CONF_B, CONF_T, CONF_U = 64, 400, 40
LN_CASES = (("serve", 8 * 200), ("train", CONF_B * CONF_T // 4))
LN_D, LN_PER_ENCODE = 512, 6 * 8
LN_MAIN = ("train", "none")  # the kernels line's ms / plain_ms / bound
# K8 against the plain LayerNorm and its autograd: y within 1e-5 absolute;
# dx within 1e-5 of its largest value; dg and db, sums over every row in
# another order, within 1e-4 of theirs.
LN_Y_ATOL, LN_DX_RTOL, LN_DGB_RTOL = 1e-5, 1e-5, 1e-4
# The pruned loss's card shape (docs/PERFORMANCE.md:294-298): libri100 with
# a vocabulary of 8192 and a band of S=8 at bench.py's B=32, T=400, U=100;
# and the AR band, libri100 (V=1024) at B=32, T=400, U=40, S=8, centred.
PRUNED_V, PRUNED_S, PRUNED_U = 8192, 8, 100
# band_bwd_b's bf16 time at the pruned band with the 32-column design that
# rebuilt z per tile (H100 80GB HBM3, 700 W): context for the ring design
BWD_B_PREV_MS = 65.826
# band_fwd's bf16 time at the pruned band with the design that staged W by
# thread loads, 32 rows of J a step, and parked the logits in shared memory
# (H100 80GB HBM3, 700 W): context for the W^T ring design
FWD_PREV_MS = 12.072
# band_bwd_a's bf16 time at the pruned band with the design that kept dz in
# shared memory and read W from L2 per 64 rows (H100 80GB HBM3, 700 W):
# context for the W^T ring design
BWD_A_PREV_MS = 27.478
# joint_bwd's kernel A's bf16 time at libri100's joint with the design that
# took a frame tile a block and read W's fragments from L2 (H100 80GB
# HBM3, 700 W): context for its W^T ring design
JOINT_A_PREV_MS = 17.213
# joint_fwd's bf16 time at libri100's joint with the design that staged W
# by thread loads, 32 rows of J a step, and parked the logits in shared
# memory (H100 80GB HBM3, 700 W): context for its W^T ring design
JOINT_FWD_PREV_MS = 4.942
AR_S = 8
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory bytes/s and operations/s by operand type. A bound is the larger of
# the bytes a function must move (inputs read once, outputs written once)
# over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50_000_000
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
                  torch.float16: 989e12, torch.int8: 1979e12}


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


def cuda_ms_out(fn):
    """fn()'s result and its ms by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn) -> float:
    return cuda_ms_out(fn)[1]


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def max_abs(got, want) -> float:
    return float((got - want).abs().max())


def timed_pair(kernel_fn, plain_fn) -> tuple[float, float]:
    """Kernel ms and plain ms from CUDA events, one run of each, kernel
    then plain."""
    times = {"plain": [], "kernel": []}
    for which in ("kernel", "plain"):
        times[which].append(cuda_ms(kernel_fn if which == "kernel"
                                    else plain_fn))
    return statistics.mean(times["kernel"]), statistics.mean(times["plain"])


def nbytes(*tensors) -> int:
    """Bytes of the tensors, nested in tuples and lists; None counts 0."""
    total = 0
    for a in tensors:
        if isinstance(a, (tuple, list)):
            total += nbytes(*a)
        elif isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
    return total


def bound(n_bytes: int, ops: float, dtype) -> dict:
    """The least time the card could take for work that moves n_bytes and
    does `ops` operations on operands of `dtype`, and which of the two
    bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops}


def cudnn_lstm_ms(x, w_ih, w_hh, b, h0, c0) -> dict:
    """torch.nn.LSTM (cuDNN) on the layer's shape: the inference forward
    and the backward (dx, dh0, dc0 and the weight gradients), each the
    median of 5 calls after 2 warm-ups with their min and max, since they
    spread from call to call; the training forward, the mean of 3. cuDNN's
    RNN takes float16 but not
    bfloat16 in PyTorch, so it runs in float16: the same bytes per value
    and the same tensor-core rate as the kernels' bf16. Its forward
    includes the input projection that the kernel leaves to a matmul."""
    dt = torch.float16
    B, _, I = x.shape
    H = w_hh.shape[0]
    lstm = torch.nn.LSTM(I, H, batch_first=True).to(x.device, dt)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    xs = x.to(dt).requires_grad_(True)
    state = (h0[None].to(dt), c0[None].to(dt))
    with torch.no_grad():
        for _ in range(2):  # warm: cuDNN's plan
            lstm(xs, state)
        infer = [cuda_ms(lambda: lstm(xs, state)) for _ in range(5)]
    for _ in range(2):  # warm: the training plan and its reserve space
        out = lstm(xs, state)[0]
    train = statistics.mean(cuda_ms(lambda: lstm(xs, state)) for _ in range(3))
    grad = torch.randn_like(out)
    for _ in range(2):  # warm: the backward's plan
        out.backward(grad, retain_graph=True)
    bwd = [cuda_ms(lambda: out.backward(grad, retain_graph=True))
           for _ in range(5)]
    return {"library_dtype": "float16",
            "bf16_acceptable_to_cudnn": torch.backends.cudnn.is_acceptable(
                x.to(torch.bfloat16)),
            "cudnn_fwd_ms": statistics.median(infer),
            "cudnn_fwd_min_ms": min(infer), "cudnn_fwd_max_ms": max(infer),
            "cudnn_train_fwd_ms": train,
            "cudnn_bwd_ms": statistics.median(bwd),
            "cudnn_bwd_min_ms": min(bwd), "cudnn_bwd_max_ms": max(bwd)}


def reset_counts() -> None:
    lstm_cuda.LAUNCHES = lstm_cuda.LAUNCHES_WITH_ACTS = 0
    lstm_cuda.LAUNCHES_BWD = 0
    jf.LAUNCHES_FWD = jf.LAUNCHES_BWD = 0
    lat.LAUNCHES_ALPHA = lat.LAUNCHES_BETA = 0
    lc.LAUNCHES_EXTRACT = lc.LAUNCHES_GRAD = 0
    q8.LAUNCHES = gf.LAUNCHES = 0
    fl.LAUNCHES_FWD = fl.LAUNCHES_BWD = 0
    bf.LAUNCHES_FWD = bf.LAUNCHES_BWD_A = bf.LAUNCHES_BWD_B = 0


def read_counts() -> dict:
    return {"lstm_fwd": lstm_cuda.LAUNCHES,
            "lstm_fwd_with_acts": lstm_cuda.LAUNCHES_WITH_ACTS,
            "lstm_bwd": lstm_cuda.LAUNCHES_BWD,
            "joint_fwd": jf.LAUNCHES_FWD, "joint_bwd": jf.LAUNCHES_BWD,
            "lattice_alpha": lat.LAUNCHES_ALPHA,
            "lattice_beta": lat.LAUNCHES_BETA,
            "extract_lp": lc.LAUNCHES_EXTRACT,
            "assemble_grad": lc.LAUNCHES_GRAD,
            "lstm_fwd_int8": q8.LAUNCHES, "greedy_fused": gf.LAUNCHES,
            "fused_ln_fwd": fl.LAUNCHES_FWD, "fused_ln_bwd": fl.LAUNCHES_BWD,
            "band_lp_fwd": bf.LAUNCHES_FWD,
            "band_lp_bwd_a": bf.LAUNCHES_BWD_A,
            "band_lp_bwd_b": bf.LAUNCHES_BWD_B}


BAND_KERNELS = ("band_lp_fwd", "band_lp_bwd_a", "band_lp_bwd_b")


def check_no_band(counts: dict, where: str) -> None:
    """K6 belongs to the pruned and AR losses alone."""
    check(all(counts[k] == 0 for k in BAND_KERNELS),
          f"{where} launched a K6 band kernel: "
          f"{ {k: counts[k] for k in BAND_KERNELS} }")


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain version, on the card."""
    with contextlib.ExitStack() as stack:
        for mod, name in ((lstm_cuda, "lstm_recurrence"),
                          (lstm_cuda, "lstm_recurrence_with_acts"),
                          (lstm_cuda, "lstm_recurrence_bwd"),
                          (jf, "joint_lp_fwd"), (jf, "joint_lp_bwd"),
                          (lat, "alpha_wavefront"), (lat, "beta_wavefront"),
                          (lat, "beta_occupancies"), (lc, "extract_lp"),
                          (lc, "assemble_grad"), (q8, "lstm_recurrence_int8"),
                          (gf, "greedy_fused_tokens"), (fl, "fln_fwd"),
                          (fl, "fln_bwd"), (bf, "band_lp_fwd"),
                          (bf, "band_lp_bwd_a"), (bf, "band_lp_bwd_b")):
            stack.enter_context(mock.patch.object(
                mod, name, getattr(mod, name + "_reference")))
        yield


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
            again = lstm_cuda.lstm_recurrence(*args)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in (
                (got[0], want[0]), (got[1][0], want[1][0]),
                (got[1][1], want[1][1])))
            same_bits = (torch.equal(got[0], again[0])
                         and torch.equal(got[1][1], again[1][1]))
            # the same inputs with activations, as a training step runs them
            err_acts = max(max_abs(g, r) for g, r in zip(
                lstm_cuda.lstm_recurrence_with_acts(*args),
                lstm_cuda.lstm_recurrence_with_acts_reference(*args)))
            ok = (bool(torch.isfinite(got[0]).all())
                  and max(err, err_acts) <= ATOL[cd])
            times = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = (lstm_cuda.lstm_recurrence if which == "kernel"
                      else lstm_cuda.lstm_recurrence_reference)
                times[which].append(cuda_ms(lambda: fn(*args)))
            row = {"case": name, "B": B, "T": T, "I": I, "H": H,
                   "dtype": str(cd).replace("torch.", ""),
                   "max_abs_err": err, "atol": ATOL[cd],
                   "with_acts_max_abs_err": err_acts,
                   "kernel_ms": statistics.mean(times["kernel"]),
                   "plain_ms": statistics.mean(times["plain"]),
                   "bitwise_repeat": same_bits,
                   "plan": fwd_plan_row(B, H, cd, dev),
                   **bound(nbytes(args, got[0], got[1][1]),
                           2 * B * T * H * 4 * H, cd)}
            if (name, cd) == MAIN_CASE:
                # the layer as lstm_layer runs it, the input projection
                # included, beside cuDNN's LSTM, which includes it too
                def layer():
                    lstm_cuda.lstm_recurrence(
                        (_dot(x, w_ih, cd) + b).contiguous(), w, h0, c0)
                row["proj_plus_kernel_ms"] = statistics.mean(
                    cuda_ms(layer) for _ in range(2))
                row.update(cudnn_lstm_ms(x, w_ih, w_hh, b, h0, c0))
                row["library_ms"] = row["cudnn_fwd_ms"]
            if name == MAIN_CASE[0]:
                row["step_fit"] = step_fit(device_ms, dev, cd, B, H)
            print("kernel lstm_fwd " + json.dumps(row))
            check(ok, f"lstm_fwd {name} {cd}: max abs err {err} (with "
                      f"activations {err_acts}) > {ATOL[cd]} or non-finite "
                      "output")
            check(same_bits, f"lstm_fwd {name} {cd}: two runs gave "
                             "different bits")
            rows.append(row)
            worst = max(worst, err)
            if (name, cd) == MAIN_CASE:
                main = row
    return {"rows": rows, "max_abs_err": worst, "main": main}


def fwd_plan_row(B: int, H: int, cd, dev) -> dict:
    """K4-fwd's tile on this card: grid, units and rows a block, shared
    bytes, stage passes a step."""
    plan = lstm_cuda.device_fwd_plan(B, H, cd, dev)
    return {"grid": plan.grid, "units": plan.units, "rows": plan.rows,
            "smem_bytes": plan.smem_bytes, "passes": plan.passes}


def lstm_train_vs_plain(rng: np.random.Generator, dev, H: int = 512,
                        cases=TRAIN_LSTM_CASES, main_case=TRAIN_MAIN) -> dict:
    """lstm_fwd with activations and lstm_bwd against their plain loops at
    the training path's shapes (`cases` at hidden width H); lstm_bwd run
    twice must give identical bits. Beside the kernel's time: the kernel
    with the dW_hh product, as LSTMCore.backward runs them
    (`bwd_with_dw_ms`), and with the input projection's gradients too
    (`bwd_layer_ms`: dx, dW_ih, db), the work of cuDNN's backward; the
    kernel's tile (bwd_plan) and grid barriers."""
    rows, worst, main = [], {"fwd": 0.0, "bwd": 0.0}, None
    for name, B, T, I, with_state in cases:
        k = 1.0 / np.sqrt(H)
        w_ih = torch.from_numpy(rng.uniform(-k, k, (I, 4 * H))).float().to(dev)
        w_hh = torch.from_numpy(rng.uniform(-k, k, (H, 4 * H))).float().to(dev)
        b = torch.from_numpy(rng.uniform(-2 * k, 2 * k, 4 * H)).float().to(dev)
        x = torch.from_numpy(rng.normal(size=(B, T, I))).float().to(dev)
        h0 = torch.zeros(B, H, device=dev)
        c0 = torch.zeros(B, H, device=dev)
        dcT = torch.zeros(B, H, device=dev)  # training: final state unused
        if with_state:
            h0 = torch.from_numpy(0.5 * rng.normal(size=(B, H))).float().to(dev)
            c0 = torch.from_numpy(rng.normal(size=(B, H))).float().to(dev)
            dcT = torch.from_numpy(rng.normal(size=(B, H))).float().to(dev)
        dhs = torch.from_numpy(rng.normal(size=(B, T, H))).float().to(dev)
        for cd in (torch.float32, torch.bfloat16):
            x_proj = (_dot(x, w_ih, cd) + b).contiguous()
            w = w_hh.to(cd).contiguous()
            fwd_args = (x_proj, w, h0, c0)
            want = lstm_cuda.lstm_recurrence_with_acts_reference(*fwd_args)
            got = lstm_cuda.lstm_recurrence_with_acts(*fwd_args)
            fwd_again = lstm_cuda.lstm_recurrence_with_acts(*fwd_args)
            cs_prev = torch.cat([c0[:, None], want[1][:, :-1]], 1)
            bwd_args = (want[2], cs_prev, dhs, dcT, w)
            want_b = lstm_cuda.lstm_recurrence_bwd_reference(*bwd_args)
            got_b = lstm_cuda.lstm_recurrence_bwd(*bwd_args)
            again = lstm_cuda.lstm_recurrence_bwd(*bwd_args)
            torch.cuda.synchronize()
            err_f = max(max_abs(g, r) for g, r in zip(got, want))
            err_b = max(max_abs(g, r) for g, r in zip(got_b, want_b))
            rel_b = max(rel_err(g, r) for g, r in zip(got_b, want_b))
            same_bits = all(torch.equal(g, a) for g, a in zip(got_b, again))
            fwd_same_bits = all(torch.equal(g, a)
                                for g, a in zip(got, fwd_again))
            # the same inputs without activations, as serving runs them
            err_n = max(max_abs(g, r) for g, r in zip(
                leaves(lstm_cuda.lstm_recurrence(*fwd_args)),
                leaves(lstm_cuda.lstm_recurrence_reference(*fwd_args))))
            ok = (all(bool(torch.isfinite(g).all()) for g in got + got_b)
                  and max(err_f, err_n) <= ATOL[cd]
                  and rel_b <= REL_TOL[cd])
            kf, pf = timed_pair(
                lambda: lstm_cuda.lstm_recurrence_with_acts(*fwd_args),
                lambda: lstm_cuda.lstm_recurrence_with_acts_reference(
                    *fwd_args))
            kb, pb = timed_pair(
                lambda: lstm_cuda.lstm_recurrence_bwd(*bwd_args),
                lambda: lstm_cuda.lstm_recurrence_bwd_reference(*bwd_args))
            hs_prev = torch.cat([h0[:, None], want[0][:, :-1]], 1).reshape(
                B * T, H)
            x2 = x.reshape(B * T, I)

            def bwd_with_dw(layer: bool):
                dg = lstm_cuda.lstm_recurrence_bwd(*bwd_args)[0].reshape(
                    B * T, 4 * H)
                _dot(hs_prev.t(), dg, cd)
                if layer:
                    _dot(dg, w_ih.t(), cd)
                    _dot(x2.t(), dg, cd)
                    dg.sum(0)

            with_dw = {k: statistics.median(
                cuda_ms(lambda: bwd_with_dw(k == "layer")) for _ in range(5))
                for k in ("dw", "layer")}
            plan = lstm_cuda.device_bwd_plan(B, H, cd, dev)
            ops = 2 * B * T * H * 4 * H
            row = {"case": name, "B": B, "T": T, "I": I, "H": H,
                   "dtype": str(cd).replace("torch.", ""),
                   "fwd_max_abs_err": err_f, "fwd_atol": ATOL[cd],
                   "fwd_no_acts_max_abs_err": err_n,
                   "bwd_max_abs_err": err_b, "bwd_rel_err": rel_b,
                   "bwd_rtol": REL_TOL[cd], "bwd_bitwise_repeat": same_bits,
                   "fwd_bitwise_repeat": fwd_same_bits,
                   "fwd_kernel_ms": kf, "fwd_plain_ms": pf,
                   "bwd_kernel_ms": kb, "bwd_plain_ms": pb,
                   "fwd_plan": fwd_plan_row(B, H, cd, dev),
                   "bwd_with_dw_ms": with_dw["dw"],
                   "bwd_layer_ms": with_dw["layer"],
                   "bwd_plan": {**dataclasses.asdict(plan),
                                "passes": plan.passes},
                   "bwd_barriers": T,
                   "fwd_bound": bound(nbytes(fwd_args, got), ops, cd),
                   "bwd_bound": bound(nbytes(bwd_args, got_b), ops, cd)}
            if (name, cd) == main_case:
                row.update(cudnn_lstm_ms(x, w_ih, w_hh, b, h0, c0))
            print("kernel lstm_fwd_with_acts+lstm_bwd " + json.dumps(row))
            check(ok, f"lstm training kernels {name} {cd}: fwd err {err_f} "
                      f"(without activations {err_n}), bwd rel err {rel_b}, "
                      "or non-finite output")
            check(same_bits, f"lstm_bwd {name} {cd}: two runs gave "
                             "different bits")
            check(fwd_same_bits, f"lstm_fwd with activations {name} {cd}: "
                                 "two runs gave different bits")
            rows.append(row)
            worst["fwd"] = max(worst["fwd"], err_f)
            worst["bwd"] = max(worst["bwd"], err_b)
            if (name, cd) == main_case:
                main = row
    return {"rows": rows, "worst": worst, "main": main}


def joint_vs_plain(rng: np.random.Generator, dev) -> dict:
    """joint_fwd and joint_bwd against their plain versions at the training
    path's joint shape, with ragged frame and label lengths, one
    zero-frame row and the occupancies of the real lattice; each run
    twice must give identical bits, and lp_y must be -1e30 at u = U. The
    forward's W^T pass and ring kernel are timed apart by events, and the
    profiler must see them (bf16) or the CUDA-core kernel (f32) alone."""
    B, T, U, J, V = TRAIN_B, TRAIN_T // 2, TRAIN_U, 512, 1024
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
    gbar = torch.full((B,), 1.0 / B, device=dev)  # the batch mean's
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        w = w32.to(cd).contiguous()
        fwd_args = (f, g, labels, w, b)
        want = jf.joint_lp_fwd_reference(*fwd_args)
        got = jf.joint_lp_fwd(*fwd_args)
        again_f = jf.joint_lp_fwd(*fwd_args)
        gb, gy = rl.occupancies_from_lp(want[0], want[1], fl, ll)
        bwd_args = (f, g, labels, w, b, gb, gy, want[2], gbar)
        want_b = jf.joint_lp_bwd_reference(*bwd_args)
        got_b = jf.joint_lp_bwd(*bwd_args)
        again = jf.joint_lp_bwd(*bwd_args)
        torch.cuda.synchronize()
        err_f = max(max_abs(x, y) for x, y in zip(got, want))
        err_b = max(max_abs(x, y) for x, y in zip(got_b, want_b))
        rel_b = {n: rel_err(x, y) for n, x, y in
                 zip(("df", "dg", "dw", "db"), got_b, want_b)}
        same_bits = all(torch.equal(x, y) for x, y in zip(got_b, again))
        same_bits_f = all(torch.equal(x, y) for x, y in zip(got, again_f))
        lp_y_last = bool((got[1][:, :, U] == -1e30).all())
        del again_f
        kf, pf = timed_pair(lambda: jf.joint_lp_fwd(*fwd_args),
                            lambda: jf.joint_lp_fwd_reference(*fwd_args))
        kb, pb = timed_pair(lambda: jf.joint_lp_bwd(*bwd_args),
                            lambda: jf.joint_lp_bwd_reference(*bwd_args))
        # the forward's W^T pass (0 in the CUDA-core form) and its ring or
        # CUDA-core kernel by events, and its kernels by name
        fwd_wt_ms, fwd_main_ms = event_split_ms(
            lambda i, ev: jf.joint_lp_fwd(*fwd_args, events=ev), 3)
        f_split = kernel_ms_by_name(
            lambda: jf.joint_lp_fwd(*fwd_args),
            ("joint_fwd_wt_kernel", "joint_fwd_ring_kernel",
             "joint_fwd_kernel"))
        # kernel A, kernel B's zb pass (0 in the CUDA-core form) and main
        # launch, the ordered sums
        a_ms, zb_ms, main_ms, sums_ms = event_split_ms(
            lambda i, ev: jf.joint_lp_bwd(*bwd_args, events=ev), 5)
        # kernel A's launches apart: the ring's W^T pass and ring kernel,
        # or the CUDA-core kernel
        a_split = kernel_ms_by_name(
            lambda: jf.joint_lp_bwd(*bwd_args),
            ("joint_bwd_a_wt_kernel", "joint_bwd_a_ring_kernel",
             "joint_bwd_a_kernel"))
        ring = bf.tensor_core_form(cd, J, V)
        plan = jf.device_bwd_b_plan(B * T * (U + 1), J, V, dev) if ring \
            else None
        fwd_layout = jf.device_fwd_layout(J, V, dev) if ring else None
        ops = 2 * B * T * (U + 1) * J * V  # one product over the cells
        row = {"B": B, "T": T, "U1": U + 1, "J": J, "V": V,
               "dtype": str(cd).replace("torch.", ""),
               "fwd_max_abs_err": err_f, "fwd_atol": ATOL[cd],
               "fwd_bitwise_repeat": same_bits_f,
               "fwd_lp_y_at_U_is_neg_inf": lp_y_last,
               "bwd_max_abs_err": err_b, "bwd_rel_err": rel_b,
               "bwd_rtol": REL_TOL[cd], "bwd_bitwise_repeat": same_bits,
               "fwd_kernel_ms": kf, "fwd_plain_ms": pf,
               # the forward: its W^T pass and main launch by events, its
               # kernels by the profiler, its layout (None: CUDA-core)
               "fwd_wt_ms": fwd_wt_ms, "fwd_main_ms": fwd_main_ms,
               "fwd_wt_kernel_ms": f_split["joint_fwd_wt_kernel"],
               "fwd_ring_kernel_ms": f_split["joint_fwd_ring_kernel"],
               "fwd_cuda_core_ms": f_split["joint_fwd_kernel"],
               "fwd_prev_ms": (JOINT_FWD_PREV_MS if cd == torch.bfloat16
                               else None),
               "fwd_wt_shape": (list(fwd_layout.wt_shape) if fwd_layout
                                else None),
               "fwd_smem_bytes": (fwd_layout.smem_bytes if fwd_layout
                                  else None),
               "bwd_kernel_ms": kb, "bwd_plain_ms": pb,
               "bwd_a_ms": a_ms, "bwd_b_zb_ms": zb_ms,
               "bwd_b_main_ms": main_ms, "bwd_sums_ms": sums_ms,
               "bwd_a_wt_ms": a_split["joint_bwd_a_wt_kernel"],
               "bwd_a_ring_ms": a_split["joint_bwd_a_ring_kernel"],
               "bwd_a_cuda_core_ms": a_split["joint_bwd_a_kernel"],
               "bwd_a_prev_ms": (JOINT_A_PREV_MS if cd == torch.bfloat16
                                 else None),
               # kernel B: the ring's plan (None: the CUDA-core form,
               # ROW_SPLITS splits of 32 columns)
               "bwd_b_plan": dataclasses.asdict(plan) if plan else None,
               # forward: the logits product; backward: it again, dz and
               # dW; kernel A: the logits again and dz; kernel B: the
               # logits again and dW
               "fwd_bound": bound(nbytes(fwd_args, got), ops, cd),
               "bwd_bound": bound(nbytes(bwd_args, got_b), 3 * ops, cd),
               "bwd_a_bound": bound(nbytes(bwd_args, got_b[:2]), 2 * ops,
                                    cd),
               "bwd_b_bound": bound(nbytes(bwd_args, got_b[2:]), 2 * ops,
                                    cd)}
        print("kernel joint_fwd+joint_bwd " + json.dumps(row))
        check(all(bool(torch.isfinite(x).all()) for x in got_b)
              and err_f <= ATOL[cd] and max(rel_b.values()) <= REL_TOL[cd],
              f"joint kernels {cd}: fwd err {err_f}, bwd rel err {rel_b}")
        check(same_bits, f"joint_bwd {cd}: two runs gave different bits")
        check(same_bits_f, f"joint_fwd {cd}: two runs gave different bits")
        check(lp_y_last, f"joint_fwd {cd}: lp_y at u = U is not -1e30")
        ran = {n: f_split[n] > 0 for n in f_split}
        check(ran == {"joint_fwd_wt_kernel": ring,
                      "joint_fwd_ring_kernel": ring,
                      "joint_fwd_kernel": not ring},
              f"joint_fwd {cd}: the profiler saw {f_split} (ms by kernel)")
        check(float(got_b[0][1].abs().max()) == 0.0,
              "joint_bwd: the zero-frame row has a non-zero gradient")
        out[cd] = row
    return {"rows": out, "main": out[torch.bfloat16],
            "worst_fwd": max(r["fwd_max_abs_err"] for r in out.values()),
            "worst_bwd": max(r["bwd_max_abs_err"] for r in out.values())}


def ragged_lengths(rng: np.random.Generator, dev, B: int, T: int, U: int):
    """Frame and label lengths (B,) int32: row 0 full, row 1 without
    frames, row 2 without labels, the rest from [T/2, T] and [U/2, U]."""
    fl = rng.integers(T // 2, T + 1, B)
    ll = rng.integers(U // 2, U + 1, B)
    fl[0], ll[0], fl[1], ll[2] = T, U, 0, 0
    return (torch.from_numpy(fl).int().to(dev),
            torch.from_numpy(ll).int().to(dev))


def lattice_scores(rng: np.random.Generator, dev, B: int, T: int, U: int):
    """Blank and label log-probs (B, T, U+1) of a random 3-way softmax
    (every path stays alive) and ragged lengths."""
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, T, U + 1, 3))).float().to(dev), dim=-1)
    return (lp[..., 0].contiguous(), lp[..., 1].contiguous(),
            *ragged_lengths(rng, dev, B, T, U))


def lattice_err(got, want) -> tuple[float, float, bool]:
    """Max abs error and max error over max(1, |plain|) on the reachable
    cells; whether every unreachable cell is at or below -1e29."""
    reach = want > -1e29
    d = (got - want).abs()[reach]
    scale = want.abs()[reach].clamp(min=1.0)
    return (float(d.max()), float((d / scale).max()),
            bool((got[~reach] <= -1e29).all()))


def lattice_vs_plain(rng: np.random.Generator, dev) -> dict:
    """lattice_alpha and lattice_beta (with the occupancies) against their
    plain versions at the training step's lattice, T'=200 and U+1 = 41
    (the fused route), 81 (the two-pass route) and 101 (the pruned step),
    ragged lengths and a zero-frame row; and the loss through them against
    the plain path. Times: ms of a call with the host's enqueue in turns
    with the plain version, and the device's ms (`device_ms`)."""
    B, T = TRAIN_B, TRAIN_T // 2
    rows = {}
    for U in (TRAIN_U, PALLAS_U, PRUNED_U):
        lpb, lpy, fl, ll = lattice_scores(rng, dev, B, T, U)
        lpb_m, lpy_m = rl._masked_transitions(lpb, lpy, fl, ll)
        accept = rl._accept_scores(lpb, fl, ll)
        a_args = (lpb_m, lpy_m)
        want_a = lat.alpha_wavefront_reference(*a_args)
        got_a = lat.alpha_wavefront(*a_args)
        b_args = (lpb_m, lpy_m, accept, want_a, fl)
        want_b = lat.beta_occupancies_reference(*b_args)
        got_b = lat.beta_occupancies(*b_args)
        loss_k = rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)[0]
        with plain_kernels():
            loss_p = rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)[0]
        torch.cuda.synchronize()
        err_a, rel_a, unreach_a = lattice_err(got_a, want_a)
        err_b, rel_b, unreach_b = lattice_err(got_b[0], want_b[0])
        err_occ = max(max_abs(got_b[1], want_b[1]),
                      max_abs(got_b[2], want_b[2]))
        loss_rel = rel_err(loss_k, loss_p)
        ka, pa = timed_pair(lambda: lat.alpha_wavefront(*a_args),
                            lambda: lat.alpha_wavefront_reference(*a_args))
        kb, pb = timed_pair(lambda: lat.beta_occupancies(*b_args),
                            lambda: lat.beta_occupancies_reference(*b_args))
        row = {"B": B, "T": T, "U1": U + 1,
               "alpha_max_abs_err": err_a, "alpha_rel_err": rel_a,
               "beta_max_abs_err": err_b, "beta_rel_err": rel_b,
               "rtol": LATTICE_RTOL, "occ_max_abs_err": err_occ,
               "occ_atol": OCC_ATOL, "loss_rel_err": loss_rel,
               "loss_rtol": LOSS_RTOL, "alpha_kernel_ms": ka,
               "alpha_plain_ms": pa, "beta_kernel_ms": kb,
               "beta_plain_ms": pb,
               "alpha_device_ms": device_ms(
                   lambda: lat.alpha_wavefront(*a_args)),
               "beta_device_ms": device_ms(
                   lambda: lat.beta_occupancies(*b_args)),
               "plan": {k: dataclasses.asdict(lat.walk_plan(U + 1, beta))
                        for k, beta in (("alpha", False), ("beta", True))},
               # a log-add-exp of two terms per cell: ~8 operations; beta
               # adds the two occupancies
               "alpha_bound": bound(nbytes(a_args, got_a),
                                    8 * B * T * (U + 1), torch.float32),
               "beta_bound": bound(nbytes(b_args, got_b),
                                   16 * B * T * (U + 1), torch.float32)}
        print("kernel lattice " + json.dumps(row))
        check(rel_a <= LATTICE_RTOL and rel_b <= LATTICE_RTOL,
              f"lattice U+1={U + 1}: alpha rel err {rel_a}, beta {rel_b}")
        check(unreach_a and unreach_b,
              f"lattice U+1={U + 1}: an unreachable cell above -1e29")
        check(err_occ <= OCC_ATOL and loss_rel <= LOSS_RTOL,
              f"lattice U+1={U + 1}: occupancy err {err_occ}, loss rel "
              f"err {loss_rel}")
        check(not got_b[1][1].any() and not got_b[2][1].any(),
              "lattice_beta: the zero-frame row has occupancies")
        rows[U] = row
    return {"rows": rows, "main": rows[TRAIN_U],
            "worst_alpha": max(r["alpha_max_abs_err"] for r in rows.values()),
            "worst_beta": max(r["beta_max_abs_err"] for r in rows.values())}


def lattice_tiles_vs_plain(rng: np.random.Generator, dev) -> None:
    """Phase 4g: lattice_alpha and lattice_beta (with the occupancies) on
    diagonals longer than one walk plan takes, in column tiles
    (`tile_plan`), against their plain versions: B=3 (a full row, a
    zero-frame row, a label-less row), T'=40, U+1 of LATTICE_TILE_U. Run
    last: the plain versions' diagonal loops leave the card nearly idle
    for tens of seconds, and a torch.profiler window after such a stretch
    misplaces its kernels, so no profiled check may follow."""
    for U in LATTICE_TILE_U:
        lpb, lpy, fl, ll = lattice_scores(rng, dev, 3, 40, U)
        lpb_m, lpy_m = rl._masked_transitions(lpb, lpy, fl, ll)
        accept = rl._accept_scores(lpb, fl, ll)
        a_args = (lpb_m, lpy_m)
        # the plain versions' loops take seconds: timed on their one run
        want_a, alpha_plain_ms = cuda_ms_out(
            lambda: lat.alpha_wavefront_reference(*a_args))
        got_a = lat.alpha_wavefront(*a_args)
        b_args = (lpb_m, lpy_m, accept, want_a, fl)
        want_b, beta_plain_ms = cuda_ms_out(
            lambda: lat.beta_occupancies_reference(*b_args))
        got_b = lat.beta_occupancies(*b_args)
        err_a, rel_a, unreach_a = lattice_err(got_a, want_a)
        err_b, rel_b, unreach_b = lattice_err(got_b[0], want_b[0])
        err_occ = max(max_abs(got_b[1], want_b[1]),
                      max_abs(got_b[2], want_b[2]))
        row = {"B": 3, "T": 40, "U1": U + 1,
               "tiles": {k: [(t.u0, t.width, t.edge)
                             for t in lat.tile_plan(U + 1, beta)]
                         for k, beta in (("alpha", False), ("beta", True))},
               "alpha_max_abs_err": err_a, "alpha_rel_err": rel_a,
               "beta_max_abs_err": err_b, "beta_rel_err": rel_b,
               "occ_max_abs_err": err_occ,
               "alpha_ms": cuda_ms(lambda: lat.alpha_wavefront(*a_args)),
               "beta_ms": cuda_ms(lambda: lat.beta_occupancies(*b_args)),
               "alpha_plain_ms": alpha_plain_ms,
               "beta_plain_ms": beta_plain_ms}
        print("kernel lattice_tiles " + json.dumps(row))
        check(rel_a <= LATTICE_RTOL and rel_b <= LATTICE_RTOL
              and unreach_a and unreach_b and err_occ <= OCC_ATOL,
              f"lattice in column tiles, U+1={U + 1}: alpha rel err "
              f"{rel_a}, beta {rel_b}, occupancies {err_occ}")
        check(float(got_b[0][0, 0, 0]) > -1e29,
              f"lattice in column tiles, U+1={U + 1}: log Z unreachable")


def loss_rows_vs_plain(rng: np.random.Generator, dev) -> dict:
    """extract_lp and assemble_grad against their plain versions at the
    two-pass step's logits, (32, 200, 81, 1024) in f32 and bf16, with the
    occupancies of the real lattice scaled by the batch mean's 1/B."""
    B, T, U, V = TRAIN_B, TRAIN_T // 2, PALLAS_U, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    x32 = 2.0 * torch.randn(B, T, U + 1, V, generator=gen, device=dev)
    labels = torch.randint(1, V, (B, U), generator=gen, device=dev,
                           dtype=torch.int32)
    fl, ll = ragged_lengths(rng, dev, B, T, U)
    gb, gy = rl.occupancies_from_lp(*lc.extract_lp_reference(x32, labels),
                                    fl, ll)
    occ, gb, gy = ((gb + gy) / B, gb / B, gy / B)
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        x = x32.to(cd)
        want = lc.extract_lp_reference(x, labels)
        got = lc.extract_lp(x, labels)
        live = [w > -1e29 for w in want]
        rel_x = max(rel_err(g[m], w[m]) for g, w, m in zip(got, want, live))
        err_x = max(max_abs(g[m], w[m]) for g, w, m in zip(got, want, live))
        same_dead = all(torch.equal(g[~m], w[~m])
                        for g, w, m in zip(got, want, live))
        g_args = (x, labels, occ, gb, gy)
        want_g = lc.assemble_grad_reference(*g_args)
        got_g = lc.assemble_grad(*g_args)
        torch.cuda.synchronize()
        rel_g = rel_err(got_g.float(), want_g.float())
        err_g = max_abs(got_g.float(), want_g.float())
        finite = bool(torch.isfinite(got_g).all())
        # max, exp and sum per logit; the gradient one exp, two products
        bounds = {"extract_bound": bound(nbytes(x, labels, got),
                                         4 * x.numel(), torch.float32),
                  "grad_bound": bound(nbytes(g_args, got_g), 5 * x.numel(),
                                      torch.float32)}
        del want_g, got_g
        kx, px = timed_pair(lambda: lc.extract_lp(x, labels),
                            lambda: lc.extract_lp_reference(x, labels))
        kg, pg = timed_pair(lambda: lc.assemble_grad(*g_args),
                            lambda: lc.assemble_grad_reference(*g_args))
        row = {"B": B, "T": T, "U1": U + 1, "V": V,
               "dtype": str(cd).replace("torch.", ""),
               "extract_max_abs_err": err_x, "extract_rel_err": rel_x,
               "grad_max_abs_err": err_g, "grad_rel_err": rel_g,
               "rtol": REL_TOL[cd], "extract_kernel_ms": kx,
               "extract_plain_ms": px, "grad_kernel_ms": kg,
               "grad_plain_ms": pg, **bounds}
        print("kernel loss_rows " + json.dumps(row))
        check(rel_x <= REL_TOL[cd] and rel_g <= REL_TOL[cd] and finite,
              f"loss rows {cd}: extract rel err {rel_x}, grad rel err "
              f"{rel_g}, or a non-finite gradient")
        check(same_dead, f"extract_lp {cd}: lp_y at u = U is not NEG_INF")
        out[cd] = row
        del x
    return {"rows": out, "main": out[torch.float32],
            "worst_extract": max(r["extract_max_abs_err"]
                                 for r in out.values()),
            "worst_grad": max(r["grad_max_abs_err"] for r in out.values())}


def int8_plan_row(B: int, H: int, dev) -> list:
    """K7's launches on this card: each group's rows and tile (grid,
    units and rows a block, shared bytes, stage passes a step)."""
    return [{"rows": [b0, b1], "grid": plan.grid, "units": plan.units,
             "block_rows": plan.rows, "smem_bytes": plan.smem_bytes,
             "passes": plan.passes}
            for b0, b1, plan in q8.device_groups(B, H, dev)]


def kernel_launches(call, fragment: str) -> dict:
    """The device kernels of one call(), by torch.profiler: launches by
    name, of those whose name holds `fragment`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_profiler_window()
        call()
        torch.cuda.synchronize()
        pad_profiler_window()
    counts = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and fragment in evt.key:
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    return counts


def lstm_int8_vs_plain(rng: np.random.Generator, dev) -> dict:
    """lstm_fwd_q (K7) against its plain version: the libri100 serving
    layers at the 800-frame bucket and batch tiles of 32 and 16 rows, in
    f32 and bf16, on int8 weights from quantize_tensor; two runs giving
    identical bits, one lstm_q_persistent_kernel a call by the profiler
    and no other kernel of lstm_fwd_q.cu, the tile, and at the serving
    shape a line through K7's time against T (µs a step, the fixed cost
    of a call)."""
    H = 512
    rows, worst, main = [], 0.0, None
    for name, B, T, I, with_state in INT8_CASES:
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
        for cd in (torch.float32, torch.bfloat16):
            x_proj = (_dot(x, w_ih, cd) + b).to(cd).contiguous()
            args = (x_proj, qw.q, qw.scale, h0, c0)
            want = q8.lstm_recurrence_int8_reference(*args)
            got = q8.lstm_recurrence_int8(*args)
            again = q8.lstm_recurrence_int8(*args)
            torch.cuda.synchronize()
            err = max(max_abs(got[0], want[0]), max_abs(got[1][1], want[1][1]))
            same_bits = (torch.equal(got[0], again[0])
                         and torch.equal(got[1][1], again[1][1]))
            kernels = kernel_launches(lambda: q8.lstm_recurrence_int8(*args),
                                      "lstm_q")
            plan = int8_plan_row(B, H, dev)
            kt, pt = timed_pair(lambda: q8.lstm_recurrence_int8(*args),
                                lambda: q8.lstm_recurrence_int8_reference(
                                    *args))
            row = {"case": name, "B": B, "T": T, "I": I, "H": H,
                   "batch_tile": q8.batch_tile(B, H),
                   "dtype": str(cd).replace("torch.", ""),
                   "max_abs_err": err, "atol": ATOL[cd], "kernel_ms": kt,
                   "plain_ms": pt, "bitwise_repeat": same_bits,
                   "kernels": kernels, "plan": plan,
                   **bound(nbytes(args, got[0], got[1][1]),
                           2 * B * T * H * 4 * H, torch.int8)}
            if name == INT8_MAIN[0]:
                row["step_fit"] = step_fit(device_ms, dev, cd, B, H,
                                           int8=True)
            print("kernel lstm_int8 " + json.dumps(row))
            check(bool(torch.isfinite(got[0]).all()) and err <= ATOL[cd],
                  f"lstm_int8 {name} {cd}: max abs err {err} > {ATOL[cd]} "
                  "or non-finite output")
            check(same_bits, f"lstm_int8 {name} {cd}: two runs gave "
                             "different bits")
            check(bool(kernels) and all("lstm_q_persistent_kernel" in k
                                        for k in kernels)
                  and sum(kernels.values()) == len(plan),
                  f"lstm_int8 {name} {cd}: a call ran {kernels}, not one "
                  f"lstm_q_persistent_kernel for each of its {len(plan)} "
                  "groups")
            rows.append(row)
            worst = max(worst, err)
            if (name, cd) == INT8_MAIN:
                main = row
    return {"rows": rows, "max_abs_err": worst, "main": main}


K9_KERNELS = ("greedy_pack_kernel", "greedy_cluster_kernel")


def sha(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes: its bits,
    to compare checkouts run on the same inputs."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def greedy_fused_vs_plain(serving: dict, dev) -> dict:
    """greedy_fused (K9) against its plain version on one served batch (the
    first max_batch utterances at the 800-frame bucket, max_symbols 100),
    in f32 (identical tokens and steps) and bf16 (agreement reported), and
    the lock-step greedy_decode on the same encoder output. A call is two
    launches, the weights' pack and the cluster kernel, named and timed by
    torch.profiler; with its cluster plan, the clusters the card holds at
    once, `max_steps` (the longest row's loop), `us_per_step` (the cluster
    kernel's device time over it) and the sha256 digests of tokens and
    steps."""
    cfg, params = serving["cfg"], serving["params"]
    feats, lens = served_batch(serving, dev)
    rows = {}
    for cd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        with torch.inference_mode():
            enc, enc_lens = m.encode(params, c, feats, lens)
            f, flens, weights = gf.fused_inputs(params, c, enc, enc_lens)
            args = (f, flens, weights, MAX_SYMBOLS, cfg.blank, c.cdtype)
            got = gf.greedy_fused_tokens(*args)
            want = gf.greedy_fused_tokens_reference(*args)
            torch.cuda.synchronize()
            kt, pt = timed_pair(lambda: gf.greedy_fused_tokens(*args),
                                lambda: gf.greedy_fused_tokens_reference(
                                    *args))
            by_name = kernel_ms_by_name(
                lambda: gf.greedy_fused_tokens(*args), K9_KERNELS)
            dev_ms = device_ms(lambda: gf.greedy_fused_tokens(*args), reps=5)
            lockstep = statistics.mean(
                cuda_ms(lambda: greedy_decode(params, c, enc, enc_lens,
                                              MAX_SYMBOLS)) for _ in range(2))
        E, H = weights[0].shape[1], weights[2].shape[0]
        J, V = f.shape[2], weights[0].shape[0]
        plan = gf.cluster_plan(E, H, J, V)
        n_tok = int((got[0] != cfg.blank).sum())
        n_steps = int(got[1].sum())
        max_steps = int(got[1].max())
        # each step the joint's output product; each emission (and the
        # start symbol) the predictor cell and its projection
        ops = (2 * n_steps * J * V
               + 2 * (n_tok + f.shape[0]) * ((E + H) * 4 * H + H * J))
        row = {"dtype": cd, "B": f.shape[0], "T": f.shape[1], "J": J,
               "V": V, "max_symbols": MAX_SYMBOLS,
               "plan": {"C": plan.C, "wo_resident": plan.wo_resident,
                        "wp_resident": plan.wp_resident,
                        "ring_slots": plan.slots,
                        "slot_bytes": plan.slot_bytes,
                        "smem_bytes": plan.smem_bytes},
               "clusters_at_once": gf.device_clusters(plan, dev),
               "tokens_identical": torch.equal(got[0], want[0]),
               "steps_identical": torch.equal(got[1], want[1]),
               "row_agreement": float((got[0] == want[0]).all(1).float()
                                      .mean()),
               "max_abs_err": float((got[0] - want[0]).abs().max()),
               "tokens": n_tok, "steps": n_steps, "max_steps": max_steps,
               "kernel_ms": kt, "device_ms": dev_ms, "kernels": by_name,
               "us_per_step": by_name["greedy_cluster_kernel"] * 1e3
               / max(max_steps, 1),
               "plain_ms": pt, "lockstep_ms": lockstep,
               "digest": {"tokens": sha(got[0]), "steps": sha(got[1])},
               **bound(nbytes(args[:3], got), ops, torch.float32)}
        print("kernel greedy_fused " + json.dumps(row))
        if cd == "float32":
            check(row["tokens_identical"] and row["steps_identical"],
                  "greedy_fused f32: tokens or steps differ from the plain "
                  "version")
        check(all(by_name[k] > 0 for k in K9_KERNELS),
              f"greedy_fused {cd}: the profiler saw {by_name}, not the pack "
              "and the cluster kernel")
        rows[cd] = row
    return {"rows": rows, "main": rows["bfloat16"],
            "max_abs_err": rows["float32"]["max_abs_err"]}


def cycled(fn, n: int):
    """A call of fn(i) for i = 0, 1, ..., n-1, 0, 1, ... in turn."""
    count = itertools.count()
    return lambda: fn(next(count) % n)


def mean_ms(fn, reps: int = 20) -> float:
    """CUDA-event ms of one call, over `reps` calls back to back: the
    host's enqueue included where it is slower than the device."""
    return cuda_ms(lambda: [fn() for _ in range(reps)]) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device ms of one call: the `reps` calls are queued behind a spin
    kernel of ~0.1 s (longer than their enqueue), so the events bracket
    the device's work alone."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_ln_vs_plain(rng: np.random.Generator, dev) -> dict:
    """fused_ln_fwd and fused_ln_bwd (K8) against the plain LayerNorm
    (`layer_norm_reference`) and its autograd at the conformer's rows, act
    none and silu; dg and db identical over two runs. Times: the device's
    ms per call (`device_ms`) and the ms per call with the host's enqueue
    (`mean_ms`, "call"), 20 calls each, in turns plain, kernel, kernel,
    plain. Library:
    F.layer_norm and its backward (one native_layer_norm_backward gives
    dx, dg and db); silu has no single PyTorch call."""
    D = LN_D
    rows, main = [], None
    worst = {"fwd": 0.0, "bwd": 0.0}
    for case, N in LN_CASES:
        x = torch.from_numpy(3 * rng.normal(size=(N, D)) + 1).float().to(dev)
        g = torch.from_numpy(1 + 0.5 * rng.normal(size=D)).float().to(dev)
        b = torch.from_numpy(0.5 * rng.normal(size=D)).float().to(dev)
        dy = torch.from_numpy(rng.normal(size=(N, D))).float().to(dev)
        for act in fl.ACTS:
            y, mu, rstd = fl.fln_fwd(x, g, b, act)
            bwd_args = (x, g, b, mu, rstd, dy, act)
            got = fl.fln_bwd(*bwd_args)
            again = fl.fln_bwd(*bwd_args)
            leaves_ = [a.clone().requires_grad_(True) for a in (x, g, b)]
            ref = fl.layer_norm_reference(*leaves_, act)
            want = torch.autograd.grad(ref, leaves_, dy)
            torch.cuda.synchronize()
            err_y = max_abs(y, ref.detach())
            err_b = max(max_abs(a, e) for a, e in zip(got, want))
            rel = {n: rel_err(a, e) for n, a, e in zip(("dx", "dg", "db"),
                                                       got, want)}
            same_bits = all(torch.equal(a, e) for a, e in zip(again, got))
            finite = all(bool(torch.isfinite(a).all()) for a in (y, *got))

            # Device times read their inputs from device memory, not L2:
            # the calls cycle through copies of x and dy (with a graph
            # each for the autograd backwards) three times the L2's size.
            n_cp = max(2, -(-3 * L2_BYTES // nbytes(x)))
            xs = [x.clone() for _ in range(n_cp)]
            dys = [dy.clone() for _ in range(n_cp)]

            def graphs(fn):
                out = []
                for xc in xs:
                    lv = [a.clone().requires_grad_(True) for a in (xc, g, b)]
                    out.append((fn(*lv), lv))
                return out

            def autograd_bwd(gr):
                return lambda i: torch.autograd.grad(gr[i][0], gr[i][1],
                                                     dys[i],
                                                     retain_graph=True)

            ref_graphs = graphs(lambda *a: fl.layer_norm_reference(*a, act))
            fns = {"kernel": (
                       lambda i: fl.fln_fwd(xs[i], g, b, act),
                       lambda i: fl.fln_bwd(xs[i], g, b, mu, rstd, dys[i],
                                            act)),
                   "plain": (
                       lambda i: fl.layer_norm_reference(xs[i], g, b, act),
                       autograd_bwd(ref_graphs))}
            times = {}
            for which in ("plain", "kernel", "kernel", "plain"):
                fwd, bwd = fns[which]
                times.setdefault(which, []).append(
                    (device_ms(cycled(fwd, n_cp)),
                     device_ms(cycled(bwd, n_cp))))
            k_f, k_b = (statistics.mean(t[i] for t in times["kernel"])
                        for i in (0, 1))
            p_f, p_b = (statistics.mean(t[i] for t in times["plain"])
                        for i in (0, 1))
            # with the host's enqueue, back to back on one input
            kc_f, kc_b, pc_f, pc_b = (mean_ms(cycled(fn, 1)) for fn in
                                      (*fns["kernel"], *fns["plain"]))
            lib_f = lib_b = None
            if act == "none":
                lib_graphs = graphs(lambda *a: torch.nn.functional.layer_norm(
                    a[0], (D,), a[1], a[2], fl.EPS))
                lib_f = device_ms(cycled(
                    lambda i: torch.nn.functional.layer_norm(
                        xs[i], (D,), g, b, fl.EPS), n_cp))
                lib_b = device_ms(cycled(autograd_bwd(lib_graphs), n_cp))
                del lib_graphs
            del xs, dys, ref_graphs
            silu = act == "silu"
            row = {"case": case, "N": N, "D": D, "act": act,
                   "y_max_abs_err": err_y, "y_atol": LN_Y_ATOL,
                   "bwd_max_abs_err": err_b, "bwd_rel_err": rel,
                   "dx_rtol": LN_DX_RTOL, "dg_db_rtol": LN_DGB_RTOL,
                   "bwd_bitwise_repeat": same_bits,
                   "fwd_kernel_ms": k_f, "fwd_plain_ms": p_f,
                   "fwd_library_ms": lib_f, "bwd_kernel_ms": k_b,
                   "bwd_plain_ms": p_b, "bwd_library_ms": lib_b,
                   "fwd_kernel_call_ms": kc_f, "fwd_plain_call_ms": pc_f,
                   "bwd_kernel_call_ms": kc_b, "bwd_plain_call_ms": pc_b,
                   "bwd_blocks": fl.bwd_blocks(N),
                   "bwd_blocks_per_sm": fl.device_bwd_occupancy(D, dev),
                   # per element: centre, square, sum, scale, g, b (+ the
                   # sigmoid and product of silu); the backward twice that
                   "fwd_bound": bound(nbytes(x, g, b, y, mu, rstd),
                                      (12 if silu else 8) * N * D,
                                      torch.float32),
                   "bwd_bound": bound(nbytes(bwd_args[:6], got),
                                      (22 if silu else 14) * N * D,
                                      torch.float32)}
            print("kernel fused_ln " + json.dumps(row))
            check(finite and err_y <= LN_Y_ATOL
                  and rel["dx"] <= LN_DX_RTOL
                  and max(rel["dg"], rel["db"]) <= LN_DGB_RTOL,
                  f"fused_ln {case} {act}: y err {err_y}, bwd rel err {rel} "
                  "or a non-finite output")
            check(same_bits, f"fused_ln_bwd {case} {act}: two runs gave "
                             "different bits")
            rows.append(row)
            worst["fwd"] = max(worst["fwd"], err_y)
            worst["bwd"] = max(worst["bwd"], err_b)
            if (case, act) == LN_MAIN:
                main = row
    return {"rows": rows, "main": main, "worst": worst}


def event_split_ms(call, n_events: int, reps: int = 5) -> list[float]:
    """Mean device ms between consecutive events of call(i, events), each
    call recording `n_events` CUDA events between its launches, the `reps`
    calls queued behind a spin kernel as in device_ms."""
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(n_events)]
           for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for i, ev in enumerate(evs):
        call(i, ev)
    torch.cuda.synchronize()
    return [statistics.mean(e[k].elapsed_time(e[k + 1]) for e in evs)
            for k in range(n_events - 1)]


def kernel_ms_by_name(call, names, reps: int = 3) -> dict:
    """Device ms a call of the kernels whose names hold each of `names`,
    by torch.profiler over `reps` calls after a warm one, the window
    padded at both ends (pad_profiler_window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_profiler_window()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        pad_profiler_window()
    ms = {n: 0.0 for n in names}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if n in evt.key:
                ms[n] += getattr(evt, "self_device_time_total", getattr(
                    evt, "self_cuda_time_total", 0)) / 1e3 / reps
    return ms


def band_split_ms(call, n: int, reps: int = 5) -> tuple[float, float]:
    """Device ms of a band call's first pass (band_lp_fwd's and
    band_lp_bwd_a's W^T pass, band_lp_bwd_b's zb pass) and of its main
    launch (with the ordered sums), each call(i, events) on copy i % n
    recording three CUDA events around its two launches."""
    first_ms, main_ms = event_split_ms(lambda i, ev: call(i % n, ev), 3,
                                       reps)
    return first_ms, main_ms


def band_fused_vs_plain(rng: np.random.Generator, dev) -> dict:
    """band_fwd, band_bwd_a and band_bwd_b (K6) against their plain versions
    at the pruned step's band, B=32, T'=200, S=8, J=512, V=8192, in f32 and
    bf16; lp_blank, lp_y, base, df, dg_w, dW and db identical over two
    runs. Times as
    fused_ln_vs_plain:
    device ms per call behind a spin kernel, the calls cycling through
    copies of g_w (105 MB, twice the L2 alone) three times the L2's size,
    in turns plain, kernel, kernel, plain. No single PyTorch call computes
    the band joint with its log-softmax picks: library_ms is null, and the
    full lattice's K1 / K2 at the same batch (the train_pruned phase) is
    the comparison."""
    B, T, S, J, V = TRAIN_B, TRAIN_T // 2, PRUNED_S, 512, PRUNED_V
    k = 1.0 / np.sqrt(J)
    f = torch.from_numpy(0.5 * rng.normal(size=(B, T, J))).float().to(dev)
    g_w = torch.from_numpy(0.5 * rng.normal(size=(B, T, S, J))).float().to(
        dev)
    w32 = torch.from_numpy(rng.uniform(-k, k, (J, V))).float().to(dev)
    b = torch.from_numpy(rng.uniform(-k, k, V)).float().to(dev)
    lab_w = torch.from_numpy(rng.integers(1, V, (B, T, S))).int().to(dev)
    lab_w[:, :, -1] = 0  # the last row of a band at u = U: the blank id
    # the loss's cotangents: minus the batch mean's share of occupancies
    cb = torch.from_numpy(-rng.uniform(0, 1, (B, T, S)) / B).float().to(dev)
    cy = torch.from_numpy(-rng.uniform(0, 1, (B, T, S)) / B).float().to(dev)
    n_cp = max(2, -(-3 * L2_BYTES // nbytes(g_w)))
    gws = [g_w.clone() for _ in range(n_cp)]
    N = B * T * S
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        w = w32.to(cd).contiguous()
        fwd_args = (f, g_w, lab_w, w, b)
        want = bf.band_lp_fwd_reference(*fwd_args)
        got = bf.band_lp_fwd(*fwd_args)
        again_f = bf.band_lp_fwd(*fwd_args)
        bwd_args = (f, g_w, lab_w, w, b, want[2], cb, cy)
        got_a = bf.band_lp_bwd_a(*bwd_args)
        again_a = bf.band_lp_bwd_a(*bwd_args)
        got_b = bf.band_lp_bwd_b(*bwd_args)
        again = bf.band_lp_bwd_b(*bwd_args)
        want_a = bf.band_lp_bwd_a_reference(*bwd_args)
        want_b = bf.band_lp_bwd_b_reference(*bwd_args)
        torch.cuda.synchronize()
        err_f = max(max_abs(x, y) for x, y in zip(got, want))
        err_a = max(max_abs(x, y) for x, y in zip(got_a, want_a))
        err_b = max(max_abs(x, y) for x, y in zip(got_b, want_b))
        rel = {n: rel_err(x, y) for n, x, y in
               zip(("df", "dg_w", "dw", "db"), got_a + got_b,
                   want_a + want_b)}
        same_bits = all(torch.equal(x, y) for x, y in zip(got_b, again))
        same_bits_a = all(torch.equal(x, y) for x, y in zip(got_a, again_a))
        same_bits_f = all(torch.equal(x, y) for x, y in zip(got, again_f))
        finite = all(bool(torch.isfinite(x).all())
                     for x in (*got, *got_a, *got_b))
        del want_a, want_b, again_f
        base = want[2]

        def call_args(kind, i):
            """The arguments of a forward or backward call on copy i."""
            a = (f, gws[i], lab_w, w, b)
            return a if kind == "fwd" else a + (base, cb, cy)

        calls = {"kernel": (bf.band_lp_fwd, bf.band_lp_bwd_a,
                            bf.band_lp_bwd_b),
                 "plain": (bf.band_lp_fwd_reference,
                           bf.band_lp_bwd_a_reference,
                           bf.band_lp_bwd_b_reference)}
        times = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            fw, ba, bb = calls[which]
            times.setdefault(which, []).append(tuple(
                device_ms(cycled(lambda i, c=c, kind=kind: c(
                    *call_args(kind, i)), n_cp), reps=5)
                for c, kind in ((fw, "fwd"), (ba, "bwd"), (bb, "bwd"))))
        kt = [statistics.mean(t[i] for t in times["kernel"]) for i in range(3)]
        pt = [statistics.mean(t[i] for t in times["plain"]) for i in range(3)]
        fwd_wt_ms, fwd_main_ms = band_split_ms(
            lambda i, ev: bf.band_lp_fwd(*call_args("fwd", i), events=ev),
            n_cp)
        wt_ms, a_main_ms = band_split_ms(
            lambda i, ev: bf.band_lp_bwd_a(*call_args("bwd", i), events=ev),
            n_cp)
        zb_ms, main_ms = band_split_ms(
            lambda i, ev: bf.band_lp_bwd_b(*call_args("bwd", i), events=ev),
            n_cp)
        ring = bf.tensor_core_form(cd, J, V)
        plan = bf.device_bwd_b_plan(N, J, V, dev) if ring else None
        layout = bf.device_bwd_a_layout(J, V, dev) if ring else None
        fwd_layout = bf.device_fwd_layout(J, V, dev) if ring else None
        ops = 2 * N * J * V  # one product over the band
        row = {"B": B, "T": T, "S": S, "J": J, "V": V, "rows": N,
               "dtype": str(cd).replace("torch.", ""),
               "fwd_max_abs_err": err_f, "fwd_atol": ATOL[cd],
               "bwd_a_max_abs_err": err_a, "bwd_b_max_abs_err": err_b,
               "bwd_rel_err": rel, "bwd_rtol": REL_TOL[cd],
               "fwd_bitwise_repeat": same_bits_f,
               "bwd_a_bitwise_repeat": same_bits_a,
               "bwd_b_bitwise_repeat": same_bits,
               "fwd_kernel_ms": kt[0], "fwd_plain_ms": pt[0],
               "bwd_a_kernel_ms": kt[1], "bwd_a_plain_ms": pt[1],
               "bwd_b_kernel_ms": kt[2], "bwd_b_plain_ms": pt[2],
               # the forward: its W^T pass and ring kernel apart (the
               # CUDA-core form: 0 and the kernel), its layout
               "fwd_wt_ms": fwd_wt_ms, "fwd_main_ms": fwd_main_ms,
               "fwd_prev_ms": (FWD_PREV_MS if cd == torch.bfloat16
                               else None),
               "fwd_wt_shape": (list(fwd_layout.wt_shape) if fwd_layout
                                else None),
               "fwd_smem_bytes": (fwd_layout.smem_bytes if fwd_layout
                                  else None),
               # kernel A: its W^T pass and main launch (with the df sum)
               # apart, the tensor-core form's scratch and shared bytes
               "bwd_a_wt_ms": wt_ms, "bwd_a_main_ms": a_main_ms,
               "bwd_a_prev_ms": (BWD_A_PREV_MS if cd == torch.bfloat16
                                 else None),
               "bwd_a_wt_shape": list(layout.wt_shape) if layout else None,
               "bwd_a_smem_bytes": layout.smem_bytes if layout else None,
               # kernel B: the tensor-core form's plan (the CUDA-core
               # form's splits for f32), its zb pass and main launch apart
               "bwd_b_v_tile": plan.v_tile if plan else bf.V_TILE_B,
               "bwd_b_splits": plan.splits if plan else bf.row_splits(V),
               "bwd_b_grid": list(plan.grid) if plan else None,
               "bwd_b_smem_bytes": plan.smem_bytes if plan else None,
               "bwd_b_zb_ms": zb_ms, "bwd_b_main_ms": main_ms,
               "bwd_b_prev_ms": (BWD_B_PREV_MS if cd == torch.bfloat16
                                 else None),
               # forward: the logits product; A: it again and dz; B: it
               # again and dW
               "fwd_bound": bound(nbytes(fwd_args, got), ops, cd),
               "bwd_a_bound": bound(nbytes(bwd_args, got_a), 2 * ops, cd),
               "bwd_b_bound": bound(nbytes(bwd_args, got_b), 2 * ops, cd)}
        print("kernel band_fused " + json.dumps(row))
        check(finite and err_f <= ATOL[cd] and max(rel.values()) <= REL_TOL[cd],
              f"band kernels {cd}: fwd err {err_f}, bwd rel err {rel}, or a "
              "non-finite output")
        check(same_bits_f, f"band_fwd {cd}: two runs gave different bits")
        check(same_bits_a, f"band_bwd_a {cd}: two runs gave different bits")
        check(same_bits, f"band_bwd_b {cd}: two runs gave different bits")
        out[cd] = row
        del got, got_a, again_a, got_b, again, want, base
        torch.cuda.empty_cache()
    del gws
    torch.cuda.empty_cache()
    return {"rows": out, "main": out[torch.bfloat16],
            "worst": {k: max(r[f"{k}_max_abs_err"] for r in out.values())
                      for k in ("fwd", "bwd_a", "bwd_b")}}


# ------------------------------ phase 4 ----------------------------------

def blank_offset(params, cfg, dev, rng, feats=None) -> float:
    """Blank-bias offset for the random model. Its joint logits barely
    depend on the frame (a random encoder's output is small), so the
    offset is set from the data: it leaves blank 0.1 below the best other
    token at the start symbol (median over frames), so each utterance
    emits a few tokens on its first frames and then walks the rest of its
    frames on blank. The 0.1 margin keeps the decisions clear of ties.
    The data: `feats` (4, T, D) where given, else N(0, 1) from `rng`."""
    if feats is None:
        feats = rng.normal(size=(4, 200, cfg.input_dim))
    feats = torch.as_tensor(feats).float().to(dev)
    lens = torch.full((4,), feats.shape[1], dtype=torch.int32, device=dev)
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
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx, torch.inference_mode():
        enc, _ = m.encode(params, cfg, feats, lens)
        tok, n = recognize_greedy(params, cfg, feats, lens, MAX_SYMBOLS)
    return enc, [tok[b, :n[b]].tolist() for b in range(len(n))]


def serving_setup(seed: int, n_requests: int, dev, cfg=None,
                  frames=(150, 800)) -> dict:
    """The served model (libri100 unless `cfg` is given, random weights
    from the seed, the blank offset of `blank_offset`) and the requests'
    utterances, of `frames` frames (the first two at its ends)."""
    rng = np.random.default_rng(seed)
    cfg = cfg or config_libri100()
    params = m.init_params(cfg, rng, dev)
    offset = blank_offset(params, cfg, dev, rng)
    params["joint"]["out"]["b"][cfg.blank] += offset
    lengths = rng.integers(frames[0], frames[1] + 1, size=n_requests)
    lengths[:2] = frames
    utts = [rng.normal(size=(int(T), cfg.input_dim)).astype(np.float32)
            for T in lengths]
    return {"cfg": cfg, "params": params, "offset": offset,
            "lengths": lengths, "utts": utts}


def served_batch(serving: dict, dev, tb: int = BUCKETS[-1]):
    """The first max_batch utterances padded to the bucket of tb frames
    (the largest by default), as the engine pads a batch of them: feats
    (8, tb, 80) and lengths."""
    B = min(MAX_BATCH, len(serving["utts"]))
    feats = np.zeros((B, tb, serving["cfg"].input_dim), np.float32)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        feats[i, :serving["lengths"][i]] = serving["utts"][i]
        lens[i] = serving["lengths"][i]
    return torch.from_numpy(feats).to(dev), torch.from_numpy(lens).to(dev)


def serve_all(serving: dict, params, dev) -> tuple[list, dict, dict]:
    """Every request through a BatchingEngine holding `params`, behind
    http_server: the answers, the engine's stats and the launch counts of
    the served requests alone (the warm-up excluded)."""
    cfg = serving["cfg"]
    engine = BatchingEngine(params, cfg, max_symbols=MAX_SYMBOLS,
                            frame_buckets=BUCKETS, max_batch=MAX_BATCH,
                            window_ms=WINDOW_MS, device=dev)
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        answers = serve_requests(engine, serving["utts"])
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        stats = engine.stats.summary()
    finally:
        engine.close()

    codes = [a[0] for a in answers]
    check(all(c == 200 for c in codes), f"HTTP codes {codes}")
    for (_, out, _), T in zip(answers, serving["lengths"]):
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
    lat = sorted(a[2] * 1e3 for a in answers)
    tokens = [len(a[1]["tokens"]) for a in answers]
    result = {"requests": len(answers),
              "http_codes": {str(c): codes.count(c) for c in set(codes)},
              "warmup_s": warmup_s,
              "wall_s": wall_s, "req_per_s": len(answers) / wall_s,
              "mean_batch": stats["mean_batch"],
              "batches": stats["batches"],
              "p50_ms": lat[len(lat) // 2],
              "p95_ms": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
              "mean_tokens": statistics.mean(tokens),
              "blank_offset": serving["offset"]}
    return answers, result, counts


def kernel_vs_plain_tokens(params, cfg, feats, lens, what: str) -> dict:
    """recognize_greedy on one batch through the kernels and through the
    plain versions, in f32 (identical tokens required) and bf16."""
    B = feats.shape[0]
    out = {}
    for cd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        enc_k, tok_k = decode_batch(params, c, feats, lens, plain=False)
        enc_p, tok_p = decode_batch(params, c, feats, lens, plain=True)
        agree = sum(a == b for a, b in zip(tok_k, tok_p)) / B
        row = {"params": what, "dtype": cd, "enc_max_abs_err": float(
            (enc_k - enc_p).abs().max()), "token_agreement": agree,
            "tokens_per_utt": [len(t) for t in tok_k]}
        print("kernel_vs_plain_decode " + json.dumps(row))
        if cd == "float32":
            check(tok_k == tok_p, f"f32 tokens ({what} params) differ "
                                  "between the kernel path and the plain path")
            check(row["enc_max_abs_err"] <= ATOL[torch.float32],
                  f"f32 encoder output ({what} params) differs between "
                  "kernel and plain")
            out["enc_f32"] = enc_k
        out[cd] = row
    return out


def end_to_end(serving: dict, dev) -> dict:
    cfg, params = serving["cfg"], serving["params"]
    answers, result, counts = serve_all(serving, params, dev)
    launches = counts["lstm_fwd"]
    result["launches"] = launches
    check(launches > 0, "the served path never launched lstm_fwd")
    check_no_band(counts, "serving")
    print("e2e " + json.dumps(result))

    # One batch of the served utterances: kernel path vs plain path.
    feats_d, lens_d = served_batch(serving, dev)
    enc_f32 = kernel_vs_plain_tokens(params, cfg, feats_d, lens_d,
                                     "float")["enc_f32"]

    # The kernel path on the card against the port on the CPU (plain
    # recurrence, another matmul library), two utterances, f32.
    c = dataclasses.replace(cfg, compute_dtype="float32")
    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    enc_cpu, _ = m.encode(cpu_params, c, feats_d[:2].cpu(), lens_d[:2].cpu())
    err = float((enc_cpu - enc_f32[:2].cpu()).abs().max())
    print(f"cpu_reference enc_max_abs_err {err}")
    check(err <= ATOL[torch.float32], f"card vs CPU encoder output {err}")
    return result


def int8_serving(serving: dict, dev) -> dict:
    """Phase 4b: the same requests to an engine holding quantize_params
    (serve.py --quantize int8). At max_batch 8 every encoder layer takes
    the W8A8 route: lstm_fwd_q launches and lstm_fwd does not."""
    cfg = serving["cfg"]
    qparams = quantize_params(serving["params"])
    qb, fb = quantized_bytes(qparams)
    answers, result, counts = serve_all(serving, qparams, dev)
    result.update({"int8_mb": qb / 1e6, "fp32_mb": fb / 1e6,
                   "launches": counts["lstm_fwd_int8"],
                   "lstm_fwd_launches": counts["lstm_fwd"]})
    print("e2e_int8 " + json.dumps(result))
    check(counts["lstm_fwd_int8"] > 0,
          "the int8 engine never launched lstm_fwd_q")
    check(counts["lstm_fwd"] == 0,
          "the int8 engine launched lstm_fwd: an encoder layer took the "
          "dequantized route")
    check_no_band(counts, "int8 serving")
    feats_d, lens_d = served_batch(serving, dev)
    kernel_vs_plain_tokens(qparams, cfg, feats_d, lens_d, "int8")
    k7 = k7_calls(qparams, cfg, feats_d, lens_d)
    print("e2e_int8_k7 " + json.dumps(k7))
    check(len(k7) == cfg.enc_layers
          and all("lstm_q_persistent_kernel" in c["name"] for c in k7),
          f"a served int8 batch's encoder ran {k7}, not one "
          f"lstm_q_persistent_kernel for each of its {cfg.enc_layers} layers")
    result["qparams"] = qparams
    return result


def k7_calls(qparams, cfg, feats, lens) -> list:
    """The K7 kernels (those of lstm_fwd_q.cu) of one served int8 batch's
    encode at the served dtype, by torch.profiler, in order: name and
    device ms each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        m.encode(qparams, cfg, feats, lens)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_profiler_window()
            m.encode(qparams, cfg, feats, lens)
            torch.cuda.synchronize()
            pad_profiler_window()
    evts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "lstm_q" in e.name),
                  key=lambda e: e.time_range.start)
    return [{"name": e.name[:120], "ms": e.time_range.elapsed_us() / 1e3}
            for e in evts]


def host_ms(fn, repeats: int = 2) -> float:
    """Mean wall time of fn() ending in a synchronize."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.mean(times)


def fused_greedy(serving: dict, qparams, dev) -> dict:
    """Phase 4c: recognize_greedy_fused on the served batch with float and
    int8 params, against recognize_greedy on the same params: greedy_fused
    launched; f32 tokens identical; at bf16 (the served dtype) the two
    entry points timed, encoder included."""
    cfg = serving["cfg"]
    feats, lens = served_batch(serving, dev)
    rows, launches = [], 0
    for what, params in (("float", serving["params"]), ("int8", qparams)):
        for cd in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=cd)
            with torch.inference_mode():
                reset_counts()
                tok_f, n_f = gf.recognize_greedy_fused(params, c, feats, lens,
                                                       MAX_SYMBOLS)
                torch.cuda.synchronize()
                counts = read_counts()
                tok_g, n_g = recognize_greedy(params, c, feats, lens,
                                              MAX_SYMBOLS)
                row = {"params": what, "dtype": cd,
                       "greedy_fused_launches": counts["greedy_fused"],
                       "lstm_fwd_int8_launches": counts["lstm_fwd_int8"],
                       "lstm_fwd_launches": counts["lstm_fwd"],
                       "tokens_identical": torch.equal(tok_f, tok_g)
                       and torch.equal(n_f, n_g),
                       "row_agreement": float((tok_f == tok_g).all(1).float()
                                              .mean()),
                       "tokens_per_utt": n_f.tolist()}
                if cd == "bfloat16":
                    row["fused_ms"] = host_ms(lambda: gf.recognize_greedy_fused(
                        params, c, feats, lens, MAX_SYMBOLS))
                    row["lockstep_ms"] = host_ms(lambda: recognize_greedy(
                        params, c, feats, lens, MAX_SYMBOLS))
            print("fused_greedy " + json.dumps(row))
            check(counts["greedy_fused"] > 0,
                  f"recognize_greedy_fused ({what}, {cd}) never launched "
                  "greedy_fused")
            if what == "int8":
                check(counts["lstm_fwd_int8"] > 0 and counts["lstm_fwd"] == 0,
                      f"recognize_greedy_fused (int8, {cd}): the encoder did "
                      "not take the W8A8 route")
            if cd == "float32":
                check(row["tokens_identical"],
                      f"recognize_greedy_fused ({what}, f32): tokens differ "
                      "from recognize_greedy")
            launches += counts["greedy_fused"]
            rows.append(row)
    return {"rows": rows, "launches": launches}


# ------------------------------ phase 4f ---------------------------------

# Beam serving: the JAX engine's defaults (beam 8, 3 expansions a frame),
# with serve.py's max_symbols, max_batch and buckets.
BEAM, EXPANSIONS, BEAM_REQUESTS = 8, 3, 8
# Kernel path against plain path: live beams' scores within 1e-3; n-best
# lists may differ only at the K-th beam, where two hypotheses within 1e-4
# of each other can trade places (the near-tie rule of ROADMAP §3).
BEAM_SCORE_ATOL, BEAM_CUT_GAP = 1e-3, 1e-4
# The fusion LMs: tools/train_lm.py's defaults for the LSTM LM, and a
# transformer LM of d_model 256, 4 heads, 4 layers, max_len 512 (capped by
# beam_search at max_symbols + 1 = 101); their weights and the ILM's.
LM_WEIGHT, ILM_WEIGHT, NGRAM_WEIGHT = 0.3, 0.1, 0.3
BEAM_PROFILE_FRAMES = 25  # encoder frames of the profiled beam batch
# The beam phase's model (`beam_serving_setup`): the served model with the
# encoder side of its joint scaled BEAM_ENC_SCALE times, its logits
# BEAM_LOGIT_SCALE times, and the blank offset of `walking_offset` at
# BEAM_BLANK_SHARE, so that its rows emit along the utterance; every check
# of the phase needs a mean top-beam length of BEAM_MIN_TOKENS or more.
BEAM_ENC_SCALE, BEAM_LOGIT_SCALE, BEAM_BLANK_SHARE = 128.0, 16.0, 0.92
BEAM_MIN_TOKENS = 5


def beam_fusions(cfg, seed: int, dev) -> dict:
    """name -> recognize_beam keyword arguments of each fusion, built from
    the seed: an LSTM LM, the same with ILM subtraction, a transformer LM,
    a trigram from train_ngram on seeded token sequences and a context
    trie of 10 seeded phrases (f32 LMs; `lm_dtype` swaps their dtype)."""
    from rnn_transducer_tpu_torch.decode.context import build_context_bias
    from rnn_transducer_tpu_torch.models.lm import LMConfig, init_lm_params
    from rnn_transducer_tpu_torch.models.lm_transformer import \
        TransformerLMConfig
    from rnn_transducer_tpu_torch.models.ngram import train_ngram

    rng = np.random.default_rng(seed + 20)
    V = cfg.vocab_size
    lstm_cfg = LMConfig(vocab_size=V, embed_dim=128, hidden=256, layers=1)
    tr_cfg = TransformerLMConfig(vocab_size=V, d_model=256, heads=4,
                                 layers=4, max_len=512)
    lstm_p = init_lm_params(lstm_cfg, rng, dev)
    tr_p = init_lm_params(tr_cfg, rng, dev)
    seqs = [rng.integers(1, V, size=int(rng.integers(4, 13))).tolist()
            for _ in range(60)]
    phrases = [rng.integers(1, V, size=int(rng.integers(1, 4))).tolist()
               for _ in range(10)]
    return {"lstm_lm": {"lm": (lstm_p, lstm_cfg, LM_WEIGHT)},
            "ilm": {"lm": (lstm_p, lstm_cfg, LM_WEIGHT, ILM_WEIGHT)},
            "transformer_lm": {"lm": (tr_p, tr_cfg, LM_WEIGHT)},
            "ngram": {"ngram": (train_ngram(seqs, 3, V).to(dev),
                                NGRAM_WEIGHT)},
            "context": {"context": build_context_bias(
                phrases, V, blank=cfg.blank).to(dev)}}


def lm_dtype(fusion: dict, cd: str) -> dict:
    """The fusion with its LM's compute dtype set to cd."""
    if "lm" not in fusion:
        return fusion
    lm = fusion["lm"]
    return {"lm": (lm[0], dataclasses.replace(lm[1], compute_dtype=cd),
                   *lm[2:])}


def decode_beam(params, cfg, feats, lens, **fusion):
    """recognize_beam at the engine's settings -> numpy tokens, lengths,
    scores."""
    from rnn_transducer_tpu_torch.decode.beam import recognize_beam

    with torch.inference_mode():
        out = recognize_beam(params, cfg, feats, lens, beam=BEAM,
                             max_symbols=MAX_SYMBOLS, expansions=EXPANSIONS,
                             **fusion)
        return tuple(a.cpu().numpy() for a in out)


def decode_beam_pair(params, cfg, feats, lens, **fusion):
    """decode_beam through the kernels and through the plain versions in
    one search: the batch encoded both ways, the two encoder outputs'
    rows stacked into one beam_search (each row's beams are its own) ->
    (the kernel path's tokens, lengths, scores), (the plain path's)."""
    from rnn_transducer_tpu_torch.decode.beam import beam_search

    with torch.inference_mode():
        enc, el = m.encode(params, cfg, feats, lens)
        with plain_kernels():
            enc_p, _ = m.encode(params, cfg, feats, lens)
        out = beam_search(params, cfg, torch.cat([enc, enc_p]),
                          torch.cat([el, el]), beam=BEAM,
                          max_symbols=MAX_SYMBOLS, expansions=EXPANSIONS,
                          **fusion)[:3]
    B = feats.shape[0]
    out = [a.cpu().numpy() for a in out]
    return tuple(a[:B] for a in out), tuple(a[B:] for a in out)


def beams_agree(got, want, what: str) -> dict:
    """Kernel-path beams against plain-path beams: the same top beam on
    every row and the same n-best token lists, live beams' scores within
    BEAM_SCORE_ATOL; a list that differs only at the K-th beam passes if
    the two K-th scores lie within BEAM_CUT_GAP (reported)."""
    tok, n, sc = got
    tok_p, n_p, sc_p = want
    B, K = n.shape
    worst, cuts = 0.0, []
    for b in range(B):
        live, live_p = sc[b] > -5e29, sc_p[b] > -5e29
        lists = [tok[b, k, :n[b, k]].tolist() for k in range(K) if live[k]]
        lists_p = [tok_p[b, k, :n_p[b, k]].tolist() for k in range(K)
                   if live_p[k]]
        check(lists[:1] == lists_p[:1],
              f"beam {what}: row {b}'s top beam differs between the kernel "
              f"path and the plain path: {lists[:1]} vs {lists_p[:1]}")
        longest = max(len(lists), len(lists_p))
        same = next((k for k in range(longest) if k >= len(lists)
                     or k >= len(lists_p) or lists[k] != lists_p[k]),
                    longest)
        if same < longest:
            gap = float(abs(sc[b, same] - sc_p[b, same]))
            cuts.append({"row": b, "beam": same, "gap": gap})
            check(same == K - 1 and len(lists) == len(lists_p) == K
                  and gap < BEAM_CUT_GAP,
                  f"beam {what}: row {b}'s n-best differs at beam {same} "
                  f"(score gap {gap})")
        for k in range(same):
            worst = max(worst, float(abs(sc[b, k] - sc_p[b, k])))
    check(worst <= BEAM_SCORE_ATOL,
          f"beam {what}: live beam scores differ by {worst}")
    return {"max_score_err": worst, "cut_differences": cuts,
            "top_lengths": n[:, 0].tolist(),
            "live_beams": int((sc > -5e29).sum())}


def beam_profile(call) -> dict:
    """One call under torch.profiler: its wall ms, the CUDA kernels it
    launched and their summed device ms (the spin pads left out), and the
    six kernels that took the most device time (name, calls, ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_profiler_window()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pad_profiler_window()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name and "Memcpy" not in e.name
               and "Memset" not in e.name]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        calls, us = by_name.get(e.name[:80], (0, 0.0))
        by_name[e.name[:80]] = (calls + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_ms": wall_ms, "kernels": len(kernels),
            "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "top_kernels": [[name, calls, us / 1e3]
                            for name, (calls, us) in top]}


def beam_serving_setup(serving: dict, seed: int, dev) -> dict:
    """The served libri100 model made to emit along an utterance. Its
    random encoder's output is small (|h| ~0.01), so its joint barely sees
    the frame: with `blank_offset` a row emits 0-2 tokens on its first
    frames and walks the rest on blank, and a beam check would pass on
    nearly empty lists. The encoder side of the joint scaled
    BEAM_ENC_SCALE times makes the frame decide; the logits scaled
    BEAM_LOGIT_SCALE times make the winner's probability high (over 1024
    near-even classes a path that emits pays ~log(1/1024) a token and
    loses to one that does not, whatever the argmax); the blank offset of
    `walking_offset` lets blank win on BEAM_BLANK_SHARE of the (frame,
    state) pairs."""
    cfg, params = serving["cfg"], serving["params"]
    jp = params["joint"]
    out_b = jp["out"]["b"].clone()
    out_b[cfg.blank] -= serving["offset"]
    out_b *= BEAM_LOGIT_SCALE
    joint = {**jp, "enc_proj": {"w": jp["enc_proj"]["w"] * BEAM_ENC_SCALE,
                                "b": jp["enc_proj"]["b"]},
             "out": {"w": jp["out"]["w"] * BEAM_LOGIT_SCALE, "b": out_b}}
    params = {**params, "joint": joint}
    offset = walking_offset(params, cfg, dev, np.random.default_rng(seed + 30),
                            BEAM_BLANK_SHARE)
    out_b[cfg.blank] += offset
    return {**serving, "params": params, "offset": offset}


def beam_serving(serving: dict, dev) -> dict:
    """Phase 4f: beam search with prefix merging on the served libri100
    model made to emit (`beam_serving_setup`), its rows' top beams
    BEAM_MIN_TOKENS long or more on average. BatchingEngine(mode="beam")
    behind http_server answers
    BEAM_REQUESTS requests (4 K4-fwd launches a batch, no K9); a served
    batch (B=8, bucket 800) at f32 through the kernels and through the
    plain versions, with float and int8 params (4 K7 launches) and with
    each fusion; the bf16 batch's host ms at buckets
    400 and 800 (with a fusion, at 400) and ms a frame, and the launches a
    frame and the device's busy share of a profiled batch of its first
    frames."""
    seconds, t0 = {}, time.perf_counter()
    cfg, params = serving["cfg"], serving["params"]
    qparams = quantize_params(params)
    utts = serving["utts"][:BEAM_REQUESTS]
    lengths = serving["lengths"][:BEAM_REQUESTS]
    engine = BatchingEngine(params, cfg, mode="beam", beam=BEAM,
                            expansions=EXPANSIONS, max_symbols=MAX_SYMBOLS,
                            frame_buckets=BUCKETS, max_batch=MAX_BATCH,
                            window_ms=WINDOW_MS, device=dev)
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        answers = serve_requests(engine, utts)
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        stats = engine.stats.summary()
    finally:
        engine.close()
    codes = [a[0] for a in answers]
    check(all(c == 200 for c in codes), f"beam HTTP codes {codes}")
    for (_, out, _), T in zip(answers, lengths):
        n = len(out["tokens"])
        check(n == len(out["confidence"]) == len(out["frames"]) <= MAX_SYMBOLS,
              "beam result fields disagree in length")
        check(all(0 < k < cfg.vocab_size for k in out["tokens"]),
              "beam token outside the vocabulary or blank")
        check(all(np.isfinite(c) and c <= 1e-6 for c in out["confidence"]),
              "beam confidence is not a finite log-probability")
        check(all(0 <= f < T for f in out["frames"])
              and out["frames"] == sorted(out["frames"]),
              "beam frames out of order or past the utterance")
        scores = [h["score"] for h in out["nbest"]]
        check(1 <= len(out["nbest"]) <= BEAM and scores == sorted(
            scores, reverse=True) and out["nbest"][0]["tokens"]
            == out["tokens"] and np.isfinite(out["score"]),
            "beam n-best not best first, or not led by the answer")
    lat = sorted(a[2] * 1e3 for a in answers)
    result = {"requests": len(answers), "batches": stats["batches"],
              "mean_batch": stats["mean_batch"], "warmup_s": warmup_s,
              "wall_s": wall_s, "p50_ms": lat[len(lat) // 2],
              "stats": stats, "lstm_fwd_launches": counts["lstm_fwd"],
              "greedy_fused_launches": counts["greedy_fused"],
              "mean_tokens": statistics.mean(len(a[1]["tokens"])
                                             for a in answers),
              "mean_nbest": statistics.mean(len(a[1]["nbest"])
                                            for a in answers)}
    print("e2e_beam " + json.dumps(result))
    check(result["mean_tokens"] >= BEAM_MIN_TOKENS,
          f"beam serving: the answers hold {result['mean_tokens']} tokens "
          f"on average, fewer than {BEAM_MIN_TOKENS}")
    check(counts["lstm_fwd"] == cfg.enc_layers * stats["batches"],
          f"beam serving launched lstm_fwd {counts['lstm_fwd']} times in "
          f"{stats['batches']} batches, not {cfg.enc_layers} a batch")
    check(counts["greedy_fused"] == 0, "beam serving launched greedy_fused")
    check_no_band(counts, "beam serving")

    seconds["engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # One served batch at f32 (bucket 800): kernels against plain
    # versions, float, int8 and each fusion.
    feats, lens = served_batch(serving, dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    fusions = beam_fusions(cfg, 0, dev)
    rows = []
    for what, p, fusion in ([("float", params, {}), ("int8", qparams, {})]
                            + [(name, params, lm_dtype(f, "float32"))
                               for name, f in fusions.items()]):
        reset_counts()
        got, want = decode_beam_pair(p, f32, feats, lens, **fusion)
        counts = read_counts()
        row = {"what": what, "bucket": BUCKETS[-1],
               **beams_agree(got, want, what),
               "lstm_fwd_launches": counts["lstm_fwd"],
               "lstm_fwd_int8_launches": counts["lstm_fwd_int8"]}
        row["mean_top_length"] = statistics.mean(row["top_lengths"])
        print("beam_kernel_vs_plain " + json.dumps(row))
        check(row["mean_top_length"] >= BEAM_MIN_TOKENS,
              f"beam batch ({what}): top beams of {row['mean_top_length']} "
              f"tokens on average, fewer than {BEAM_MIN_TOKENS}")
        if what == "int8":
            check(counts["lstm_fwd_int8"] == cfg.enc_layers
                  and counts["lstm_fwd"] == 0,
                  f"int8 beam batch: {counts['lstm_fwd_int8']} K7 and "
                  f"{counts['lstm_fwd']} K4-fwd launches, not "
                  f"{cfg.enc_layers} and 0")
        else:
            check(counts["lstm_fwd"] == cfg.enc_layers,
                  f"beam batch ({what}): {counts['lstm_fwd']} K4-fwd "
                  f"launches, not {cfg.enc_layers}")
        rows.append(row)
    result["kernel_vs_plain"] = rows
    seconds["kernel_vs_plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # bf16 (the served dtype): host ms a batch at buckets 400 and 800 (a
    # fusion at 400 alone: its ms a frame hardly moves with the length,
    # and the script's time limit is shared); the launches a frame and the
    # device's busy share from a profiled batch of the first
    # PROFILE_FRAMES frames (a whole batch is 200-600 thousand kernels,
    # more than a profiler window should hold).
    timing = []
    for name, fusion in [("beam", {})] + list(fusions.items()):
        fusion = lm_dtype(fusion, "bfloat16")
        short = BEAM_PROFILE_FRAMES * cfg.time_reduction
        f, n = feats[:, :short], torch.clamp(lens, max=short)
        decode_beam(params, cfg, f, n, **fusion)  # warm
        if name in ("beam", "transformer_lm"):
            prof = beam_profile(
                lambda: decode_beam(params, cfg, f, n, **fusion))
            prof.update({"what": name, "profiled_frames": BEAM_PROFILE_FRAMES,
                         "launches_per_frame": prof["kernels"]
                         / BEAM_PROFILE_FRAMES})
            print("beam_profile " + json.dumps(prof))
        for tb in ((400, 800) if name == "beam" else (400,)):
            f, n = feats[:, :tb], torch.clamp(lens, max=tb)
            ms = host_ms(lambda: decode_beam(params, cfg, f, n, **fusion), 1)
            frames = tb // cfg.time_reduction
            row = {"what": name, "bucket": tb, "host_ms": ms,
                   "ms_per_frame": ms / frames}
            print("beam_timing " + json.dumps(row))
            timing.append(row)
    result["timing"] = timing
    seconds["timing"] = time.perf_counter() - t0
    print("beam_seconds " + json.dumps(seconds))
    return result


def walking_offset(params, cfg, dev, rng, blank_share: float = 0.7) -> float:
    """Blank-bias offset for the random conformer: blank wins on
    `blank_share` of the (frame, predictor state) pairs, the state being
    the start symbol's or the one after emitting the frame's best token;
    the 0.01 keeps the pair at the quantile off a tie. The median rule of
    `blank_offset` does not fit it: its joint logits vary with the frame
    far more than the LSTM's (every block ends in a LayerNorm)."""
    feats = torch.from_numpy(rng.normal(size=(4, BUCKETS[-1], cfg.input_dim))
                             ).float().to(dev)
    lens = torch.full((4,), BUCKETS[-1], dtype=torch.int32, device=dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        enc, _ = m.encode(params, f32, feats, lens)
        enc = enc.reshape(-1, enc.shape[-1])
        n = enc.shape[0]
        pred, state = m.predict_step(
            params, f32, torch.full((n,), cfg.blank, device=dev),
            m.init_pred_state(f32, n, dev))
        logits = [m.joint_step(params, f32, enc, pred)]
        best = logits[0].clone()
        best[:, cfg.blank] = float("-inf")
        pred, _ = m.predict_step(params, f32, best.argmax(dim=1), state)
        logits.append(m.joint_step(params, f32, enc, pred))
    gaps = []
    for lg in logits:
        others = torch.cat([lg[:, :cfg.blank], lg[:, cfg.blank + 1:]], 1)
        gaps.append(lg[:, cfg.blank] - others.max(dim=1).values)
    return float(-torch.quantile(torch.cat(gaps), 1.0 - blank_share)) + 0.01


def conformer_serving_setup(serving: dict, seed: int, dev,
                            cfg=None) -> dict:
    """libri100_conformer (or `cfg`, a config of its widths) with random
    weights from the seed, serving the libri100 engine's
    utterances. The predictor's side of the joint is
    scaled up 8x: at its random scale an emission barely moves the
    logits, so a frame that emits once emits up to max_symbols; scaled,
    an utterance emits a few tokens on some frames and walks all of them
    (with the blank offset of `walking_offset`)."""
    rng = np.random.default_rng(seed + 10)
    cfg = cfg or config_libri100_conformer()
    params = m.init_params(cfg, rng, dev)
    params["joint"]["pred_proj"]["w"] *= 8.0
    offset = walking_offset(params, cfg, dev, rng)
    params["joint"]["out"]["b"][cfg.blank] += offset
    return {**serving, "cfg": cfg, "params": params, "offset": offset}


def conformer_end_to_end(conf: dict, dev) -> dict:
    """Phase 4d: the requests to an engine on libri100_conformer. Every
    encode runs K8-fwd at each of its 48 LayerNorms and no LSTM kernel;
    the f32 tokens of one served batch are the same through the kernels
    and through the plain versions, and through recognize_greedy_fused
    (K9, which looks only at the predictor) and recognize_greedy."""
    cfg, params = conf["cfg"], conf["params"]
    _, result, counts = serve_all(conf, params, dev)
    result.update({"launches": counts["fused_ln_fwd"],
                   "fused_ln_fwd_per_batch": counts["fused_ln_fwd"]
                   / result["batches"],
                   "lstm_fwd_launches": counts["lstm_fwd"]})
    print("e2e_conformer " + json.dumps(result))
    check(counts["fused_ln_fwd"] == LN_PER_ENCODE * result["batches"],
          f"the conformer engine launched fused_ln_fwd "
          f"{counts['fused_ln_fwd']} times in {result['batches']} batches, "
          f"not {LN_PER_ENCODE} a batch")
    check(counts["lstm_fwd"] == 0, "the conformer engine launched lstm_fwd")
    check_no_band(counts, "conformer serving")
    feats, lens = served_batch(conf, dev)
    kernel_vs_plain_tokens(params, cfg, feats, lens, "conformer")
    c = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        reset_counts()
        tok_f, n_f = gf.recognize_greedy_fused(params, c, feats, lens,
                                               MAX_SYMBOLS)
        torch.cuda.synchronize()
        fused_launches = read_counts()["greedy_fused"]
        tok_g, n_g = recognize_greedy(params, c, feats, lens, MAX_SYMBOLS)
    row = {"params": "conformer", "dtype": "float32",
           "greedy_fused_launches": fused_launches,
           "tokens_identical": torch.equal(tok_f, tok_g)
           and torch.equal(n_f, n_g), "tokens_per_utt": n_f.tolist()}
    print("fused_greedy_conformer " + json.dumps(row))
    check(fused_launches > 0, "recognize_greedy_fused on the conformer "
                              "never launched greedy_fused")
    check(row["tokens_identical"], "recognize_greedy_fused (conformer, f32): "
                                   "tokens differ from recognize_greedy")
    result["fused_greedy"] = row
    return result


@contextlib.contextmanager
def serve_process(argv: list):
    """serve.py's CLI with `argv` in a process of its own: yields a dict
    with its "url", "start_s" (to its "serving on" line), "argv" and log
    "lines"; on leaving, SIGTERM drains it, and the dict gets its exit
    code "rc" and "drained"."""
    cmd = [sys.executable, "-m", "rnn_transducer_tpu_torch.serve", *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    lines, started = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line.rstrip())
            if "serving on " in line:
                started.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        check(started.wait(timeout=300),
              f"serve CLI {argv} did not start: {lines[-5:]}")
        info = {"argv": argv, "lines": lines,
                "start_s": time.perf_counter() - t0,
                "url": next(ln for ln in lines if "serving on " in ln).split(
                    "serving on ")[1].split()[0]}
        yield info
        proc.send_signal(signal.SIGTERM)
        info["rc"] = proc.wait(timeout=120)
        reader.join(timeout=30)
        info["drained"] = any("drained and closed" in ln for ln in lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def serve_cli(extra: list, utt: np.ndarray,
              config: str | None = "libri100_conformer", audio: bool = False,
              want_text: bool = False) -> dict:
    """serve.py's CLI, --config `config` (None: the --ckpt-dir's own) plus
    `extra`, in a process of its own: it warms up, answers one /recognize
    (with an n-best under --mode beam) and /stats, a streamable model also one /session of the
    utterance in the default 32-frame chunks, and drains and exits 0 on
    SIGTERM. audio=True: `utt` is raw 16 kHz PCM, sent as an {"audio"}
    body and as a PCM session split at `pcm_cuts`; want_text=True: the
    answers carry "text" (and word segments), the n-best too."""
    with serve_process([*(["--config", config] if config else []),
                        "--port", "0", *extra]) as srv:
        url, lines = srv["url"], srv["lines"]
        code, out, lat = post(url + "/recognize",
                              {"audio" if audio else "feats": utt.tolist()})
        session = None
        if f"stream_slots={STREAM_SLOTS}" in " ".join(lines):
            sid = post(url + "/session", {})[1]["sid"]
            session = (pcm_session_over_http(
                url, sid, utt, pcm_cuts(utt.shape[0],
                                        np.random.default_rng(0)))
                       if audio else
                       session_over_http(url, sid, utt, CHUNK_FRAMES))
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    rc = srv["rc"]
    row = {"argv": srv["argv"], "start_s": srv["start_s"], "code": code,
           "tokens": len(out["tokens"]), "latency_ms": lat * 1e3,
           "stats": stats, "rc": rc, "drained": srv["drained"]}
    if session is not None:  # bf16: the same tokens are reported, not asked
        row["session_tokens"] = len(session["final"])
        row["session_equals_recognize"] = session["final"] == out["tokens"]
        check(stats.get("streaming", {}).get("requests", 0) >= 1,
              f"serve CLI {extra}: /stats shows no streaming request")
    if want_text:
        row["text"] = out.get("text")
        row["words"] = len(out.get("words", []))
    print("serve_cli " + json.dumps(row))
    check(code == 200 and rc == 0 and row["drained"],
          f"serve CLI {extra}: code {code}, exit {rc}, log {lines[-5:]}")
    if want_text:
        check(isinstance(out.get("text"), str) and "words" in out,
              f"serve CLI {extra}: no text or words in {sorted(out)}")
        check(session is None or "text" in session["payload"],
              f"serve CLI {extra}: no text in the closed session")
    if "beam" in extra:
        row["nbest"] = len(out.get("nbest", []))
        check(1 <= row["nbest"] <= BEAM and "score" in out,
              f"serve CLI {extra}: no n-best in {sorted(out)}")
        check(not want_text or all("text" in h for h in out["nbest"]),
              f"serve CLI {extra}: an n-best entry without text")
    return row


# ------------------------------ phase 4h ---------------------------------

# Streaming sessions: serve.py's CLI defaults (8 slots, 32-frame chunks;
# bench.py's 128-frame chunks for the chunked-attention conformer).
STREAM_SLOTS, CHUNK_FRAMES, CONF_CHUNK_FRAMES = 8, 32, 128
FRAME_S = 0.01  # a feature frame's hop: 10 ms of audio
CONF_ROUND = 2e-4  # the engines round confidences and scores to 4 places


def delete(url: str) -> tuple[int, dict]:
    with urllib.request.urlopen(urllib.request.Request(
            url, method="DELETE"), timeout=300) as r:
        return r.status, json.loads(r.read())


def session_over_http(url: str, sid: str, utt: np.ndarray,
                      chunk: int) -> dict:
    """Every chunk of `utt` to /session/<sid> (the last one flagged, and
    short where the length is not a multiple of the chunk), then DELETE:
    the last partial result and the final tokens."""
    out = None
    for t0 in range(0, utt.shape[0], chunk):
        code, out, _ = post(f"{url}/session/{sid}", {
            "feats": utt[t0:t0 + chunk].tolist(),
            "last": t0 + chunk >= utt.shape[0]})
        check(code == 200, f"/session/{sid} answered {code}")
    code, final = delete(f"{url}/session/{sid}")
    check(code == 200, f"DELETE /session/{sid} answered {code}")
    return {"last": out, "final": final["tokens"]}


def pcm_cuts(n: int, rng: np.random.Generator) -> list[int]:
    """Uneven cut points of an n-sample waveform: a first piece of 237
    samples (no whole window: its POST completes no frame), then pieces of
    1,000-9,000 samples, none ending on the 160-sample hop."""
    cuts = [237]
    while True:
        at = cuts[-1] + int(rng.integers(1000, 9000))
        at += 7 if at % 160 == 0 else 0
        if at >= n:
            return cuts
        cuts.append(at)


def pcm_session_over_http(url: str, sid: str, audio: np.ndarray,
                          cuts: list) -> dict:
    """Raw PCM to /session/<sid> in the pieces `cuts` makes (the last one
    flagged), then DELETE: the last partial result, the final tokens and
    payload, and how many POSTs completed no slice (pending_frames)."""
    parts = np.split(audio, cuts)
    outs = []
    for i, part in enumerate(parts):
        code, out, _ = post(f"{url}/session/{sid}", {
            "audio": part.tolist(), "last": i == len(parts) - 1})
        check(code == 200, f"/session/{sid} answered {code}: {out}")
        outs.append(out)
    pending = sum("pending_frames" in o for o in outs[:-1])
    check(pending >= 1, f"PCM session {sid}: every POST completed a slice")
    code, final = delete(f"{url}/session/{sid}")
    check(code == 200, f"DELETE /session/{sid} answered {code}")
    return {"last": outs[-1], "final": final["tokens"], "payload": final,
            "posts": len(parts), "pending_posts": pending}


def serve_sessions(params, cfg, utts, dev, *, mode="greedy",
                   chunk=CHUNK_FRAMES, ngram=None, record=False, reopen=False,
                   at_once=True) -> dict:
    """Both engines behind one http_server, the CLI's defaults: each
    utterance as a /session of `chunk`-frame chunks and as a /recognize
    request, all at once (at_once=False: the sessions first, all
    concurrently, then the requests, so that the ticks' host ms are the
    streaming engine's alone). Returns the sessions' results and slots,
    the offline answers, the launch counts of the run, the ticks and
    offline batches, each tick's host ms, and with record=True the inputs
    of every tick (chunks, lens, active) for a replay. reopen=True then
    opens one more session on a freed slot and feeds it the first
    utterance."""
    kw = dict(mode=mode, beam=BEAM, expansions=EXPANSIONS,
              max_symbols=MAX_SYMBOLS, ngram=ngram)
    offline = BatchingEngine(params, cfg, frame_buckets=BUCKETS,
                             max_batch=MAX_BATCH, window_ms=WINDOW_MS,
                             device=dev, **kw)
    streaming = StreamingEngine(params, cfg, slots=STREAM_SLOTS,
                                chunk_frames=chunk, window_ms=WINDOW_MS,
                                device=dev, **kw)
    srv = None
    try:
        t0 = time.perf_counter()
        offline.warmup()
        streaming.warmup()
        warmup_s = time.perf_counter() - t0
        ticks = []
        if record:
            step = streaming._step

            def recording_step(p, lmp, state, chunks, lens, active, dw):
                ticks.append((chunks.cpu(), lens.cpu(), active.cpu()))
                return step(p, lmp, state, chunks, lens, active, dw)

            streaming._step = recording_step
        srv = http_server("127.0.0.1", 0, offline, streaming)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        sids = [post(f"{url}/session", {})[1]["sid"] for _ in utts]
        slots = [streaming._live[s] for s in sids]
        reset_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2 * len(utts)) as ex:
            sess = [ex.submit(session_over_http, url, s, u, chunk)
                    for s, u in zip(sids, utts)]
            if not at_once:
                sessions = [f.result() for f in sess]
                wall_s = time.perf_counter() - t0
            offl = [ex.submit(post, f"{url}/recognize", {"feats": u.tolist()})
                    for u in utts]
            sessions = [f.result() for f in sess]
            answers = [f.result() for f in offl]
        if at_once:
            wall_s = time.perf_counter() - t0
        counts = read_counts()
        if record:
            streaming._step = step  # the replay covers these sessions alone
        tick_ms = [s * 1e3 for s in streaming.stats.latency_s]
        result = {"sessions": sessions, "slots": slots,
                  "offline": [a[1] for a in answers],
                  "offline_codes": [a[0] for a in answers],
                  "counts": counts, "ticks": streaming.stats.batches,
                  "offline_batches": offline.stats.batches,
                  "tick_ms": tick_ms, "wall_s": wall_s,
                  "warmup_s": warmup_s, "recorded": ticks,
                  "stats": streaming.stats.summary()}
        if reopen:  # a freed slot takes a new session and starts clean
            sid = post(f"{url}/session", {})[1]["sid"]
            result["reopened"] = session_over_http(url, sid, utts[0], chunk)
        return result
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        offline.close()
        streaming.close()


def replay_ticks(params, cfg, run: dict, dev, mode="greedy",
                 ngram=None) -> list:
    """The recorded ticks of a run through the direct stream_chunk (beam:
    stream_chunk_beam) of all slots on the plain versions, the idle rows
    re-selected as the engine does: each session's final tokens (beam: its
    n-best tokens and scores) from its slot's row of the last state."""
    from rnn_transducer_tpu_torch.decode import streaming as ts

    S = STREAM_SLOTS
    with plain_kernels(), torch.inference_mode():
        dw = m.DecodeWeights(params, cfg)
        if mode == "greedy":
            state = ts.init_stream(params, cfg, S, MAX_SYMBOLS, device=dev,
                                   decode_weights=dw)
        else:
            state = ts.init_stream_beam(params, cfg, S, beam=BEAM,
                                        max_symbols=MAX_SYMBOLS, ngram=ngram,
                                        device=dev, decode_weights=dw)
        for chunks, lens, active in run["recorded"]:
            chunks, lens, active = (a.to(dev) for a in (chunks, lens, active))
            if mode == "greedy":
                new = ts.stream_chunk(params, cfg, state, chunks, lens,
                                      MAX_SYMBOLS, decode_weights=dw)[0]
            else:
                new = ts.stream_chunk_beam(
                    params, cfg, state, chunks, lens, beam=BEAM,
                    max_symbols=MAX_SYMBOLS, expansions=EXPANSIONS,
                    ngram=ngram, decode_weights=dw)[0]
            state = ts.select_rows(active, new, state)
        dec = state.decode_state
        if mode == "greedy":
            u, tok = dec[0].cpu(), dec[1].cpu()
            return [tok[s, :u[s]].tolist() for s in run["slots"]]
        order = torch.argsort(-dec[2], dim=-1, stable=True)
        tok = torch.gather(dec[0], 1, order[..., None].expand_as(dec[0]))
        n, sc = torch.gather(dec[1], 1, order), torch.gather(dec[2], 1, order)
        tok, n, sc = tok.cpu(), n.cpu(), sc.cpu()
        return [[(tok[s, k, :n[s, k]].tolist(), float(sc[s, k]))
                 for k in range(BEAM) if float(sc[s, k]) > -5e29]
                for s in run["slots"]]


def tick_timing(run: dict, chunk: int) -> dict:
    ms = run["tick_ms"]
    audio_ms = chunk * FRAME_S * 1e3  # a session's audio a tick
    return {"ticks": run["ticks"], "tick_host_ms_mean": statistics.mean(ms),
            "tick_host_ms_p50": statistics.median(ms),
            "tick_host_ms_max": max(ms), "chunk_audio_ms": audio_ms,
            "rtf": statistics.mean(ms) / audio_ms,
            "offline_batches": run["offline_batches"],
            "wall_s": run["wall_s"], "warmup_s": run["warmup_s"]}


def check_launches(run: dict, name: str, per_call: int, what: str) -> float:
    """`name` launched per_call times for each tick and each offline batch
    of the run; returns the launches a tick."""
    calls = run["ticks"] + run["offline_batches"]
    got = run["counts"][name]
    check(got == per_call * calls,
          f"streaming {what}: {got} {name} launches in {run['ticks']} ticks "
          f"and {run['offline_batches']} offline batches, not {per_call} "
          "each")
    check_no_band(run["counts"], f"streaming {what}")
    check(run["counts"]["greedy_fused"] == 0,
          f"streaming {what} launched greedy_fused")
    return (got - per_call * run["offline_batches"]) / run["ticks"]


def check_session_results(run: dict, lengths, what: str) -> None:
    """Well-formed partial results: HTTP 200s, the last partial equal to
    the final tokens, frames in order inside the utterance."""
    check(all(c == 200 for c in run["offline_codes"]),
          f"streaming {what}: /recognize codes {run['offline_codes']}")
    for s, T in zip(run["sessions"], lengths):
        last = s["last"]
        check(last["tokens"] == s["final"], f"streaming {what}: the last "
              "partial result differs from the closed session's tokens")
        check(len(last["tokens"]) == len(last["confidence"])
              == len(last["frames"]) <= MAX_SYMBOLS,
              f"streaming {what}: result fields disagree in length")
        check(all(0 <= f < T for f in last["frames"])
              and last["frames"] == sorted(last["frames"]),
              f"streaming {what}: frames out of order or past the utterance")
        check(0 <= last["stable_len"] <= len(last["tokens"]),
              f"streaming {what}: stable_len {last['stable_len']}")


def greedy_agreement(run: dict) -> dict:
    """Sessions against the offline engine's answers: rows with the same
    tokens, the same frames, and the largest confidence gap."""
    same_tok = same_fr = 0
    conf_gap = 0.0
    for s, a in zip(run["sessions"], run["offline"]):
        last = s["last"]
        same_tok += last["tokens"] == a["tokens"]
        same_fr += last["frames"] == a["frames"]
        if last["tokens"] == a["tokens"]:
            conf_gap = max([conf_gap] + [abs(x - y) for x, y in zip(
                last["confidence"], a["confidence"])])
    n = len(run["sessions"])
    return {"token_agreement": same_tok / n, "frame_agreement": same_fr / n,
            "max_confidence_gap": conf_gap}


def mixed_load(params, cfg, utts, dev, lengths, kernel: str,
               per_call: int, what: str, **kw) -> dict:
    """The sessions and the /recognize requests of the same utterances at
    once (the server's default traffic, both engines' worker threads on
    one card): checked as the sessions alone are, and the ticks' host ms
    and RTF under that load, with the launches of `kernel`."""
    run = serve_sessions(params, cfg, utts, dev, **kw)
    check_session_results(run, lengths, what)
    check_launches(run, kernel, per_call, what)
    return {**tick_timing(run, kw.get("chunk", CHUNK_FRAMES)),
            "launches": run["counts"][kernel]}


def encoder_gap(params, cfg, utts, dev, chunk: int) -> float:
    """Max |encode_chunk chunk by chunk - encode| over the valid frames of
    the sessions' utterances in one batch, through the kernels."""
    T = max(u.shape[0] for u in utts)
    T = -(-T // chunk) * chunk
    feats = np.zeros((len(utts), T, cfg.input_dim), np.float32)
    lens = np.array([u.shape[0] for u in utts], np.int32)
    for i, u in enumerate(utts):
        feats[i, :u.shape[0]] = u
    f, n = torch.from_numpy(feats).to(dev), torch.from_numpy(lens).to(dev)
    with torch.inference_mode():
        want, want_lens = m.encode(params, cfg, f, n)
        state, outs = m.init_enc_state(cfg, len(utts), dev), []
        for t0 in range(0, T, chunk):
            out, _, state = m.encode_chunk(
                params, cfg, f[:, t0:t0 + chunk],
                torch.clamp(n - t0, 0, chunk).to(torch.int32), state)
            outs.append(out)
        got = torch.cat(outs, dim=1)
    return max(float((got[b, :k] - want[b, :k]).abs().max())
               for b, k in enumerate(want_lens.tolist()) if k)


def stream_profile(params, cfg, utts, dev, *, mode="greedy",
                   chunk=CHUNK_FRAMES, ngram=None) -> dict:
    """One tick of every slot under torch.profiler, the engine alone (the
    utterances' second chunks, after a tick of their first): its wall ms,
    kernels and the device's busy share."""
    streaming = StreamingEngine(params, cfg, slots=STREAM_SLOTS,
                                chunk_frames=chunk, window_ms=50.0,
                                device=dev, mode=mode, beam=BEAM,
                                expansions=EXPANSIONS,
                                max_symbols=MAX_SYMBOLS, ngram=ngram)
    try:
        streaming.warmup()
        sids = [streaming.open_session() for _ in utts]

        def tick(i):
            with concurrent.futures.ThreadPoolExecutor(len(utts)) as ex:
                list(ex.map(lambda s, u: streaming.feed_full(
                    s, u[i * chunk:(i + 1) * chunk]), sids, utts))

        tick(0)  # warm: the first chunk of every session
        batches = streaming.stats.batches
        prof = beam_profile(lambda: tick(1))
        prof["ticks_in_window"] = streaming.stats.batches - batches
        return prof
    finally:
        streaming.close()


def streaming_phase(serving: dict, seed: int, dev) -> dict:
    """Phase 4h: streaming sessions behind http_server with both engines,
    the CLI's defaults (8 slots, 32-frame chunks, max_symbols 100): at
    f32 the sessions and /recognize requests of the same utterances at
    once (the checks), at bf16 (the served dtype) the sessions alone and
    then the requests (the ticks' host ms, the RTF, the agreement with
    the offline engine, reported), the same at once ("bf16_mixed": the
    ticks under offline load), and one tick profiled:
      greedy, float, on the served model and on beam_serving_setup's
        model (which emits along the utterance): 4 K4-fwd launches a tick
        with the carried state; each session's f32 tokens, frames and
        confidences equal to the offline engine's answer and to the plain
        path's (the recorded ticks replayed through stream_chunk on the
        plain versions); a freed slot reopened gives the first answer
        again;
      int8 (quantize_params): 4 K7 launches a tick, no K4-fwd; the f32
        sessions equal to the plain replay on the same slot layout; at
        equal lengths, stream_transcribe equal to recognize_greedy;
      beam with the serve CLI's trigram, on beam_serving_setup's emitting
        model: each session's n-best that of the offline beam engine, and
        of the plain replay, within beams_agree's tolerance;
      libri100_conformer_chunked at 128-frame chunks: 48 K8-fwd launches a
        tick; the f32 tokens equal to the offline engine's and to the
        plain replay's; the f32 encoder gap within ATOL.
    """
    from rnn_transducer_tpu_torch.decode.streaming import stream_transcribe

    cfg, params = serving["cfg"], serving["params"]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    # the first 8 served utterances (150-800 frames, most ending in a
    # short chunk)
    utts = serving["utts"][:STREAM_SLOTS]
    lengths = [u.shape[0] for u in utts]
    rows, seconds, last = {}, {}, [time.perf_counter()]

    def lap(key):
        """The wall seconds since the last lap, into seconds[key]."""
        now = time.perf_counter()
        seconds[key] = seconds.get(key, 0.0) + now - last[0]
        last[0] = now

    def report(name, row):
        row = {"what": name, **row}
        print("streaming " + json.dumps(row))
        rows[name] = row

    # -- greedy, float: the served model, and the beam phase's model that
    # emits along the utterance (so the carry crosses chunks) ------------
    beam_setup = beam_serving_setup(serving, seed, dev)
    for name, p in (("greedy", params), ("greedy_emitting",
                                         beam_setup["params"])):
        lap("setup")
        run = serve_sessions(p, f32, utts, dev, record=True, reopen=True)
        lap(f"{name}_f32")
        check_session_results(run, lengths, f"{name} f32")
        per_tick = check_launches(run, "lstm_fwd", cfg.enc_layers,
                                  f"{name} f32")
        agree = greedy_agreement(run)
        check(agree["token_agreement"] == 1.0
              and agree["frame_agreement"] == 1.0
              and agree["max_confidence_gap"] <= CONF_ROUND,
              f"streaming {name} f32: sessions differ from the offline "
              f"engine {agree}")
        plain = replay_ticks(p, f32, run, dev)
        check(plain == [s["final"] for s in run["sessions"]],
              f"streaming {name} f32: sessions differ from the plain replay")
        check(run["reopened"]["final"] == run["sessions"][0]["final"],
              f"streaming {name} f32: a reopened slot gave another answer")
        gap = encoder_gap(p, f32, utts, dev, CHUNK_FRAMES)
        check(gap <= ATOL[torch.float32], f"streaming f32 encoder gap {gap}")
        lap(f"{name}_replay")
        bf = serve_sessions(p, cfg, utts, dev, at_once=False)
        check_session_results(bf, lengths, f"{name} bf16")
        check_launches(bf, "lstm_fwd", cfg.enc_layers, f"{name} bf16")
        lap(f"{name}_bf16")
        mixed = mixed_load(p, cfg, utts, dev, lengths, "lstm_fwd",
                           cfg.enc_layers, f"{name} bf16 mixed")
        lap(f"{name}_mixed")
        report(name, {
            "launches": run["counts"]["lstm_fwd"] + bf["counts"]["lstm_fwd"]
            + mixed["launches"],
            "lstm_fwd_per_tick": per_tick, "f32": agree,
            "f32_encoder_gap": gap, "plain_replay_identical": True,
            "reopened_identical": True,
            "mean_tokens": statistics.mean(len(s["final"])
                                           for s in run["sessions"]),
            "bf16": {**greedy_agreement(bf), **tick_timing(bf, CHUNK_FRAMES)},
            "bf16_mixed": mixed,
            "profile": stream_profile(p, cfg, utts, dev)})
        lap(f"{name}_profile")

    # -- int8 -------------------------------------------------------------
    lap("setup")
    qparams = quantize_params(params)
    run = serve_sessions(qparams, f32, utts, dev, record=True)
    check_session_results(run, lengths, "int8 f32")
    per_tick = check_launches(run, "lstm_fwd_int8", cfg.enc_layers,
                              "int8 f32")
    check(run["counts"]["lstm_fwd"] == 0, "streaming int8 launched lstm_fwd")
    plain = replay_ticks(qparams, f32, run, dev)
    check(plain == [s["final"] for s in run["sessions"]],
          "streaming int8 f32: sessions differ from the plain replay on "
          "the same slot layout")
    # equal lengths: chunked == offline on the W8A8 route
    T = 4 * CHUNK_FRAMES  # every utterance is longer
    feats = torch.from_numpy(np.stack([u[:T] for u in utts])).to(dev)
    lens = torch.full((len(utts),), T, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        tok_s, n_s = stream_transcribe(qparams, f32, feats, lens,
                                       CHUNK_FRAMES, MAX_SYMBOLS, device=dev)
        tok_o, n_o = recognize_greedy(qparams, f32, feats, lens, MAX_SYMBOLS)
    check(torch.equal(tok_s, tok_o) and torch.equal(n_s, n_o),
          "streaming int8 f32 at equal lengths: tokens differ from "
          "recognize_greedy")
    bf = serve_sessions(qparams, cfg, utts, dev, at_once=False)
    check_launches(bf, "lstm_fwd_int8", cfg.enc_layers, "int8 bf16")
    check(bf["counts"]["lstm_fwd"] == 0, "streaming int8 launched lstm_fwd")
    mixed = mixed_load(qparams, cfg, utts, dev, lengths, "lstm_fwd_int8",
                       cfg.enc_layers, "int8 bf16 mixed")
    report("int8", {
        "launches": run["counts"]["lstm_fwd_int8"]
        + bf["counts"]["lstm_fwd_int8"] + mixed["launches"],
        "lstm_fwd_int8_per_tick": per_tick, "lstm_fwd_launches": 0,
        "plain_replay_identical": True,
        "equal_length_tokens_identical": True,
        "equal_length_tokens": n_s.tolist(),
        "f32_ragged_vs_offline": greedy_agreement(run),
        "bf16": {**greedy_agreement(bf), **tick_timing(bf, CHUNK_FRAMES)},
        "bf16_mixed": mixed})
    del qparams
    lap("int8")

    # -- beam with the trigram --------------------------------------------
    bparams = beam_setup["params"]
    ngram = (serve_trigram(cfg, seed), NGRAM_WEIGHT)
    run = serve_sessions(bparams, f32, utts, dev, mode="beam", ngram=ngram,
                         record=True)
    check_session_results(run, lengths, "beam f32")
    per_tick = check_launches(run, "lstm_fwd", cfg.enc_layers, "beam f32")
    got = nbest_arrays([s["last"]["nbest"] for s in run["sessions"]])
    want = nbest_arrays([a["nbest"] for a in run["offline"]])
    vs_offline = beams_agree(got, want, "streaming vs offline")
    replay = nbest_arrays([[{"tokens": t, "score": sc} for t, sc in r]
                           for r in replay_ticks(bparams, f32, run, dev,
                                                 "beam", (ngram[0].to(dev),
                                                          ngram[1]))])
    vs_plain = beams_agree(got, replay, "streaming vs plain replay")
    mean_top = statistics.mean(vs_offline["top_lengths"])
    check(mean_top >= BEAM_MIN_TOKENS,
          f"streaming beam: top beams of {mean_top} tokens on average")
    bf = serve_sessions(bparams, cfg, utts, dev, mode="beam", ngram=ngram,
                        at_once=False)
    check_launches(bf, "lstm_fwd", cfg.enc_layers, "beam bf16")
    mixed = mixed_load(bparams, cfg, utts, dev, lengths, "lstm_fwd",
                       cfg.enc_layers, "beam bf16 mixed", mode="beam",
                       ngram=ngram)
    lap("beam_checks")
    prof = stream_profile(bparams, cfg, utts, dev, mode="beam", ngram=ngram)
    lap("beam_profile")
    report("beam", {
        "launches": run["counts"]["lstm_fwd"] + bf["counts"]["lstm_fwd"]
        + mixed["launches"],
        "lstm_fwd_per_tick": per_tick, "f32_vs_offline": vs_offline,
        "f32_vs_plain_replay": vs_plain, "mean_top_length": mean_top,
        "bf16": {"top_agreement": statistics.mean(
            s["last"]["tokens"] == a["tokens"]
            for s, a in zip(bf["sessions"], bf["offline"])),
            **tick_timing(bf, CHUNK_FRAMES)},
        "bf16_mixed": mixed, "profile": prof})
    del beam_setup, bparams

    # -- the chunked-attention conformer at 128-frame chunks ----------------
    conf = conformer_serving_setup(serving, seed, dev,
                                   config_libri100_conformer_chunked())
    ccfg, cparams = conf["cfg"], conf["params"]
    c32 = dataclasses.replace(ccfg, compute_dtype="float32")
    run = serve_sessions(cparams, c32, utts, dev, chunk=CONF_CHUNK_FRAMES,
                         record=True)
    check_session_results(run, lengths, "conformer f32")
    per_tick = check_launches(run, "fused_ln_fwd", LN_PER_ENCODE,
                              "conformer f32")
    check(run["counts"]["lstm_fwd"] == 0,
          "streaming conformer launched lstm_fwd")
    agree = greedy_agreement(run)
    check(agree["token_agreement"] == 1.0 and agree["frame_agreement"] == 1.0
          and agree["max_confidence_gap"] <= CONF_ROUND,
          f"streaming conformer f32: sessions differ from the offline "
          f"engine {agree}")
    # K8-fwd at the stream's own shapes (ln_att over the cache and the
    # chunk) against the plain LayerNorm
    plain = replay_ticks(cparams, c32, run, dev)
    check(plain == [s["final"] for s in run["sessions"]],
          "streaming conformer f32: sessions differ from the plain replay")
    gap = encoder_gap(cparams, c32, utts, dev, CONF_CHUNK_FRAMES)
    check(gap <= ATOL[torch.float32],
          f"streaming conformer f32 encoder gap {gap}")
    bf = serve_sessions(cparams, ccfg, utts, dev, chunk=CONF_CHUNK_FRAMES,
                        at_once=False)
    check_launches(bf, "fused_ln_fwd", LN_PER_ENCODE, "conformer bf16")
    mixed = mixed_load(cparams, ccfg, utts, dev, lengths, "fused_ln_fwd",
                       LN_PER_ENCODE, "conformer bf16 mixed",
                       chunk=CONF_CHUNK_FRAMES)
    prof = stream_profile(cparams, ccfg, utts, dev, chunk=CONF_CHUNK_FRAMES)
    report("conformer_chunked", {
        "launches": run["counts"]["fused_ln_fwd"]
        + bf["counts"]["fused_ln_fwd"] + mixed["launches"],
        "fused_ln_fwd_per_tick": per_tick, "f32": agree,
        "f32_encoder_gap": gap, "plain_replay_identical": True,
        "mean_tokens": statistics.mean(len(s["final"])
                                       for s in run["sessions"]),
        "bf16": {**greedy_agreement(bf),
                 **tick_timing(bf, CONF_CHUNK_FRAMES)},
        "bf16_mixed": mixed, "profile": prof})
    lap("conformer_chunked")
    print("streaming_seconds " + json.dumps(seconds))
    print("streaming_card " + card_line())
    return rows


def nbest_arrays(nbests: list) -> tuple:
    """n-best lists ({"tokens", "score"} each) -> beams_agree's numpy
    tokens (B, K, U), lengths (B, K) and scores (B, K), dead beams at
    -1e30."""
    B = len(nbests)
    tok = np.zeros((B, BEAM, MAX_SYMBOLS), np.int64)
    n = np.zeros((B, BEAM), np.int64)
    sc = np.full((B, BEAM), -1e30)
    for b, hyps in enumerate(nbests):
        for k, h in enumerate(hyps):
            tok[b, k, :len(h["tokens"])] = h["tokens"]
            n[b, k] = len(h["tokens"])
            sc[b, k] = h["score"]
    return tok, n, sc


def serve_trigram(cfg, seed: int):
    """The serve_cli phase's trigram: train_ngram on 40 seeded sequences."""
    from rnn_transducer_tpu_torch.models.ngram import train_ngram

    rng = np.random.default_rng(seed + 21)
    V = cfg.vocab_size
    return train_ngram([rng.integers(1, V, size=8).tolist()
                        for _ in range(40)], 3, V)


# ------------------------------ phase 4i ---------------------------------

# Raw audio in, text out. A served utterance of T frames becomes T*160 +
# AUDIO_PAD samples of 16 kHz PCM, which featurizes to T frames again.
AUDIO_PAD = 240
FRONTEND_ATOL = 1e-3  # card log_mel against the float64 oracle (JAX's bound)
PCM_ATOL = 5e-4  # PCM sessions' features against offline (JAX's bound)
BPE_VOCAB = 1024  # the model's vocabulary: at most that many BPE ids
AUDIO_CLI_CONFIGS = ("libri100", "libri100_conformer")  # phase 4i (d)


def audio_setup(serving: dict, seed: int, dev) -> dict:
    """The served utterances as raw PCM (0.1 * N(0, 1) from the seed),
    their card log_mel features, global CMVN stats of those features, the
    served model with its blank offset set on them (`blank_offset`), and
    a BPE tokenizer of at most BPE_VOCAB ids learned from README.md."""
    rng = np.random.default_rng(seed + 40)
    audio = [(0.1 * rng.normal(size=int(T) * 160 + AUDIO_PAD)).astype(
        np.float32) for T in serving["lengths"]]
    feats = [featurize(a, device=dev) for a in audio]
    check([f.shape[0] for f in feats] == [int(T) for T in serving["lengths"]],
          "the served lengths' audio does not featurize to those lengths")
    cat = np.concatenate(feats)
    cmvn = {"mean": cat.mean(0).tolist(), "std": cat.std(0).tolist()}
    # the served model's blank offset again, on these normalized features
    # (smooth in time, unlike N(0, 1) frames): a few tokens an utterance
    cfg, params = serving["cfg"], serving["params"]
    first = np.stack([apply_cmvn(f[:150], cmvn) for f in feats[:4]])
    out_b = params["joint"]["out"]["b"].clone()
    out_b[cfg.blank] += blank_offset(params, cfg, dev, None, first)
    params = {**params, "joint": {**params["joint"], "out": {
        "w": params["joint"]["out"]["w"], "b": out_b}}}
    readme = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "README.md")
    with open(readme) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    t0 = time.perf_counter()
    tok = BpeTokenizer.train(lines, BPE_VOCAB)
    print(f"audio_setup bpe: {tok.vocab_size} ids from {len(lines)} README "
          f"lines in {time.perf_counter() - t0:.1f} s")
    return {"audio": audio, "feats": feats, "cmvn": cmvn, "tok": tok,
            "lines": lines, "params": params}


def frontend_vs_plain(au: dict, dev) -> dict:
    """(a) The card log_mel of the first 8 utterances (150-800 frames,
    1.5-8 s) in one padded batch against log_mel_oracle (float64, host) on
    the same samples: max abs error and frame lens; card ms (CUDA events
    around a call, mean of 20) and kernels a call (torch.profiler) for the
    batch and for one 8 s utterance."""
    batch = au["audio"][:MAX_BATCH]
    lens = np.array([a.shape[0] for a in batch], np.int32)
    padded = np.zeros((len(batch), lens.max()), np.float32)
    for i, a in enumerate(batch):
        padded[i, :a.shape[0]] = a
    x, n = torch.from_numpy(padded).to(dev), torch.from_numpy(lens).to(dev)
    with torch.inference_mode():
        f, fl = log_mel(x, n)
    want, want_n = log_mel_oracle(padded, lens)
    err = float(np.abs(f.cpu().numpy().astype(np.float64) - want).max())
    row = {"batch": list(padded.shape), "frames": fl.tolist(),
           "max_abs_err": err, "atol": FRONTEND_ATOL}
    check(fl.cpu().numpy().tolist() == want_n.tolist(),
          f"card log_mel frame lens {fl.tolist()} != the oracle's")
    check(err <= FRONTEND_ATOL, f"card log_mel against its float64 plain "
                                f"version: {err} > {FRONTEND_ATOL}")
    longest = int(np.argmax(lens))
    one = x[longest:longest + 1, :lens[longest]]
    one_n = n[longest:longest + 1]
    for name, args in (("batch", (x, n)), ("one_8s", (one, one_n))):
        def call(args=args):
            with torch.inference_mode():
                log_mel(*args)
        call()
        row[f"{name}_ms"] = statistics.mean(cuda_ms(call) for _ in range(20))
        # a profiled window of this ~0.5 ms call was seen to lose all its
        # kernels on the H100 (the card's clock mapped outside it): the
        # most of three windows
        row[f"{name}_kernels"] = max(beam_profile(call)["kernels"]
                                     for _ in range(3))
    row["card"] = card_line()
    print("audio_frontend " + json.dumps(row))
    return row


def body_parse_ms(au: dict) -> dict:
    """Host ms to parse an 8 s body (json.loads + np.asarray, as the
    server does), audio against its 800 x 80 feats; the mean of 5."""
    i = int(np.argmax([a.shape[0] for a in au["audio"]]))
    row = {}
    for form, x in (("audio", au["audio"][i]), ("feats", au["feats"][i])):
        body = json.dumps({form: x.tolist()}).encode()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            np.asarray(json.loads(body)[form], np.float32)
            times.append((time.perf_counter() - t0) * 1e3)
        row[f"{form}_mb"] = len(body) / 1e6
        row[f"{form}_parse_ms"] = statistics.mean(times)
    return row


def recording_feeds(streaming) -> dict:
    """Wrap the engine's feed_full so that every chunk a session feeds it
    is kept: sid -> [chunks]."""
    fed = collections.defaultdict(list)
    feed_full = streaming.feed_full

    def recording(sid, chunk, last=False):
        fed[sid].append(np.array(chunk, np.float32))
        return feed_full(sid, chunk, last)

    streaming.feed_full = recording
    return fed


def audio_f32(serving: dict, au: dict, dev) -> dict:
    """(b) and (c) at f32 on the served model, both engines behind one
    http_server with the BPE tokenizer and the global CMVN.
    (b) Each of the first 8 utterances as an {"audio"} /recognize and as a
        {"feats"} body of its card log_mel, one at a time: the same tokens
        (same function, device and input); "text" is decode_to_text of the
        tokens; "words" present.
    (c) The same utterances as PCM sessions split at `pcm_cuts` (one POST
        completes no frame) with their {"audio"} /recognize requests at
        once: each session's features (the chunks the engine was fed, the
        CMVN undone) within PCM_ATOL of the offline log_mel; its final
        tokens equal to the offline engine's answer for those features.
        The sessions equal to the /recognize answers are counted, not
        gated (the two feature paths differ within PCM_ATOL)."""
    cfg = dataclasses.replace(serving["cfg"], compute_dtype="float32")
    params, tok, cmvn = au["params"], au["tok"], au["cmvn"]
    audio, feats = au["audio"][:STREAM_SLOTS], au["feats"][:STREAM_SLOTS]
    offline = BatchingEngine(params, cfg, max_symbols=MAX_SYMBOLS,
                             frame_buckets=BUCKETS, max_batch=MAX_BATCH,
                             window_ms=WINDOW_MS, device=dev)
    streaming = StreamingEngine(params, cfg, slots=STREAM_SLOTS,
                                chunk_frames=CHUNK_FRAMES,
                                max_symbols=MAX_SYMBOLS, window_ms=WINDOW_MS,
                                device=dev)
    srv = None
    try:
        offline.warmup()
        streaming.warmup()
        fed = recording_feeds(streaming)
        srv = http_server("127.0.0.1", 0, offline, streaming, tok,
                          cmvn=cmvn)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        # (b)
        tokens, words = [], 0
        for a, f in zip(audio, feats):
            code_a, out_a, _ = post(f"{url}/recognize",
                                    {"audio": a.tolist()})
            code_f, out_f, _ = post(f"{url}/recognize",
                                    {"feats": f.tolist()})
            check(code_a == code_f == 200,
                  f"audio bodies: HTTP {code_a}, {code_f}")
            check(out_a["tokens"] == out_f["tokens"], "an audio body's "
                  "tokens differ from its card log_mel as a feats body")
            check(out_a["text"] == decode_to_text(tok, out_a["tokens"])
                  and "words" in out_a, "audio body: text or words wrong")
            tokens.append(len(out_a["tokens"]))
            words += len(out_a["words"])
        row = {"audio_equals_feats": True, "tokens": tokens, "words": words,
               "text_0": out_a["text"][:80]}
        # (c)
        sids = [post(f"{url}/session", {})[1]["sid"] for _ in audio]
        rng = np.random.default_rng(41)
        cuts = [pcm_cuts(a.shape[0], rng) for a in audio]
        with concurrent.futures.ThreadPoolExecutor(2 * len(audio)) as ex:
            sess = [ex.submit(pcm_session_over_http, url, s, a, c)
                    for s, a, c in zip(sids, audio, cuts)]
            recog = [ex.submit(post, f"{url}/recognize", {"audio": a.tolist()})
                     for a in audio]
            sessions = [x.result() for x in sess]
            answers = [x.result() for x in recog]
        check(all(a[0] == 200 for a in answers), "PCM phase: /recognize "
              f"codes {[a[0] for a in answers]}")
        mean, istd = stats_arrays(cmvn)
        worst, same_recognize = 0.0, 0
        for sid, f, s, a in zip(sids, feats, sessions, answers):
            got = np.concatenate(fed[sid]) / istd + mean  # CMVN undone
            check(got.shape == f.shape, f"PCM session {sid}: {got.shape} "
                  f"features, offline {f.shape}")
            worst = max(worst, float(np.abs(got - f).max()))
            want = offline.submit_full(np.concatenate(fed[sid]))
            check(s["final"] == want["tokens"], f"PCM session {sid}: final "
                  "tokens differ from the offline engine's on the same "
                  "features")
            check(s["payload"]["text"] == decode_to_text(tok, s["final"]),
                  f"PCM session {sid}: text")
            same_recognize += s["final"] == a[1]["tokens"]
        check(worst <= PCM_ATOL, f"PCM sessions' features {worst} from the "
                                 f"offline log_mel (> {PCM_ATOL})")
        row.update({"pcm_feature_err": worst, "pcm_atol": PCM_ATOL,
                    "pcm_equals_offline_engine": True,
                    "pcm_equals_recognize": same_recognize,
                    "sessions": len(sessions),
                    "posts": [s["posts"] for s in sessions],
                    "pending_posts": [s["pending_posts"] for s in sessions],
                    "session_tokens": [len(s["final"]) for s in sessions]})
        print("audio_f32 " + json.dumps(row))
        return row
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        offline.close()
        streaming.close()


def audio_bf16(serving: dict, au: dict, dev) -> dict:
    """(e) serve.py's defaults (24 requests at once, bf16), float and
    int8 weights, behind http_server with the tokenizer and CMVN: every
    request as an {"audio"} body, then as a {"feats"} body. K4-fwd (float)
    or K7 (int8) launches 4 times a batch on each route, and K4-fwd never
    on the int8 engine. p50 of each route; host ms to parse a body."""
    cfg = serving["cfg"]
    rows = {}
    for what, params, kernel in (
            ("float", au["params"], "lstm_fwd"),
            ("int8", quantize_params(au["params"]), "lstm_fwd_int8")):
        engine = BatchingEngine(params, cfg, max_symbols=MAX_SYMBOLS,
                                frame_buckets=BUCKETS, max_batch=MAX_BATCH,
                                window_ms=WINDOW_MS, device=dev)
        srv = None
        try:
            engine.warmup()
            srv = http_server("127.0.0.1", 0, engine, None, au["tok"],
                              cmvn=au["cmvn"])
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{srv.server_address[1]}/recognize"
            row = {}
            for form in ("audio", "feats"):
                batches = engine.stats.batches
                reset_counts()
                with concurrent.futures.ThreadPoolExecutor(
                        len(au[form])) as ex:
                    answers = list(ex.map(lambda x: post(
                        url, {form: x.tolist()}), au[form]))
                counts = read_counts()
                batches = engine.stats.batches - batches
                check(all(a[0] == 200 for a in answers),
                      f"audio {what} {form}: codes {[a[0] for a in answers]}")
                check(counts[kernel] == cfg.enc_layers * batches,
                      f"audio {what} {form}: {counts[kernel]} {kernel} "
                      f"launches in {batches} batches, not "
                      f"{cfg.enc_layers} a batch")
                check(what == "float" or counts["lstm_fwd"] == 0,
                      f"audio int8 {form}: lstm_fwd launched")
                check_no_band(counts, f"audio {what}")
                lat = sorted(a[2] * 1e3 for a in answers)
                row[form] = {"requests": len(answers), "batches": batches,
                             "launches": counts[kernel],
                             "p50_ms": lat[len(lat) // 2],
                             "p95_ms": lat[min(len(lat) - 1,
                                               int(0.95 * len(lat)))],
                             "mean_tokens": statistics.mean(
                                 len(a[1]["tokens"]) for a in answers)}
            rows[what] = row
        finally:
            if srv is not None:
                srv.shutdown()
                srv.server_close()
            engine.close()
    rows["parse"] = body_parse_ms(au)
    rows["card"] = card_line()
    print("audio_bf16 " + json.dumps(rows))
    return rows


def audio_cli_chain(au: dict, dev) -> dict:
    """(d) The port's own checkpoints through its CLIs, libri100 and
    libri100_conformer: the training CLI for 2 steps with --tokenizer
    bpe:<the README model> records it in meta.json; serve.py --ckpt-dir
    answers an {"audio"} /recognize with text and words and (libri100) a
    PCM session, and drains; --mode beam --boost-file answers an n-best
    with text; the decode CLI on a manifest of .npy audio prints its JSON
    line with wer, rtf and word_wer."""
    from rnn_transducer_tpu_torch.recognize import main as recognize_cli

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        bpe = os.path.join(tmp, "bpe.json")
        au["tok"].save(bpe)
        phrases = os.path.join(tmp, "phrases.txt")
        with open(phrases, "w") as f:
            f.write("the port\nkernel\t1.5\n")
        man = os.path.join(tmp, "audio.jsonl")
        with open(man, "w") as f:
            for i, a in enumerate(au["audio"][:MAX_BATCH]):
                np.save(os.path.join(tmp, f"a{i}.npy"), a)
                labels = au["tok"].encode(au["lines"][i])[:20] or [1]
                f.write(json.dumps({"audio": os.path.join(tmp, f"a{i}.npy"),
                                    "labels": labels}) + "\n")
        utt = au["audio"][0]
        dirs, calls = {}, {}
        for config in AUDIO_CLI_CONFIGS:
            d = dirs[config] = os.path.join(tmp, os.path.basename(config))
            cli_json(["--config", config, "--data", "synthetic", "--steps",
                      "2", "--batch-size", "8", "--max-frames", "200",
                      "--max-labels", "20", "--warmup-steps", "1",
                      "--log-every", "1", "--tokenizer", f"bpe:{bpe}",
                      "--ckpt-dir", d, "--device", dev.type], 2,
                     f"tokenizer_{config}")
            check(ckpt.load_meta(d)["tokenizer"]
                  == tokenizer_to_meta(au["tok"]),
                  f"{config}: meta.json lacks the BPE tokenizer")
            calls[config, "serve"] = ["--ckpt-dir", d]
            if config == AUDIO_CLI_CONFIGS[0]:
                calls[config, "serve_beam_boost"] = [
                    "--ckpt-dir", d, "--mode", "beam", "--boost-file",
                    phrases]
        # every config's servers at once, each a process of its own on
        # the card
        with concurrent.futures.ThreadPoolExecutor(len(calls)) as ex:
            futs = {k: ex.submit(serve_cli, extra, utt, k[0], audio=True,
                                 want_text=True)
                    for k, extra in calls.items()}
            served = {k: f.result() for k, f in futs.items()}
        for config in AUDIO_CLI_CONFIGS:
            row = {k[1]: v for k, v in served.items() if k[0] == config}
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                got = recognize_cli(["--ckpt-dir", dirs[config], "--data",
                                     f"manifest:{man}", "--batch-size",
                                     str(MAX_BATCH), "--device", dev.type])
            last = json.loads(out.getvalue().strip().splitlines()[-1])
            check(last == got and {"wer", "rtf", "p50_latency_s",
                                   "word_wer"} <= set(last)
                  and all(np.isfinite(last[k]) for k in ("wer", "rtf",
                                                         "word_wer"))
                  and last["n"] == MAX_BATCH,
                  f"{config}: the decode CLI printed {last}")
            row["recognize"] = last
            print(f"audio_cli_{config} " + json.dumps(row["recognize"]))
            rows[config] = row
    return rows


def audio_phase(serving: dict, seed: int, dev) -> dict:
    """Phase 4i: raw 16 kHz PCM in, text out (a)-(e); see the docstrings
    of frontend_vs_plain, audio_f32, audio_cli_chain and audio_bf16."""
    seconds = {}
    with part(seconds, "setup"):
        au = audio_setup(serving, seed, dev)
    with part(seconds, "frontend"):
        front = frontend_vs_plain(au, dev)
    with part(seconds, "f32"):
        f32 = audio_f32(serving, au, dev)
    with part(seconds, "bf16"):
        bf16 = audio_bf16(serving, au, dev)
    with part(seconds, "cli"):
        chain = audio_cli_chain(au, dev)
    print("audio_seconds " + json.dumps(seconds))
    print("audio_card " + card_line())
    return {"frontend": front, "f32": f32, "bf16": bf16, "cli": chain}


# ------------------------------ phase 5 ----------------------------------

def bench_batch(cfg, seed: int, dev, U: int = TRAIN_U, B: int = TRAIN_B,
                T: int = TRAIN_T, ragged: bool = False):
    """bench.py's batch: B utterances of T noise frames, full frame and
    label lengths, U random labels, from the seed. ragged=True: frame
    lengths in [T/2, T] and label lengths in [U/2, U], the first row
    full."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, cfg.input_dim)).astype(np.float32)
    labels = rng.integers(1, cfg.vocab_size, size=(B, U)).astype(np.int32)
    fl, ll = np.full((B,), T, np.int32), np.full((B,), U, np.int32)
    if ragged:
        fl[1:] = rng.integers(T // 2, T + 1, size=B - 1)
        ll[1:] = rng.integers(U // 2, U + 1, size=B - 1)
    return (torch.from_numpy(feats).to(dev), torch.from_numpy(fl).to(dev),
            torch.from_numpy(labels).to(dev), torch.from_numpy(ll).to(dev))


def leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def pad_profiler_window() -> None:
    """A spin kernel of ~20 ms, then a synchronise. torch.profiler drops a
    kernel whose start or end, mapped from the card's clock onto the
    host's, falls outside its window, and the mapping can be off by
    milliseconds: one AR step's trace on the H100 placed kernels up to 3.9
    ms before their own launch, and lost the step's first LSTM kernel. A
    pad at each end of the window keeps the profiled work inside it; the
    spin kernels themselves are left out of every count."""
    torch.cuda._sleep(40_000_000)
    torch.cuda.synchronize()


# The start of a profiler window: short spin kernels, then a long spin
# (~80 ms), ahead of the profiled work.
LEAD_SPINS, LEAD_SPIN_CYCLES = 256, 160_000_000


def lead_profiler_window() -> None:
    """The start of a profiler window: LEAD_SPINS short spin kernels
    (~10 µs each), then a spin of LEAD_SPIN_CYCLES, then a synchronise.
    Late in one run of this script an H100 host lost the first ~26 ms and
    21 kernels of every window of a step (the ~20 ms pad, then the step's
    kernels up to its second lstm_fwd), in all three windows of the TIMIT
    and libri960 steps, while the same steps alone lost nothing; so a
    window starts with kernels and time to lose, all left out of every
    count, as `pad_profiler_window` ends it."""
    for _ in range(LEAD_SPINS):
        torch.cuda._sleep(20_000)
    torch.cuda._sleep(LEAD_SPIN_CYCLES)
    torch.cuda.synchronize()


# Profiled windows a step: the profiler can drop kernels of a window on
# the H100 (a libri960 step's trace lost one of its 8 lstm_fwd kernels),
# so a step is profiled this many times and the window holding the most
# kernels is read, as the card tests read theirs.
PROFILE_WINDOWS = 3


def profile_step(step, state, batch, profile_dir, name="train_step",
                 windows: int = PROFILE_WINDOWS):
    """A training step under torch.profiler, `windows` times (the state
    goes on through each), read from the window that holds the most
    kernels: device time by kernel family, host time by the step's spans,
    the device's busy share."""
    best = None
    for _ in range(windows):
        state, out, prof = profile_window(step, state, batch)
        if best is None or (sum(out["device_launches"].values())
                            > sum(best[0]["device_launches"].values())):
            best = (out, prof)
    out, prof = best
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))
        with open(os.path.join(profile_dir, f"{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=60))
    return state, out


def profile_window(step, state, batch):
    """One training step in one profiler window: (state, its families'
    device ms and launches, spans, busy share, the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_profiler_window()
        t0 = time.perf_counter()
        state, _ = step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pad_profiler_window()
    families = {"lstm_fwd": ("lstm_fwd_persistent_kernel",),
                "lstm_bwd": ("lstm_bwd_persistent_kernel",),
                # K1: the ring's W^T pass and ring kernel, or its CUDA-core
                # form
                "joint_fwd": ("joint_fwd_wt_kernel", "joint_fwd_ring_kernel",
                              "joint_fwd_kernel"),
                "joint_bwd_a": ("joint_bwd_a_",),
                # K2's kernel B: the ring's two kernels, or its CUDA-core
                # form (never a K6 kernel)
                "joint_bwd_b": ("joint_bwd_b_zb_kernel",
                                "joint_bwd_b_ring_kernel",
                                "joint_bwd_b_kernel"),
                "joint_bwd_sums": ("reduce_parts_kernel",),
                "lattice": ("lattice_alpha_kernel", "lattice_beta_kernel"),
                "loss_rows": ("extract_lp_kernel", "assemble_grad_kernel"),
                "fused_ln": ("ln_fwd_", "ln_bwd_"),
                # K6: the backward kernels' names first (every kernel of
                # band_fused.cu may carry its file's tag in its name)
                "band_bwd_a": ("band_bwd_a_",),
                "band_bwd_b": ("band_bwd_b_",),
                "band_sums": ("band_sum_parts",),
                "band_fwd": ("band_fwd_wt_kernel", "band_fwd_ring_kernel",
                             "band_fwd_kernel"),
                "gemm": ("gemm", "Gemm", "cutlass", "sm90_xmma"),
                "softmax": ("softmax",),
                "elementwise": ("elementwise_kernel",),
                "reduce": ("reduce_kernel",)}
    device = {k: 0.0 for k in (*families, "other")}
    launches = {k: 0 for k in device}
    host, span, ops, joint_kernels = {}, {}, [], {}
    for evt in prof.key_averages():
        if evt.key in tl.SPANS:  # a span: host time, and its device range
            if evt.device_type == DeviceType.CUDA:
                span[evt.key] = evt.device_time_total / 1e3
            else:
                host[evt.key] = evt.cpu_time_total / 1e3
            continue
        if evt.device_type != DeviceType.CUDA or "spin_kernel" in evt.key:
            continue
        fam = next((k for k, names in families.items()
                    if any(n in evt.key for n in names)), "other")
        ms = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0)) / 1e3
        device[fam] += ms
        launches[fam] += evt.count
        ops.append((ms, evt.count, evt.key))
        if fam.startswith("joint_"):  # which form of K1 / K2 ran
            hit = re.search(r"joint_[a-z_]+", evt.key)
            name = hit.group(0) if hit else evt.key[:60]
            joint_kernels[name] = joint_kernels.get(name, 0) + evt.count
    busy = sum(device.values())
    top = [{"op": k[:120], "ms": ms, "launches": n}
           for ms, n, k in sorted(ops, reverse=True)[:10]]
    out = {"wall_ms": wall_ms, "device_ms": device, "device_launches":
           launches, "device_busy_share": busy / wall_ms,
           "host_span_ms": host, "device_span_ms": span,
           "top_device_ops": top, "joint_kernels": joint_kernels}
    return state, out, prof


def check_fused_joint_profile(prof: dict, result: dict, what: str) -> None:
    """A profiled fused-loss step runs K1 on its ring, the W^T pass and the
    ring kernel once each a joint_fwd call, K2's kernels A and B on their
    rings, A's W^T pass and ring kernel and B's zb pass and ring kernel
    once each a joint_bwd call, and no K6 kernel."""
    seen = prof["device_launches"]
    per_step = result["launches"]["joint_fwd"] / result["steps"]
    check(per_step > 0 and seen["joint_fwd"] == 2 * per_step,
          f"the profiled {what} step ran {seen['joint_fwd']} joint_fwd "
          f"kernels, not 2 for each of its {per_step} joint_fwd calls")
    per_step = result["launches"]["joint_bwd"] / result["steps"]
    check(per_step > 0 and seen["joint_bwd_a"] == 2 * per_step,
          f"the profiled {what} step ran {seen['joint_bwd_a']} joint_bwd_a "
          f"kernels, not 2 for each of its {per_step} joint_bwd calls")
    check(per_step > 0 and seen["joint_bwd_b"] == 2 * per_step,
          f"the profiled {what} step ran {seen['joint_bwd_b']} joint_bwd_b "
          f"kernels, not 2 for each of its {per_step} joint_bwd calls")
    band = {k: seen[k] for k in ("band_fwd", "band_bwd_a", "band_bwd_b",
                                 "band_sums")}
    check(not any(band.values()),
          f"the profiled {what} step launched band kernels: {band}")


def check_band_profile(prof: dict, result: dict, what: str) -> None:
    """A profiled band step (bf16 W, J % 16 == 0, V even) runs each K6
    kernel in its tensor-core form, two launches a call: K6-fwd's W^T pass
    and ring kernel (the family `band_fwd`), K6-A's W^T pass and ring
    kernel (`band_bwd_a_`), K6-B's zb pass and ring kernel
    (`band_bwd_b_`)."""
    seen = prof["device_launches"]
    for fam, name in (("band_fwd", "band_lp_fwd"),
                      ("band_bwd_a", "band_lp_bwd_a"),
                      ("band_bwd_b", "band_lp_bwd_b")):
        per_step = result["launches"][name] / result["steps"]
        check(per_step > 0 and seen[fam] == 2 * per_step,
              f"the profiled {what} step ran {seen[fam]} {fam} kernels, not "
              f"2 for each of its {per_step} {name} calls")


def check_lstm_launches(prof: dict, result: dict, what: str) -> None:
    """K4-fwd and K4-bwd are one launch per LSTM layer call: the profiled
    step's lstm_fwd and lstm_bwd kernels number their wrappers' calls a
    step (5 each at libri100: 4 encoder layers and the predictor; the AR
    aligner's forward adds its own), not one per time step."""
    counts, steps = result["launches"], result["steps"]
    for fam, calls in (("lstm_fwd", counts["lstm_fwd"]
                        + counts["lstm_fwd_with_acts"]),
                       ("lstm_bwd", counts["lstm_bwd"])):
        per_step = calls / steps
        seen = prof["device_launches"][fam]
        check(per_step > 0 and seen == per_step,
              f"the profiled {what} step ran {seen} {fam} kernels, not the "
              f"{per_step} layer calls a step")


def lattice_ms(dev, seed: int) -> dict:
    """The loss's lattice layer at the training shape, through K3 and
    through the plain versions, masking and gathers included:
    forward_from_lp_with_alpha (alpha) and occupancies_from_lp (beta and
    the occupancies); CUDA events, one run of each (`timed_pair`)."""
    rng = np.random.default_rng(seed)
    lpb, lpy, fl, ll = lattice_scores(rng, dev, TRAIN_B, TRAIN_T // 2,
                                      TRAIN_U)
    alpha = rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)[1]

    def plain(fn):
        def run():
            with plain_kernels():
                fn()
        return run

    def fwd():
        rl.forward_from_lp_with_alpha(lpb, lpy, fl, ll)

    def occ():
        rl.occupancies_from_lp(lpb, lpy, fl, ll, alpha)

    ka, pa = timed_pair(fwd, plain(fwd))
    kb, pb = timed_pair(occ, plain(occ))
    return {"alpha_kernel_ms": ka, "alpha_plain_ms": pa,
            "beta_occupancies_kernel_ms": kb,
            "beta_occupancies_plain_ms": pb}


def leaf_paths(tree, path: str = ""):
    """'/'-joined dict keys and list indices of every leaf, in the order
    of torch's pytree flatten (dicts in insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{path}/{i}")
    else:
        yield path


def f32_kernels_vs_plain(seed: int, dev, loss_impl: str = "fused",
                         U: int = TRAIN_U, cfg=None,
                         B: int = TRAIN_B, T: int = TRAIN_T,
                         **loss_kw) -> dict:
    """One f32 loss and gradient of the model (libri100 unless `cfg` is
    given), B utterances, T=400, U labels, through the kernels and through
    the plain versions.

    The conformer's attention key bias gets no gradient in exact
    arithmetic (each query's softmax is invariant to the shift q . b_k of
    all its logits): both sides give f32 rounding noise there, so those
    leaves are held to 1e-4 of the largest gradient instead of to each
    other."""
    cfg = dataclasses.replace(cfg or config_libri100(),
                              compute_dtype="float32")
    params = m.init_params(cfg, np.random.default_rng(seed + 2), dev)
    batch = bench_batch(cfg, seed + 2, dev, U, B, T)
    flat, spec = torch.utils._pytree.tree_flatten(params)
    names = list(leaf_paths(params))
    check(len(names) == len(flat), "leaf_paths disagrees with the pytree")
    noise = [n.endswith("/att/k/b") for n in names]

    def loss_and_grads(plain: bool):
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        with ctx:
            xs = [p.detach().requires_grad_(True) for p in flat]
            loss, _ = tl.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec),
                                 cfg, *batch, loss_impl=loss_impl, **loss_kw)
            grads = torch.autograd.grad(loss, xs)
        return float(loss.detach()), grads

    lk, gk = loss_and_grads(plain=False)
    lp, gp = loss_and_grads(plain=True)
    loss_rel = abs(lk - lp) / abs(lp)
    worst = max(rel_err(a, b) for a, b, z in zip(gk, gp, noise) if not z)
    top = max(float(a.abs().max()) for a in gp)
    noise_max = max([float(a.abs().max()) for a, z in zip(gk + gp,
                                                          noise + noise)
                     if z] or [0.0])
    row = {"model": "conformer" if cfg.enc_type == "conformer" else "lstm",
           "B": B, "T": T, "loss_impl": loss_impl, "U": U, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_err": loss_rel,
           "loss_rtol": LOSS_RTOL, "grad_worst_rel_err": worst,
           "grad_rtol": GRAD_RTOL, "leaves": len(gk),
           "key_bias_leaves": sum(noise), "key_bias_max_abs": noise_max,
           "max_abs_grad": top}
    print("train_f32_kernels_vs_plain " + json.dumps(row))
    check(loss_rel <= LOSS_RTOL,
          f"f32 loss ({loss_impl}): kernels {lk} vs plain {lp}")
    check(worst <= GRAD_RTOL,
          f"f32 gradients ({loss_impl}): worst rel err {worst}")
    check(noise_max <= 1e-4 * top,
          f"f32 key-bias gradients {noise_max} above noise level")
    return row


def trees_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def cli_round_trip(dev) -> dict:
    """The training CLI for 3 steps with a checkpoint; the checkpoint
    restores to the state the CLI ended with."""
    with tempfile.TemporaryDirectory() as d:
        argv = ["--config", "libri100", "--data", "synthetic", "--steps", "3",
                "--batch-size", "8", "--max-frames", "200", "--max-labels",
                "20", "--warmup-steps", "1", "--log-every", "1",
                "--ckpt-dir", d, "--device", dev.type]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = train_cli(argv)
        last = json.loads(out.getvalue().strip().splitlines()[-1])
        restored, step = ckpt.restore_checkpoint(d, device=dev)
    same = (step == state.step == 3
            and trees_equal(restored.params, state.params)
            and trees_equal(restored.opt_state, state.opt_state))
    row = {"final_json": last, "restored_step": step,
           "restored_equals_state": same}
    print("train_cli " + json.dumps(row))
    check(last.get("steps") == 3 and np.isfinite(last.get("final_loss")),
          f"training CLI final line {last}")
    check(same, "the restored checkpoint differs from the CLI's state")
    return row


def cli_json(argv: list, steps: int, what: str) -> dict:
    """The training CLI in this process; its last stdout line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli(argv)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"train_cli_{what} " + json.dumps(last))
    check(last.get("steps") == steps and np.isfinite(last.get("final_loss")),
          f"training CLI ({what}): final line {last}")
    return last


def timed_steps(step, state, batch, B: int = TRAIN_B):
    """One step, then bench.py's slope runs (SLOPE_STEPS steps, best of
    SLOPE_REPEATS), with the launch counts of exactly these steps."""
    infos = []
    reset_counts()
    t0 = time.perf_counter()
    state, info = step(state, *batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    infos.append(info)
    times = []
    for n in SLOPE_STEPS:
        best = float("inf")
        for _ in range(SLOPE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                state, info = step(state, *batch)
                infos.append(info)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times.append(best)
    counts = read_counts()
    dt = (times[1] - times[0]) / (SLOPE_STEPS[1] - SLOPE_STEPS[0])
    losses = [float(i["loss"]) for i in infos]
    gnorms = [float(i["grad_norm"]) for i in infos]
    skipped = sum(int(i["skipped_nonfinite"]) for i in infos)
    result = {"steps": len(infos), "first_step_s": first_s,
              "ms_per_step": dt * 1e3, "utt_per_s": B / dt,
              "slope_times_s": times, "loss_first": losses[0],
              "loss_last": losses[-1], "grad_norm_last": gnorms[-1],
              "skipped_nonfinite": skipped,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts}
    check(all(np.isfinite(x) for x in losses + gnorms),
          "non-finite loss or grad norm in a training step")
    check(skipped == 0, f"{skipped} training steps skipped as non-finite")
    return state, result


def train_run(seed: int, dev, loss_impl: str, U: int, cfg=None,
              B: int = TRAIN_B, T: int = TRAIN_T, **tcfg_kw):
    """A fresh state (libri100 unless `cfg` is given) trained on bench.py's
    batch of B utterances with U labels: the step, its state after the
    timed steps, the batch and the result."""
    cfg = cfg or config_libri100()
    tcfg = TrainConfig(batch_size=B, warmup_steps=100,
                       total_steps=10000,  # bench.py's TrainConfig
                       loss_impl=loss_impl, **tcfg_kw)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev)
    step = tl.make_train_step(cfg, tcfg)
    batch = bench_batch(cfg, seed, dev, U, B, T)
    p0 = [p.clone() for p in leaves(state.params)]
    torch.cuda.reset_peak_memory_stats()
    state, result = timed_steps(step, state, batch, B)
    moved = max(float((a - b).abs().max())
                for a, b in zip(leaves(state.params), p0))
    result = {"B": B, "T": T, "U": U, "dtype": "bfloat16",
              "loss_impl": loss_impl, **result, "param_max_change": moved}
    check(moved > 0.0, "the params did not change over the training steps")
    return step, state, batch, result


def train_phase(seed: int, dev, profile_dir) -> dict:
    step, state, batch, result = train_run(seed, dev, "auto", TRAIN_U)
    print("train " + json.dumps(result))
    counts = result["launches"]
    for name in ("lstm_fwd_with_acts", "lstm_bwd", "joint_fwd", "joint_bwd",
                 "lattice_alpha", "lattice_beta"):
        check(counts[name] > 0, f"the training step never launched {name}")
    check_no_band(counts, "the fused training step")

    state, prof = profile_step(step, state, batch, profile_dir)
    print("train_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "libri100")
    check_fused_joint_profile(prof, result, "libri100")
    lat_ms = lattice_ms(dev, seed)
    print("train_lattice " + json.dumps(lat_ms))
    result["profile"], result["lattice"] = prof, lat_ms
    result["f32"] = f32_kernels_vs_plain(seed, dev)
    result["cli"] = cli_round_trip(dev)
    return result


def train_pallas_phase(seed: int, dev, profile_dir) -> dict:
    """The two-pass route (loss_impl="pallas") at B=32, T=400, U=80, then
    the same batch through the fused route; the f32 check of the
    two-pass route; the CLI with --loss-impl pallas."""
    step, state, batch, result = train_run(seed, dev, "pallas", PALLAS_U)
    print("train_pallas " + json.dumps(result))
    counts = result["launches"]
    for name in ("extract_lp", "assemble_grad", "lattice_alpha",
                 "lattice_beta", "lstm_fwd_with_acts", "lstm_bwd"):
        check(counts[name] > 0,
              f"the two-pass training step never launched {name}")
    check(counts["joint_fwd"] == counts["joint_bwd"] == 0,
          "the two-pass training step launched the fused joint kernels")
    check_no_band(counts, "the two-pass training step")
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_pallas_step")
    print("train_pallas_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "two-pass")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()

    fused = train_run(seed, dev, "fused", PALLAS_U)[3]
    print("train_fused_U80 " + json.dumps(fused))
    check_no_band(fused["launches"], "the fused step at U=80")
    result["fused_same_batch"] = fused
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "pallas", PALLAS_U)

    result["cli"] = cli_json(
        ["--config", "libri100", "--data", "synthetic", "--steps", "2",
         "--batch-size", "8", "--max-frames", "200", "--max-labels", "20",
         "--warmup-steps", "1", "--log-every", "1", "--loss-impl", "pallas",
         "--device", dev.type], 2, "pallas")
    return result


def train_conformer_phase(seed: int, dev, profile_dir) -> dict:
    """libri100_conformer at bench.py's B=64, T=400, U=40 through the
    default loss (fused on the card): K8-bwd at each of the 48 LayerNorms
    of every step, with K4 (the predictor), K1, K2 and K3; a profiled
    step; the f32 check; the CLI for 3 steps."""
    cfg = config_libri100_conformer()
    step, state, batch, result = train_run(seed, dev, "auto", CONF_U, cfg,
                                           CONF_B)
    counts, steps = result["launches"], result["steps"]
    result["fused_ln_bwd_per_step"] = counts["fused_ln_bwd"] / steps
    print("train_conformer " + json.dumps(result))
    for name in ("fused_ln_fwd", "fused_ln_bwd"):
        check(counts[name] == LN_PER_ENCODE * steps,
              f"the conformer step launched {name} {counts[name]} times in "
              f"{steps} steps, not {LN_PER_ENCODE} a step")
    for name in ("lstm_fwd_with_acts", "lstm_bwd", "joint_fwd", "joint_bwd",
                 "lattice_alpha", "lattice_beta"):
        check(counts[name] > 0, f"the conformer step never launched {name}")
    check_no_band(counts, "the conformer step")
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_conformer_step")
    print("train_conformer_profile " + json.dumps(prof))
    # one K8-fwd and one K8-bwd kernel a LayerNorm: K8-bwd is one launch
    check(prof["device_launches"]["fused_ln"] == 2 * LN_PER_ENCODE,
          f"the profiled conformer step ran "
          f"{prof['device_launches']['fused_ln']} LayerNorm kernels, not "
          f"{2 * LN_PER_ENCODE}")
    check_lstm_launches(prof, result, "conformer")
    check_fused_joint_profile(prof, result, "conformer")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "fused", CONF_U, cfg,
                                         CONF_B)
    torch.cuda.empty_cache()
    result["cli"] = cli_json(
        ["--config", "libri100_conformer", "--data", "synthetic", "--steps",
         "3", "--batch-size", "8", "--max-frames", "400", "--max-labels",
         "20", "--warmup-steps", "1", "--log-every", "1", "--device",
         dev.type], 3, "conformer")
    return result


def short_run(seed: int, dev, loss_impl: str, U: int, cfg,
              B: int = TRAIN_B, n: int = 2) -> dict:
    """A fresh state, one warm step, then n steps timed by the host clock
    ending in a synchronise: a context number for a route too slow for the
    slope runs, not a slope."""
    tcfg = TrainConfig(batch_size=B, warmup_steps=100, total_steps=10000,
                       loss_impl=loss_impl)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev)
    step = tl.make_train_step(cfg, tcfg)
    batch = bench_batch(cfg, seed, dev, U, B)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, info = step(state, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, info = step(state, *batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    return {"B": B, "T": TRAIN_T, "U": U, "V": cfg.vocab_size,
            "loss_impl": loss_impl, "timed_steps": n, "ms_per_step": ms,
            "utt_per_s": B / ms * 1e3, "loss_last": float(info["loss"]),
            "skipped_nonfinite": int(info["skipped_nonfinite"]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": read_counts()}


def check_band_step(result: dict, what: str, per_step_k3: int) -> None:
    """One launch of each K6 kernel a step, `per_step_k3` of each K3 kernel,
    the LSTM kernels, and not the full lattice's joint kernels."""
    counts, steps = result["launches"], result["steps"]
    for name in BAND_KERNELS:
        check(counts[name] == steps,
              f"the {what} step launched {name} {counts[name]} times in "
              f"{steps} steps, not once a step")
    for name in ("lattice_alpha", "lattice_beta"):
        check(counts[name] == per_step_k3 * steps,
              f"the {what} step launched {name} {counts[name]} times in "
              f"{steps} steps, not {per_step_k3} a step")
    for name in ("lstm_fwd_with_acts", "lstm_bwd"):
        check(counts[name] > 0, f"the {what} step never launched {name}")
    check(counts["joint_fwd"] == counts["joint_bwd"] == 0,
          f"the {what} step launched the full lattice's joint kernels")


def train_pruned_phase(seed: int, dev, profile_dir) -> dict:
    """The pruned two-pass loss at its card shape: libri100 with V=8192,
    S=8, B=32, T=400, U=100, bf16, simple_loss_scale 0.5. K6 once each a
    step; K3 three times each (the simple pass's alpha and beta, the
    bounds' occupancies, the band's alpha and beta); a profiled step; the
    full lattice's K1 / K2 on the same batch for context; the f32 check;
    the CLI with --pruned-range 8 on a JSON config."""
    cfg = dataclasses.replace(config_libri100(), vocab_size=PRUNED_V,
                              pruned_range=PRUNED_S)
    step, state, batch, result = train_run(seed, dev, "pruned", PRUNED_U,
                                           cfg)
    result.update(V=PRUNED_V, S=PRUNED_S)
    print("train_pruned " + json.dumps(result))
    check_band_step(result, "pruned", 3)
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_pruned_step")
    print("train_pruned_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "pruned")
    check_band_profile(prof, result, "pruned")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()
    fused = short_run(seed, dev, "fused", PRUNED_U, cfg)
    print("train_fused_V8192 " + json.dumps(fused))
    check_no_band(fused["launches"], "the fused step")
    result["fused_same_batch"] = fused
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "pruned", PRUNED_U, cfg)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "libri100_v8192.json")
        with open(path, "w") as fh:
            json.dump({k: v for k, v in dataclasses.asdict(
                dataclasses.replace(cfg, pruned_range=0)).items()
                if not isinstance(v, tuple)}, fh)
        result["cli"] = cli_json(
            ["--config", path, "--pruned-range", str(PRUNED_S), "--data",
             "synthetic", "--steps", "3", "--batch-size", "8",
             "--max-frames", "200", "--max-labels", "20", "--warmup-steps",
             "1", "--log-every", "1", "--device", dev.type], 3, "pruned")
    return result


def train_ar_phase(seed: int, dev, profile_dir) -> dict:
    """The alignment-restricted band at libri100's B=32, T=400, U=40,
    ar_range 8 (centred), self-aligned: the live model's Viterbi path under
    no_grad, then the banded loss through K6 once each a step and K3 once
    each (the band's alpha and beta); a profiled step; the f32 check; the
    CLI with --ar-range 8."""
    cfg = config_libri100()
    step, state, batch, result = train_run(seed, dev, "auto", TRAIN_U, cfg,
                                           ar_range=AR_S)
    result.update(ar_range=AR_S, ar_left=-1)
    print("train_ar " + json.dumps(result))
    check_band_step(result, "AR", 1)
    state, prof = profile_step(step, state, batch, profile_dir,
                               "train_ar_step")
    print("train_ar_profile " + json.dumps(prof))
    check_lstm_launches(prof, result, "AR")
    check_band_profile(prof, result, "AR")
    result["profile"] = prof
    del step, state, batch
    torch.cuda.empty_cache()
    result["f32"] = f32_kernels_vs_plain(seed, dev, "ar", TRAIN_U, cfg,
                                         ar_range=AR_S)
    torch.cuda.empty_cache()
    result["cli"] = cli_json(
        ["--config", "libri100", "--ar-range", str(AR_S), "--data",
         "synthetic", "--steps", "3", "--batch-size", "8", "--max-frames",
         "200", "--max-labels", "20", "--warmup-steps", "1", "--log-every",
         "1", "--device", dev.type], 3, "ar")
    return result


# ------------------------------ phase 5f ---------------------------------
# BASELINE.json's configs[1] and configs[4] at full width, random weights
# from the seed. TIMIT: the 3x320 BiLSTM (no frame stacking, 1x320
# predictor, joint 320, V=63) at a batch of 16 utterances of T=300 frames
# (3 s) and U=40 phones; served requests of 1-3 s. libri960: the 6x1024
# LSTM (2x stacking, 2x1024 predictor, embed 512, joint 1024, V=32) at
# bench.py's B=64, T=400, U=60 (bench.py:126-133), where `auto` takes the
# two-pass loss (J > MAX_J), and its f32 kernel-vs-plain step at the same
# B=64 (so the K4 kernels take the timed step's tiles) and a short T=64,
# U=10 (the plain recurrences run step by step).
TIMIT_B, TIMIT_T, TIMIT_U = 16, 300, 40
TIMIT_FRAMES, TIMIT_BUCKET = (100, 300), 400
L960_B, L960_T, L960_U = 64, 400, 60
L960_F32 = dict(B=L960_B, T=64, U=10)
# The BiLSTM encode's bf16 kernel-vs-plain bound: ATOL's 2e-2 for each of
# TIMIT's three layers (both sides round the same operands; a 1-ulp gap
# before a rounding flips a bf16 value, and the flips carry into the next
# layer).
BILSTM_BF16_ATOL = 3 * ATOL[torch.bfloat16]
TRAJECTORY_STEPS = 3
# Two gloo ranks share the card at libri960 width: one f32 step, then
# DP_STEPS bf16 steps (the first warms the ranks' kernels and handles;
# the others are timed). A collective waits at most DP_TIMEOUT_S.
DP_RANKS, DP_STEPS, DP_TIMEOUT_S = 2, 4, 600


def bilstm_encode_vs_plain(seed: int, dev) -> dict:
    """TIMIT's BiLSTM `encode` at B=16, T=300, ragged lengths (one row of a
    single frame) through the kernels and the plain versions: 6 K4-fwd
    launches (3 layers x 2 directions), f32 within ATOL, bf16 within
    BILSTM_BF16_ATOL (the output is masked past each row's length)."""
    cfg = config_timit()
    rng = np.random.default_rng(seed)
    params = m.init_params(cfg, rng, dev)
    B, T = TIMIT_B, TIMIT_T
    feats = torch.from_numpy(rng.normal(size=(B, T, cfg.input_dim)).astype(
        np.float32)).to(dev)
    lens = rng.integers(T // 3, T + 1, size=B)
    lens[0], lens[1] = T, 1
    lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    row = {"B": B, "T": T, "H": cfg.enc_hidden, "layers": cfg.enc_layers,
           "lens_min": int(lens.min())}
    for cd in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        with torch.inference_mode():
            reset_counts()
            got = m.encode(params, c, feats, lens)[0]
            torch.cuda.synchronize()
            n = read_counts()["lstm_fwd"]
            kms = cuda_ms(lambda: m.encode(params, c, feats, lens))
            with plain_kernels():
                want = m.encode(params, c, feats, lens)[0]
                pms = cuda_ms(lambda: m.encode(params, c, feats, lens))
        tol = ATOL[torch.float32] if cd == "float32" else BILSTM_BF16_ATOL
        err = max_abs(got, want)
        row[cd] = {"max_abs_err": err, "atol": tol, "kernel_ms": kms,
                   "plain_ms": pms, "lstm_fwd_launches": n}
        check(n == 2 * cfg.enc_layers,
              f"TIMIT encode {cd}: {n} K4-fwd launches, not "
              f"{2 * cfg.enc_layers}")
        check(err <= tol, f"TIMIT BiLSTM encode {cd}: kernels vs plain "
                          f"{err} > {tol}")
    print("timit_encode " + json.dumps(row))
    return row


def f32_trajectory_vs_plain(cfg, seed: int, dev, B: int, T: int,
                            U: int) -> list:
    """TRAJECTORY_STEPS f32 training steps of `cfg` through the kernels on
    a ragged batch; at each step the loss and gradients of its params
    through the kernels and through the plain versions: the loss within
    LOSS_RTOL, every gradient leaf within GRAD_RTOL of its largest value,
    no step skipped."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    # no warmup: every step moves the params
    tcfg = TrainConfig(batch_size=B, warmup_steps=0, total_steps=100)
    state = tl.init_train_state(np.random.default_rng(seed + 2), cfg, tcfg,
                                dev)
    step = tl.make_train_step(cfg, tcfg)
    batch = bench_batch(cfg, seed + 2, dev, U, B, T, ragged=True)
    rows = []
    for i in range(TRAJECTORY_STEPS):
        flat, spec = torch.utils._pytree.tree_flatten(state.params)
        lk, gk = tl.loss_and_grads(flat, spec, cfg, *batch)
        with plain_kernels():
            lp, gp = tl.loss_and_grads(flat, spec, cfg, *batch)
        lk, lp = float(lk), float(lp)
        row = {"step": i, "loss_kernels": lk, "loss_plain": lp,
               "loss_rel_err": abs(lk - lp) / abs(lp),
               "grad_worst_rel_err": max(rel_err(a, b)
                                         for a, b in zip(gk, gp)),
               "leaves": len(gk)}
        del gk, gp
        state, info = step(state, *batch)
        row.update(step_loss=float(info["loss"]),
                   skipped=int(info["skipped_nonfinite"]))
        rows.append(row)
        check(row["loss_rel_err"] <= LOSS_RTOL
              and row["grad_worst_rel_err"] <= GRAD_RTOL
              and row["skipped"] == 0,
              f"f32 trajectory step {i}: kernels vs plain {row}")
    print("train_f32_trajectory " + json.dumps(
        {"enc_hidden": cfg.enc_hidden, "bidirectional": cfg.bidirectional,
         "B": B, "T": T, "U": U, "steps": rows}))
    return rows


def check_step_counts(result: dict, want: dict, what: str) -> None:
    """Each kernel's launches over the timed steps: `want` a step."""
    counts, steps = result["launches"], result["steps"]
    for name, per_step in want.items():
        check(counts[name] == per_step * steps,
              f"{what}: {counts[name]} {name} launches in {steps} steps, "
              f"not {per_step} a step")
    check_no_band(counts, what)


def joint_cuda_core_ms(seed: int, dev, B, T, U, J, V) -> dict:
    """K1 and K2 at a joint whose V is odd, where both take their
    CUDA-core form at bf16 (TIMIT's V=63): against their plain versions,
    ms of each by CUDA events in turns, beside the bound."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(J)
    f = torch.from_numpy(0.5 * rng.normal(size=(B, T, J))).float().to(dev)
    g = torch.from_numpy(0.5 * rng.normal(size=(B, U + 1, J))).float().to(dev)
    w = torch.from_numpy(rng.uniform(-k, k, (J, V))).to(torch.bfloat16).to(
        dev)
    b = torch.from_numpy(rng.uniform(-k, k, V)).float().to(dev)
    labels = torch.from_numpy(rng.integers(1, V, (B, U))).int().to(dev)
    fl = torch.full((B,), T, dtype=torch.int32, device=dev)
    ll = torch.full((B,), U, dtype=torch.int32, device=dev)
    gbar = torch.full((B,), 1.0 / B, device=dev)
    fwd_args = (f, g, labels, w, b)
    want = jf.joint_lp_fwd_reference(*fwd_args)
    got = jf.joint_lp_fwd(*fwd_args)
    gb, gy = rl.occupancies_from_lp(want[0], want[1], fl, ll)
    bwd_args = (f, g, labels, w, b, gb, gy, want[2], gbar)
    want_b = jf.joint_lp_bwd_reference(*bwd_args)
    got_b = jf.joint_lp_bwd(*bwd_args)
    err_f = max(max_abs(x, y) for x, y in zip(got, want))
    rel_b = max(rel_err(x, y) for x, y in zip(got_b, want_b))
    kf, pf = timed_pair(lambda: jf.joint_lp_fwd(*fwd_args),
                        lambda: jf.joint_lp_fwd_reference(*fwd_args))
    kb, pb = timed_pair(lambda: jf.joint_lp_bwd(*bwd_args),
                        lambda: jf.joint_lp_bwd_reference(*bwd_args))
    ops = 2 * B * T * (U + 1) * J * V
    row = {"B": B, "T": T, "U1": U + 1, "J": J, "V": V, "dtype": "bfloat16",
           "tensor_core_form": jf.tensor_core_form(torch.bfloat16, J, V),
           "fwd_max_abs_err": err_f, "bwd_max_rel_err": rel_b,
           "fwd_kernel_ms": kf, "fwd_plain_ms": pf, "bwd_kernel_ms": kb,
           "bwd_plain_ms": pb,
           "fwd_bound": bound(nbytes(fwd_args, got), ops, torch.bfloat16),
           "bwd_bound": bound(nbytes(bwd_args, got_b), 3 * ops,
                              torch.bfloat16)}
    print("kernel joint_cuda_core " + json.dumps(row))
    check(not row["tensor_core_form"], "odd V took the ring form")
    check(err_f <= ATOL[torch.bfloat16] and rel_b <= REL_TOL[torch.bfloat16],
          f"K1 / K2 at odd V: fwd err {err_f}, bwd rel err {rel_b}")
    return row


# The served TIMIT and libri960 models, made to emit along an utterance
# (`emitting_model`): the joint's predictor side standardized to
# EMIT_PRED_STD over EMIT_WALKS random-token walks of EMIT_DEPTH steps and
# the repeated-token runs, its encoder side to 1 over EMIT_CAL_UTTS
# calibration utterances. Chosen on the H100 among predictor stds 1-3
# (and encoder input gains 1-8): the one that left both models a few
# tokens an utterance and no calibration utterance at max_symbols.
EMIT_PRED_STD = 3.0
EMIT_WALKS, EMIT_DEPTH, EMIT_CAL_UTTS = 8, 16, 8


def emitting_model(params, cfg, dev, rng, frames) -> dict:
    """Make a random LSTM transducer (params, in place) emit a few tokens
    along an utterance; its calibration. At init a deep random LSTM
    barely sees its input (libri960's joint input varies ~3e-4 over
    frames against a mean of ~6e-3), and every emission moves the
    predictor's output the same way: with `blank_offset` each utterance
    emits nothing or runs to max_symbols on its first frames, and the
    token checks compare empty or frame-blind lists. Here the joint's
    encoder side is standardized over the frames of EMIT_CAL_UTTS
    calibration utterances (mean 0, std 1 a unit); the predictor's drift
    with the number of emissions (the means over walks at each depth) is
    projected out of pred_proj and the rest standardized to
    EMIT_PRED_STD; and blank's offset is the least, by bisection to
    2^-11 over [-4, 4], at which no calibration utterance reaches
    max_symbols, in f32 or in `cfg`'s compute dtype (the engine's)."""
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    n, V, jp = EMIT_CAL_UTTS, cfg.vocab_size, params["joint"]
    feats = torch.from_numpy(rng.normal(size=(n, frames[1], cfg.input_dim))
                             ).float().to(dev)
    lens = torch.from_numpy(np.linspace(frames[0], frames[1], n).astype(
        np.int32)).to(dev)
    walks = torch.cat([torch.from_numpy(rng.integers(1, V, (
        EMIT_DEPTH, EMIT_WALKS))).to(dev),
        torch.arange(1, V, device=dev).repeat(EMIT_DEPTH, 1)], 1)
    with torch.no_grad():
        enc, el = m.encode(params, f32, feats, lens)
        enc = torch.cat([enc[b, :int(el[b])] for b in range(n)])
        state = m.init_pred_state(f32, walks.shape[1], dev)
        label = torch.full((walks.shape[1],), cfg.blank, device=dev)
        preds = []
        for d in range(EMIT_DEPTH + 1):
            pred, state = m.predict_step(params, f32, label, state)
            preds.append(pred)
            label = walks[min(d, EMIT_DEPTH - 1)]
        preds = torch.stack(preds)  # (depth + 1, walks, H)
        means = preds.mean(1)
        q = torch.linalg.qr((means - means.mean(0)).T)[0]
        w = jp["pred_proj"]["w"]
        w -= q @ (q.T @ w)
        row = {"pred_std": EMIT_PRED_STD}
        for side, x, std in (("enc_proj", enc, 1.0),
                             ("pred_proj", preds.flatten(0, 1),
                              EMIT_PRED_STD)):
            z = x @ jp[side]["w"]
            scale = std / float(z.std(0).mean())
            row[f"{side}_frame_std" if side == "enc_proj" else
                f"{side}_state_std"] = float(z.std(0).mean())
            jp[side]["w"] *= scale
            jp[side]["b"] -= scale * z.mean(0)
    blank_b = jp["out"]["b"][cfg.blank].clone()
    lo, hi, trace = -4.0, 4.0, []
    for _ in range(14):
        mid = (lo + hi) / 2
        jp["out"]["b"][cfg.blank] = blank_b + mid
        with torch.inference_mode():
            k = [recognize_greedy(params, c, feats, lens, MAX_SYMBOLS)[1]
                 .tolist() for c in (f32, cfg)]
        trace.append((mid, k))
        if max(max(k[0]), max(k[1])) >= MAX_SYMBOLS:
            lo = mid
        else:
            hi = mid
    check(hi < 4.0, f"no blank offset up to 4 keeps the calibration "
                    f"utterances under {MAX_SYMBOLS} tokens: {trace}")
    jp["out"]["b"][cfg.blank] = blank_b + hi
    row.update(offset=hi, calibration_tokens=dict(trace)[hi])
    return row


def emitting_setup(seed: int, n: int, dev, cfg, frames, what: str) -> dict:
    """serving_setup's requests, to `cfg`'s random model made to emit by
    `emitting_model` (calibrated on utterances of its own)."""
    serving = serving_setup(seed, n, dev, cfg, frames)
    params = serving["params"]
    params["joint"]["out"]["b"][cfg.blank] -= serving["offset"]
    cal = emitting_model(params, cfg, dev, np.random.default_rng(seed + 1),
                         frames)
    print("emitting_model " + json.dumps({"what": what, **cal}))
    return {**serving, "offset": cal["offset"], "calibration": cal}


def config_serving(cfg, seed: int, n: int, dev, frames, bucket: int,
                   int8: bool, what: str,
                   serving: dict | None = None) -> tuple[dict, dict]:
    """n requests to a BatchingEngine of `cfg` (made to emit by
    `emitting_setup`) at serve.py's defaults, float and (int8=True) int8:
    one K4-fwd launch a layer direction a batch (K7 under int8 where the
    W8A8 route runs, else K4-fwd on the dequantized w_hh), a mean of
    tokens a request strictly between 0 and max_symbols, and one served
    batch's f32 tokens equal through the kernels and the plain
    versions. `serving`: emitting_setup's result, where the caller made
    it already."""
    serving = serving or emitting_setup(seed, n, dev, cfg, frames, what)
    params = serving["params"]
    feats, lens = served_batch(serving, dev, bucket)
    per_batch = cfg.enc_layers * (2 if cfg.bidirectional else 1)
    w8a8 = int8 and w8a8_supported(MAX_BATCH, cfg.enc_hidden)
    out = {}
    for name, p in (("float", params),) + ((("int8", quantize_params(
            params)),) if int8 else ()):
        _, res, counts = serve_all(serving, p, dev)
        k = "lstm_fwd_int8" if name == "int8" and w8a8 else "lstm_fwd"
        other = "lstm_fwd" if k == "lstm_fwd_int8" else "lstm_fwd_int8"
        res.update(launches=counts[k], kernel=k)
        print(f"{what}_{name} " + json.dumps(res))
        check(counts[k] == per_batch * res["batches"]
              and counts[other] == 0,
              f"{what} {name}: {counts[k]} {k} and {counts[other]} {other} "
              f"launches in {res['batches']} batches, not {per_batch} {k} "
              "a batch")
        check_no_band(counts, f"{what} {name}")
        check(0 < res["mean_tokens"] < MAX_SYMBOLS,
              f"{what} {name}: {res['mean_tokens']} tokens a request on "
              f"average, not between 0 and {MAX_SYMBOLS}")
        res["kernel_vs_plain"] = kernel_vs_plain_tokens(p, cfg, feats, lens,
                                                        f"{what} {name}")
        res["kernel_vs_plain"].pop("enc_f32")
        out[name] = res
    return out, serving


@contextlib.contextmanager
def part(seconds: dict, name: str):
    """The wall seconds of the block, into seconds[name]."""
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0


def timit_phase(seed: int, dev, profile_dir) -> dict:
    """Phase 5f (a): configs[1], TIMIT's 3x320 BiLSTM."""
    cfg = config_timit()
    out, sec = {}, {}
    with part(sec, "encode"):
        out["encode"] = bilstm_encode_vs_plain(seed + 40, dev)
    with part(sec, "f32_trajectory"):
        out["f32_trajectory"] = f32_trajectory_vs_plain(
            cfg, seed + 41, dev, TIMIT_B, TIMIT_T, TIMIT_U)
    torch.cuda.empty_cache()
    with part(sec, "train"):
        step, state, batch, result = train_run(seed + 42, dev, "auto",
                                               TIMIT_U, cfg, TIMIT_B,
                                               TIMIT_T)
        layer_calls = 2 * cfg.enc_layers + cfg.pred_layers  # 7
        check_step_counts(result, {"lstm_fwd_with_acts": layer_calls,
                                   "lstm_bwd": layer_calls, "lstm_fwd": 0,
                                   "joint_fwd": 1, "joint_bwd": 1,
                                   "lattice_alpha": 1, "lattice_beta": 1,
                                   "extract_lp": 0, "assemble_grad": 0},
                          "the TIMIT step")
        state, prof = profile_step(step, state, batch, profile_dir,
                                   "train_timit_step")
        check_lstm_launches(prof, result, "TIMIT")
        jk = prof["joint_kernels"]
        check(jk.get("joint_fwd_kernel") == 1
              and jk.get("joint_bwd_a_kernel") == 1
              and jk.get("joint_bwd_b_kernel") == 1
              and not any(("ring" in n or "_wt" in n or "_zb" in n)
                          for n in jk),
              f"the TIMIT step's joint kernels {jk}: not K1 / K2's "
              "CUDA-core form (V = 63 is odd)")
        result["profile"] = prof
        print("train_timit " + json.dumps(result))
        out["train"] = result
        del step, state, batch
        torch.cuda.empty_cache()
    with part(sec, "joint"):
        out["joint"] = joint_cuda_core_ms(seed + 43, dev, TIMIT_B, TIMIT_T,
                                          TIMIT_U, cfg.joint_dim,
                                          cfg.vocab_size)
    with part(sec, "serve"):
        out["serve"], _ = config_serving(
            cfg, seed + 44, MAX_BATCH, dev, TIMIT_FRAMES, TIMIT_BUCKET, True,
            "timit_serve")
    torch.cuda.empty_cache()
    print("configs_seconds " + json.dumps({"timit": sec}))
    return out


def libri960_phase(seed: int, dev, profile_dir, n_requests: int) -> dict:
    """Phase 5f (b): configs[4], libri960's 6x1024 LSTM."""
    cfg = config_libri960()
    out, sec = {}, {}
    with part(sec, "train"):
        step, state, batch, result = train_run(seed + 50, dev, "auto",
                                               L960_U, cfg, L960_B, L960_T)
        layer_calls = cfg.enc_layers + cfg.pred_layers  # 8
        check_step_counts(result, {"lstm_fwd_with_acts": layer_calls,
                                   "lstm_bwd": layer_calls, "lstm_fwd": 0,
                                   "extract_lp": 1, "assemble_grad": 1,
                                   "lattice_alpha": 1, "lattice_beta": 1,
                                   "joint_fwd": 0, "joint_bwd": 0},
                          "the libri960 step")
        state, prof = profile_step(step, state, batch, profile_dir,
                                   "train_libri960_step")
        check_lstm_launches(prof, result, "libri960")
        result["profile"] = prof
        print("train_libri960 " + json.dumps(result))
        out["train"] = result
        del step, state, batch
        torch.cuda.empty_cache()
    with part(sec, "f32"):
        out["f32"] = f32_kernels_vs_plain(seed + 51, dev, "auto",
                                          L960_F32["U"], cfg, L960_F32["B"],
                                          L960_F32["T"])
    torch.cuda.empty_cache()
    with part(sec, "serve"):
        out["serve"], serving = config_serving(
            cfg, seed + 52, n_requests, dev, (150, 800), BUCKETS[-1], True,
            "libri960_serve")
    with part(sec, "streaming"):
        out["streaming"] = config_streaming(serving, dev, "libri960")
    del serving
    torch.cuda.empty_cache()
    print("configs_seconds " + json.dumps({"libri960": sec}))
    return out


def config_streaming(serving: dict, dev, what: str) -> dict:
    """8 sessions of 32-frame chunks of the first 8 served utterances with
    their /recognize requests at once: at f32 one K4-fwd launch a layer a
    tick on the carried state, each session equal to the offline
    engine's answer; at bf16 the sessions alone, then the requests (the
    ticks' host ms)."""
    cfg, params = serving["cfg"], serving["params"]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    utts = serving["utts"][:STREAM_SLOTS]
    lengths = [u.shape[0] for u in utts]
    run = serve_sessions(params, f32, utts, dev)
    check_session_results(run, lengths, f"{what} f32")
    per_tick = check_launches(run, "lstm_fwd", cfg.enc_layers, f"{what} f32")
    agree = greedy_agreement(run)
    check(agree["token_agreement"] == 1.0 and agree["frame_agreement"] == 1.0
          and agree["max_confidence_gap"] <= CONF_ROUND,
          f"streaming {what} f32: sessions differ from the offline engine "
          f"{agree}")
    bf = serve_sessions(params, cfg, utts, dev, at_once=False)
    check_session_results(bf, lengths, f"{what} bf16")
    check_launches(bf, "lstm_fwd", cfg.enc_layers, f"{what} bf16")
    row = {"what": what, "launches": run["counts"]["lstm_fwd"]
           + bf["counts"]["lstm_fwd"], "lstm_fwd_per_tick": per_tick,
           "f32": agree, "mean_tokens": statistics.mean(
               len(s["final"]) for s in run["sessions"]),
           "bf16": {**greedy_agreement(bf), **tick_timing(bf, CHUNK_FRAMES)}}
    print("streaming " + json.dumps(row))
    check(0 < row["mean_tokens"] < MAX_SYMBOLS,
          f"streaming {what} f32: {row['mean_tokens']} tokens a session on "
          f"average, not between 0 and {MAX_SYMBOLS}")
    return row


def flat_digest(params) -> str:
    """sha256 of every param leaf's bytes, in the pytree's order."""
    h = hashlib.sha256()
    for leaf in leaves(params):
        h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank(mesh, seed: int, steps: int, f32: bool) -> dict:
    """One rank of libri960's data-parallel run (phase 5f (c)): every rank
    draws the whole B=64 batch and takes its rows. With f32: the loss and
    gradients of the rank's rows averaged over the ranks (`pmean`, the
    step's all-reduce). Then `steps` bf16 steps of make_train_step(mesh=),
    each followed by every rank's params digest. Rank 0's result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cfg = config_libri960()
    shard = meshlib.shard_batch(mesh, bench_batch(cfg, seed, dev, L960_U,
                                                  L960_B, L960_T))
    out = {"rank": mesh.rank, "rows": int(shard[0].shape[0]),
           "backend": mesh.backend}
    if f32:
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        params = meshlib.replicate(mesh, m.init_params(
            c32, np.random.default_rng(seed + 2), dev))
        flat, spec = torch.utils._pytree.tree_flatten(params)
        loss, grads = tl.pmean(mesh, *tl.loss_and_grads(flat, spec, c32,
                                                        *shard))
        out["f32"] = (float(loss), grads)
        del params, flat, grads
        torch.cuda.empty_cache()
    tcfg = TrainConfig(batch_size=L960_B, warmup_steps=100,
                       total_steps=10000)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev)
    state = dataclasses.replace(
        state, params=meshlib.replicate(mesh, state.params),
        opt_state=meshlib.replicate(mesh, state.opt_state))
    step = tl.make_train_step(cfg, tcfg, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    reset_counts()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = step(state, *shard)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"ms": ms, "loss": float(info["loss"]),
                     "skipped": int(info["skipped_nonfinite"]),
                     "digests": meshlib.all_gather_objects(
                         mesh, flat_digest(state.params))})
    out.update(steps=rows, launches=read_counts(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def dp_phase(seed: int, dev, one_process_ms: float) -> dict:
    """Phase 5f (c): two gloo ranks share the card at libri960 width. The
    f32 loss and all-reduced gradient of B=64 split 32 / 32 against one
    process on the whole batch (LOSS_RTOL; every leaf within GRAD_RTOL of
    its largest value); then bf16 steps, the ranks' params bit-equal
    after each, ms a step beside the one-process step. Over two cards
    of their own (where the machine shows two), the same steps on NCCL."""
    cfg = config_libri960()
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = bench_batch(cfg, seed, dev, L960_U, L960_B, L960_T)
    params = m.init_params(c32, np.random.default_rng(seed + 2), dev)
    flat, spec = torch.utils._pytree.tree_flatten(params)
    want_loss, want_grads = tl.loss_and_grads(flat, spec, c32, *batch)
    want_loss = float(want_loss)
    del params, flat, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = meshlib.spawn(dp_rank, DP_RANKS, [str(dev)] * DP_RANKS,
                        args=(seed, DP_STEPS, True), timeout_s=DP_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    loss, grads = got.pop("f32")
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    worst = max(rel_err(a, b) for a, b in zip(grads, want_grads))
    del grads, want_grads
    torch.cuda.empty_cache()
    steps = got.pop("steps")
    timed = [r["ms"] for r in steps[1:]]
    row = {"ranks": DP_RANKS, "backend": got["backend"],
           "devices": [str(dev)] * DP_RANKS,
           "rows_a_rank": got["rows"], "f32_loss": loss,
           "f32_loss_one_process": want_loss, "f32_loss_rel_err": loss_rel,
           "f32_grad_worst_rel_err": worst,
           "bf16_ms_per_step": statistics.mean(timed),
           "bf16_step_ms": [r["ms"] for r in steps],
           "one_process_ms_per_step": one_process_ms,
           "losses": [r["loss"] for r in steps],
           "params_bit_equal": [len(set(r["digests"])) == 1 for r in steps],
           "launches_rank0": {k: v for k, v in got["launches"].items() if v},
           "peak_mem_gb_rank0": got["peak_mem_gb"], "wall_s": wall_s}
    print("dp " + json.dumps(row))
    check(loss_rel <= LOSS_RTOL and worst <= GRAD_RTOL,
          f"two ranks' f32 loss / gradient against one process: {loss_rel}, "
          f"{worst}")
    check(all(row["params_bit_equal"]),
          f"the ranks' params differ after a step: {row['params_bit_equal']}")
    check(all(r["skipped"] == 0 and np.isfinite(r["loss"]) for r in steps),
          "a data-parallel step was skipped or non-finite")
    layer_calls = cfg.enc_layers + cfg.pred_layers
    n = len(steps)
    for name, per_step in (("lstm_fwd_with_acts", layer_calls),
                           ("lstm_bwd", layer_calls), ("extract_lp", 1),
                           ("assemble_grad", 1), ("lattice_alpha", 1),
                           ("lattice_beta", 1)):
        check(got["launches"][name] == per_step * n,
              f"rank 0 launched {name} {got['launches'][name]} times in {n} "
              f"steps, not {per_step} a step")
    if torch.cuda.device_count() >= 2:
        nccl = meshlib.spawn(dp_rank, 2, ["cuda:0", "cuda:1"],
                             args=(seed, 2, False), timeout_s=DP_TIMEOUT_S)
        row["nccl"] = {"bit_equal": [len(set(r["digests"])) == 1
                                     for r in nccl["steps"]],
                       "ms": [r["ms"] for r in nccl["steps"]]}
        print("dp_nccl " + json.dumps(row["nccl"]))
        check(all(row["nccl"]["bit_equal"]),
              "NCCL ranks' params differ after a step")
    else:
        print(f"dp_nccl unchecked: {torch.cuda.device_count()} card visible "
              "(NCCL needs a card a rank)")
    return row


def configs_phase(seed: int, dev, profile_dir, n_requests: int) -> dict:
    """Phase 5f: TIMIT (a), libri960 (b), libri960 on two ranks (c)."""
    out = {}
    for name, fn in (("timit", lambda: timit_phase(seed, dev, profile_dir)),
                     ("libri960", lambda: libri960_phase(
                         seed, dev, profile_dir, n_requests))):
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"phase configs_{name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["dp"] = dp_phase(seed + 60, dev,
                         out["libri960"]["train"]["ms_per_step"])
    print(f"phase configs_dp: {time.perf_counter() - t0:.1f} s")
    launches = {
        "timit_train": out["timit"]["train"]["launches"],
        "timit_train_steps": out["timit"]["train"]["steps"],
        "timit_serve": {k: out["timit"]["serve"][k]["launches"]
                        for k in out["timit"]["serve"]},
        "libri960_train": out["libri960"]["train"]["launches"],
        "libri960_train_steps": out["libri960"]["train"]["steps"],
        "libri960_serve": {k: out["libri960"]["serve"][k]["launches"]
                           for k in out["libri960"]["serve"]},
        "libri960_streaming": out["libri960"]["streaming"]["launches"],
        "dp_rank0": out["dp"]["launches_rank0"]}
    for k in ("timit_train", "libri960_train"):
        launches[k] = {n: v for n, v in launches[k].items() if v}
    print("configs_launches " + json.dumps(launches))
    return out


# ------------------------------ phase 5g ---------------------------------
#
# BASELINE.json configs[2] on manifest data: libri100 at B=32 in
# TrainConfig's buckets (400, 50), (800, 100) and (1600, 200). The corpus
# is made from --seed: 0.1 * N(0, 1) 16 kHz PCM16 wav files, each with a
# transcript cut from README.md's words (2.5 words a second), in four
# spans of lengths (utterances, seconds from, seconds to): one span a
# bucket, each enough for two full batches besides the held-out dev
# batch, and a few utterances past 16 s that the buckets drop.
MANIFEST_SPANS = ((100, 1.0, 3.9), (100, 4.2, 7.9), (96, 8.2, 15.9),
                  (4, 16.5, 18.0))
MANIFEST_B, MANIFEST_F32_B, MANIFEST_RESUME_B = 32, 4, 8
# one epoch of the corpus under SortaGrad: two full batches a bucket,
# shortest first, then each bucket's flush
MANIFEST_STEPS = 9
# the CLI's regularizers, configs[2]'s recipe
MANIFEST_REG = ["--sortagrad", "--spec-augment", "--speed-perturb",
                "0.9,1.0,1.1", "--dropout", "0.1", "--embed-dropout", "0.1",
                "--weight-noise", "0.01", "--ema-decay", "0.999"]
# the prepare tool's card log_mel against the float64 oracle
FEATS_ATOL = 1e-3


def write_wav(path: str, pcm: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(pcm * 32768.0, -32768, 32767)
                      .astype(np.int16).tobytes())


def manifest_corpus(seed: int, tmp: str, dev) -> dict:
    """(a) The corpus as paired wav + txt files, named in a shuffled order
    so that the held-out first batch mixes the buckets; its manifest by
    `python -m rnn_transducer_tpu_torch.tools.prepare_manifest
    --tokenizer bpe` on the card; CMVN stats by `compute_cmvn`; 8
    utterances' features against `log_mel_oracle`; the examples each
    bucket gets after the dev batch is held out."""
    from rnn_transducer_tpu_torch.data.bucketing import BucketBatcher
    from rnn_transducer_tpu_torch.data.cmvn import compute_cmvn, save_cmvn
    from rnn_transducer_tpu_torch.data.manifest import (example_length,
                                                        read_manifest)
    from rnn_transducer_tpu_torch.tools import prepare_manifest as prep

    rng = np.random.default_rng(seed + 70)
    readme = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "README.md")
    with open(readme) as f:
        words = re.findall(r"[a-z][a-z']*", f.read().lower())
    secs = np.concatenate([rng.uniform(lo, hi, n)
                           for n, lo, hi in MANIFEST_SPANS])
    names = rng.permutation(len(secs))
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    t0 = time.perf_counter()
    for k, s in zip(names, secs):
        n_words = max(2, int(round(2.5 * s)))
        at = int(rng.integers(0, len(words) - n_words))
        stem = os.path.join(corpus, f"utt{k:04d}")
        write_wav(stem + ".wav", 0.1 * rng.normal(size=int(s * 16000)))
        with open(stem + ".txt", "w") as f:
            f.write(" ".join(words[at:at + n_words]))
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "train")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = prep.main(["--in-dir", corpus, "--out-dir", out,
                             "--tokenizer", "bpe", "--vocab-size",
                             str(BPE_VOCAB), "--device", dev.type])
    prepare_s = time.perf_counter() - t0
    man = summary["manifest"]
    recs = list(read_manifest(man))
    check(summary["utts"] == len(secs) == len(recs)
          and summary["vocab_size"] <= BPE_VOCAB,
          f"prepare tool: {summary}")
    t0 = time.perf_counter()
    stats = compute_cmvn(man, 80, device=dev)
    cmvn_s = time.perf_counter() - t0
    cmvn_path = os.path.join(tmp, "cmvn.json")
    save_cmvn(stats, cmvn_path)
    # 8 of the shorter utterances against the float64 oracle
    lens = [example_length(r) for r in recs]
    worst = 0.0
    for i in sorted(range(len(recs)), key=lens.__getitem__)[::12][:8]:
        stem = os.path.join(corpus, f"utt{i:04d}")  # manifest order = names
        pcm, _ = prep.read_audio(stem + ".wav")
        want, _ = log_mel_oracle(pcm[None], np.array([len(pcm)]))
        got = np.load(recs[i]["feats"])
        check(got.shape == want[0].shape, f"prepared feats {got.shape} vs "
              f"the oracle's {want[0].shape}")
        worst = max(worst, float(np.abs(got - want[0]).max()))
    check(worst <= FEATS_ATOL, f"prepared features {worst} from the oracle")
    # examples a bucket after the first batch is held out; the dropped
    sizer = BucketBatcher(TrainConfig().buckets, MANIFEST_B)
    counts = collections.Counter(
        sizer._bucket_for(t, len(r["labels"])) for t, r in
        zip(lens[MANIFEST_B:], recs[MANIFEST_B:]))
    dropped = counts.pop(None, 0)
    check(len(counts) == 3 and min(counts.values()) >= 2 * MANIFEST_B
          and dropped == MANIFEST_SPANS[-1][0],
          f"bucket counts {counts}, dropped {dropped}")
    # the held-out batch's utterances that a bucket takes, for the decode CLI
    dev_man = os.path.join(tmp, "dev.jsonl")
    dev_recs = [r for t, r in zip(lens[:MANIFEST_B], recs[:MANIFEST_B])
                if sizer._bucket_for(t, len(r["labels"])) is not None]
    with open(dev_man, "w") as f:
        for r in dev_recs:
            f.write(json.dumps(r) + "\n")
    row = {"utts": len(recs), "hours": float(secs.sum()) / 3600,
           "vocab_size": summary["vocab_size"],
           "bucket_examples": {str(b[0]): n for b, n in sorted(
               counts.items())}, "dropped": dropped,
           "label_len_max": max(len(r["labels"]) for r in recs),
           "oracle_max_abs_err": worst, "oracle_atol": FEATS_ATOL,
           "write_s": write_s, "prepare_s": prepare_s, "cmvn_s": cmvn_s,
           "cmvn_frames": stats["frames"]}
    print("manifest_corpus " + json.dumps(row))
    return {"manifest": man, "dev_manifest": dev_man,
            "dev_utts": len(dev_recs), "cmvn": cmvn_path,
            "stats": stats, "bpe": summary["bpe_model"], "corpus": corpus,
            "recs": recs, "row": row}


def manifest_args(corpus: dict, seed: int, *extra):
    """The training CLI's arguments for the corpus with MANIFEST_REG."""
    return train_args(["--data", f"manifest:{corpus['manifest']}",
                       "--cmvn", corpus["cmvn"], "--seed", str(seed),
                       *MANIFEST_REG, *extra])


def bucket_batches(corpus: dict, seed: int, dev) -> dict:
    """The first B=32 batch of each bucket from the CLI's stream (the dev
    batch held out, SortaGrad, the seed's shuffle, CMVN), numpy, and the
    host's ms to load a batch of the bucket: the mean over the stream's
    batches up to the second of the 1600 bucket, less its first, which
    also scans the manifest's lengths for SortaGrad (`first_batch_ms`)."""
    from rnn_transducer_tpu_torch.data.manifest import manifest_batches

    tcfg = TrainConfig(batch_size=MANIFEST_B)
    cfg = config_libri100()
    stream = manifest_batches(corpus["manifest"], cfg, tcfg,
                              skip_first=MANIFEST_B, sortagrad=True,
                              shuffle_seed=seed, cmvn=corpus["stats"],
                              device=dev)
    out, load_ms = {}, collections.defaultdict(list)
    first_ms = None
    longest = max(b[0] for b in tcfg.buckets)
    while len(load_ms[longest]) < 2:
        t0 = time.perf_counter()
        batch = next(stream)
        ms = (time.perf_counter() - t0) * 1e3
        T = batch[0].shape[1]
        if first_ms is None:
            first_ms = ms
        else:
            load_ms[T].append(ms)
        out.setdefault(T, batch)
    row = {"first_batch_ms": first_ms,
           "load_ms": {str(T): v for T, v in sorted(load_ms.items())}}
    print("manifest_loader " + json.dumps(row))
    check(len(out) == 3 and all(load_ms[T] for T in out),
          f"the stream's first batches: {row}")
    return {T: (out[T], statistics.mean(load_ms[T])) for T in sorted(out)}


def manifest_f32(corpus: dict, batches: dict, seed: int, dev) -> dict:
    """(b) f32 libri100 through the kernels and through their plain
    versions on the first 4 rows of each bucket's batch, with the draws
    fixed: the batch augmented once (the CLI's speed perturbation and
    SpecAugment of step 0), step 0's dropout masks and weight noise. The
    loss within LOSS_RTOL, every gradient leaf within GRAD_RTOL of its
    largest value; then two steps of make_train_step on the 400 bucket
    each way, the EMA within GRAD_RTOL of each leaf's largest value."""
    from rnn_transducer_tpu_torch.train import regularizers as reg

    cfg = dataclasses.replace(config_libri100(), compute_dtype="float32")
    params = m.init_params(cfg, np.random.default_rng(seed + 71), dev)
    flat, spec = torch.utils._pytree.tree_flatten(params)
    paths = list(reg.leaf_paths(params))
    noisy = [p + 0.01 * z for p, z in
             zip(flat, reg.weight_noise(seed, 0, paths, flat))]
    args = manifest_args(corpus, seed)
    B = MANIFEST_F32_B
    rows, small = {}, {}
    for T, (batch, _) in batches.items():
        small[T] = train_batch(args, tuple(x[:B] for x in batch), 0, None,
                               dev)

        def loss_and_grads(plain: bool):
            ctx = plain_kernels() if plain else contextlib.nullcontext()
            with ctx:
                xs = [p.detach().requires_grad_(True) for p in noisy]
                loss, _ = tl.loss_fn(
                    torch.utils._pytree.tree_unflatten(xs, spec), cfg,
                    *small[T], dropout=0.1, embed_dropout=0.1,
                    drop=reg.DropoutMasks(seed, 0, 0, B))
                grads = torch.autograd.grad(loss, xs)
            return float(loss.detach()), grads

        t0 = time.perf_counter()
        lk, gk = loss_and_grads(False)
        lp, gp = loss_and_grads(True)
        rows[T] = {"B": B, "T": T, "U1": small[T][2].shape[1] + 1,
                   "loss_kernels": lk, "loss_plain": lp,
                   "loss_rel_err": abs(lk - lp) / abs(lp),
                   "grad_worst_rel_err": max(rel_err(a, b)
                                             for a, b in zip(gk, gp)),
                   "seconds": time.perf_counter() - t0}
        del gk, gp
        torch.cuda.empty_cache()
    tcfg = TrainConfig(batch_size=B, warmup_steps=1, seed=seed,
                       dropout=0.1, embed_dropout=0.1, weight_noise_std=0.01,
                       ema_decay=0.999)

    def two_steps(plain: bool):
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        with ctx:
            st = tl.init_train_state(None, cfg, tcfg, params=params)
            step = tl.make_train_step(cfg, tcfg, device=dev)
            for _ in range(2):
                st, info = step(st, *small[min(small)])
                check(int(info["skipped_nonfinite"]) == 0,
                      "f32 manifest step skipped")
        return st

    ek, ep = two_steps(False), two_steps(True)
    ema_err = max(rel_err(a, b) for a, b in zip(leaves(ek.ema),
                                                leaves(ep.ema)))
    ema_moved = max(float((a - b).abs().max())
                    for a, b in zip(leaves(ek.ema), flat))
    out = {"buckets": rows, "ema_worst_rel_err": ema_err,
           "ema_max_change": ema_moved, "loss_rtol": LOSS_RTOL,
           "grad_rtol": GRAD_RTOL}
    print("manifest_f32 " + json.dumps(out))
    for T, r in rows.items():
        check(r["loss_rel_err"] <= LOSS_RTOL,
              f"f32 manifest loss at bucket {T}: {r}")
        check(r["grad_worst_rel_err"] <= GRAD_RTOL,
              f"f32 manifest gradients at bucket {T}: {r}")
    check(ema_err <= GRAD_RTOL and ema_moved > 0,
          f"f32 EMA after 2 steps: rel err {ema_err}, change {ema_moved}")
    return out


def manifest_cli(corpus: dict, seed: int, tmp: str, dev) -> dict:
    """(c) The main path: `python -m rnn_transducer_tpu_torch.train
    --config libri100 --data manifest:... --batch-size 32` in bf16 with
    MANIFEST_REG, CMVN, the corpus's BPE tokenizer and dev evaluation,
    one SortaGrad epoch (every bucket), with the launch counts set to 0
    just before it and read just after: every step finite and none
    skipped, every bucket seen, dev_loss and dev_per in the log."""
    d = os.path.join(tmp, "ck")
    log = os.path.join(tmp, "train.jsonl")
    argv = ["--config", "libri100", "--data",
            f"manifest:{corpus['manifest']}", "--batch-size",
            str(MANIFEST_B), "--steps", str(MANIFEST_STEPS), *MANIFEST_REG,
            "--cmvn", corpus["cmvn"], "--tokenizer", f"bpe:{corpus['bpe']}",
            "--eval-every", "3", "--log-every", "1", "--log-file", log,
            "--ckpt-dir", d, "--seed", str(seed), "--device", dev.type]
    reset_counts()
    t0 = time.perf_counter()
    last = cli_json(argv, MANIFEST_STEPS, "manifest")
    wall = time.perf_counter() - t0
    counts = read_counts()
    with open(log) as f:
        recs = [json.loads(ln) for ln in f]
    steps = [r for r in recs if "loss" in r]
    evals = [r for r in recs if "dev_loss" in r]
    row = {"steps": len(steps), "wall_s": wall, "final": last,
           "frames": [r["frames"] for r in steps],
           "losses": [r["loss"] for r in steps],
           "skipped": sum(r["skipped_nonfinite"] for r in steps),
           "dev": evals, "launches": counts}
    print("manifest_cli " + json.dumps(row))
    check(len(steps) == MANIFEST_STEPS
          and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                  for r in steps) and row["skipped"] == 0,
          f"manifest CLI: steps {steps}")
    check(set(row["frames"]) == {b[0] for b in TrainConfig().buckets},
          f"manifest CLI saw buckets {sorted(set(row['frames']))}")
    check(len(evals) == MANIFEST_STEPS // 3
          and all(np.isfinite(r["dev_loss"]) and np.isfinite(r["dev_per"])
                  for r in evals), f"manifest CLI dev records {evals}")
    for name in ("lstm_fwd_with_acts", "lstm_bwd", "joint_fwd", "joint_bwd",
                 "lattice_alpha", "lattice_beta"):
        check(counts[name] > 0, f"the manifest CLI never launched {name}")
    check(counts["extract_lp"] == counts["assemble_grad"] == 0,
          "the manifest CLI launched K5")
    check_no_band(counts, "the manifest CLI")
    meta = ckpt.load_meta(d)
    check(meta.get("cmvn") and meta.get("tokenizer")
          and meta["train_config"]["ema_decay"] == 0.999,
          "the manifest CLI's meta.json lacks cmvn, tokenizer or ema_decay")
    check(ckpt.restore_checkpoint(d, device=dev)[0].ema is not None,
          "the manifest CLI's checkpoint has no EMA")
    return {**row, "ckpt_dir": d}


def bucket_bounds(cfg, B: int, T: int, U1: int) -> dict:
    """Bounds of K4 (every LSTM layer of a step: encoder layer 0 at T
    frames, the rest at T / time_reduction, the predictor at U1), K1, K2
    and K3 at a bucket's shape, in bf16 with f32 activations, counted as
    the kernel-vs-plain lines count them: inputs read once, outputs
    written once. K4-fwd: x_proj, w_hh, h0, c0 in; hs, cs and the gate
    activations out. K4-bwd: activations, c_{t-1}, dh, dc_T, w_hh in;
    dgates, dh0, dc0 out. K1: f, g, W, b, labels in; blank and label
    log-probs and the log-sum-exp out. K2: those and the two gradient
    rows in; df, dg, dW, db out. K3: alpha over two score planes, beta
    and the two occupancy planes over four."""
    H, J, V = cfg.enc_hidden, cfg.joint_dim, cfg.n_classes
    T2 = T // cfg.time_reduction
    lay = [(T, H)] + [(T2, H)] * (cfg.enc_layers - 1) + [(U1,
                                                          cfg.pred_hidden)]
    f_b = b_b = ops = 0
    for t, h in lay:
        bth, bt4h = B * t * h * 4, B * t * 4 * h * 4
        w = h * 4 * h * 2
        f_b += bt4h + w + 2 * B * h * 4 + 2 * bth + bt4h
        b_b += bt4h + 2 * bth + B * h * 4 + w + bt4h + 2 * B * h * 4
        ops += 2 * B * t * h * 4 * h
    cells = B * T2 * U1
    lin = B * T2 * J * 4 + B * U1 * J * 4 + J * V * 2 + V * 4 + B * U1 * 4
    jops = 2 * cells * J * V
    return {"lstm_fwd": bound(f_b, ops, torch.bfloat16),
            "lstm_bwd": bound(b_b, ops, torch.bfloat16),
            "joint_fwd": bound(lin + 3 * cells * 4, jops, torch.bfloat16),
            "joint_bwd": bound(lin + 5 * cells * 4 + B * T2 * J * 4
                               + B * U1 * J * 4 + J * V * 4 + V * 4,
                               3 * jops, torch.bfloat16),
            "lattice": bound(2 * cells * 4 + cells * 4 + 4 * cells * 4
                             + 3 * cells * 4, 24 * cells, torch.float32)}


def manifest_timing(corpus: dict, batches: dict, seed: int, dev,
                    profile_dir) -> dict:
    """(c) In process, the CLI's step (libri100 bf16, MANIFEST_REG) on
    each bucket's first B=32 batch, augmented as the CLI augments it:
    ms a step by slope, peak memory, the host's ms to load a batch and
    its share of a step that waits for it, and a profiled step: 5
    lstm_fwd and 5 lstm_bwd kernels, K1's and K2's ring kernels, K3, no
    K5 or K6, and its busy share; at the 1600 bucket each family's device
    ms beside its bound at that shape."""
    cfg = config_libri100()
    args = manifest_args(corpus, seed)
    tcfg = TrainConfig(batch_size=MANIFEST_B, seed=seed, dropout=0.1,
                       embed_dropout=0.1, weight_noise_std=0.01,
                       ema_decay=0.999)
    state = tl.init_train_state(np.random.default_rng(seed + 72), cfg, tcfg,
                                dev)
    step = tl.make_train_step(cfg, tcfg, device=dev)
    rows, profs = {}, {}
    for i, (T, (batch, load_ms)) in enumerate(batches.items()):
        aug = train_batch(args, batch, i, None, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, res = timed_steps(step, state, aug, MANIFEST_B)
        state, prof = profile_step(step, state, aug, profile_dir,
                                   f"manifest_{T}_step")
        check_lstm_launches(prof, res, f"manifest {T}")
        check_fused_joint_profile(prof, res, f"manifest {T}")
        seen = prof["device_launches"]
        check(seen["lattice"] > 0 and seen["loss_rows"] == 0,
              f"the profiled {T} step: lattice {seen['lattice']}, "
              f"loss_rows {seen['loss_rows']}")
        res.update({"T": T, "U1": batch[2].shape[1] + 1,
                    "load_ms": load_ms,
                    "loader_share": load_ms / (load_ms + res["ms_per_step"]),
                    "busy_share": prof["device_busy_share"],
                    "card": card_line()})
        rows[T], profs[T] = res, prof
        print(f"manifest_bucket_{T} " + json.dumps(res))
    T = max(batches)
    prof = profs[T]
    seen = prof["device_launches"]
    bounds = bucket_bounds(cfg, MANIFEST_B, T, rows[T]["U1"])
    dms = prof["device_ms"]
    fam = {"lstm_fwd": dms["lstm_fwd"], "lstm_bwd": dms["lstm_bwd"],
           "joint_fwd": dms["joint_fwd"],
           "joint_bwd": dms["joint_bwd_a"] + dms["joint_bwd_b"]
           + dms["joint_bwd_sums"], "lattice": dms["lattice"]}
    k1600 = {k: {"device_ms": fam[k], "bound_ms": bounds[k]["bound_ms"],
                 "bound_by": bounds[k]["bound_by"]} for k in fam}
    for k, n in (("lstm_fwd", "lstm_fwd"), ("lstm_bwd", "lstm_bwd"),
                 ("joint_fwd", "joint_fwd"), ("lattice", "lattice")):
        k1600[k]["launches"] = seen[n]
    k1600["joint_bwd"]["launches"] = (seen["joint_bwd_a"]
                                      + seen["joint_bwd_b"]
                                      + seen["joint_bwd_sums"])
    out = {"card": card_line(), "profile_1600": prof,
           "kernels_1600": k1600}
    print("manifest_profile_1600 " + json.dumps(out))
    return {"buckets": rows, **out}


def manifest_resume(corpus: dict, seed: int, tmp: str, dev) -> dict:
    """(d) f32 libri100 (a JSON config) at B=8 with MANIFEST_REG: the CLI
    in a process of its own, SIGTERM after step 2: it finishes its step,
    checkpoints there and exits 0; --resume (--resume-data exact) to two
    steps past it, and an uninterrupted run to the same step: params,
    Adam state and EMA compared bit for bit."""
    cfg_path = os.path.join(tmp, "libri100_f32.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(dataclasses.replace(
            config_libri100(), compute_dtype="float32")), f)
    base = ["--config", cfg_path, "--data", f"manifest:{corpus['manifest']}",
            "--batch-size", str(MANIFEST_RESUME_B), *MANIFEST_REG,
            "--cmvn", corpus["cmvn"], "--eval-every", "0", "--log-every",
            "1", "--seed", str(seed), "--device", dev.type]
    da, db = os.path.join(tmp, "resume_a"), os.path.join(tmp, "resume_b")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rnn_transducer_tpu_torch.train", *base,
         "--steps", "60", "--ckpt-dir", da],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err = []
    watchdog = threading.Timer(300, proc.kill)  # a run that never logs
    watchdog.start()
    try:
        for line in proc.stderr:
            err.append(line)
            if line.startswith("{") and json.loads(line).get("step",
                                                             0) >= 2:
                proc.send_signal(signal.SIGTERM)
                break
        out, rest = proc.communicate(timeout=300)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = "".join(err) + rest
    check(proc.returncode == 0, f"SIGTERM run: exit {proc.returncode}, "
          f"{err[-2000:]}")
    stopped = json.loads(out.strip().splitlines()[-1])["steps"]
    check(2 <= stopped < 60 and ckpt.latest_step(da) == stopped
          and f"SIGTERM: rank 0 stops after step {stopped}" in err,
          f"SIGTERM run stopped at {stopped}, checkpoint "
          f"{ckpt.latest_step(da)}")
    term_s = time.perf_counter() - t0
    n = stopped + 2
    cli_json(base + ["--steps", str(n), "--ckpt-dir", da, "--resume",
                     "--resume-data", "exact"], n, "manifest_resumed")
    cli_json(base + ["--steps", str(n), "--ckpt-dir", db], n,
             "manifest_uninterrupted")
    a, _ = ckpt.restore_checkpoint(da, device=dev)
    b, _ = ckpt.restore_checkpoint(db, device=dev)
    diff = {k: max(float((x - y).abs().max()) / max(
        float(y.abs().max()), 1e-30) for x, y in zip(
            leaves(getattr(a, k)), leaves(getattr(b, k)))
        if isinstance(x, torch.Tensor)) for k in ("params", "ema")}
    row = {"stopped_at": stopped, "resumed_to": n, "sigterm_run_s": term_s,
           "params_bit_equal": trees_equal(a.params, b.params),
           "opt_state_bit_equal": trees_equal(a.opt_state, b.opt_state),
           "ema_bit_equal": trees_equal(a.ema, b.ema),
           "worst_rel_diff": diff}
    print("manifest_resume " + json.dumps(row))
    check(row["params_bit_equal"] and row["opt_state_bit_equal"]
          and row["ema_bit_equal"],
          f"the resumed run differs from the uninterrupted one: {row}")
    return row


def manifest_serve(corpus: dict, cli: dict, dev) -> dict:
    """(e) The CLI run's EMA served and decoded: serve.py --ckpt-dir
    --use-ema answers an {"audio"} /recognize with text (and a PCM
    session), and the decode CLI with --use-ema on the dev manifest (the
    held-out batch) prints wer and rtf."""
    from rnn_transducer_tpu_torch.recognize import main as recognize_cli
    from rnn_transducer_tpu_torch.tools.prepare_manifest import read_audio

    utt, _ = read_audio(os.path.join(corpus["corpus"], "utt0000.wav"))
    d = cli["ckpt_dir"]
    served = serve_cli(["--ckpt-dir", d, "--use-ema"], utt, "libri100",
                       audio=True, want_text=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = recognize_cli(["--ckpt-dir", d, "--use-ema", "--data",
                             f"manifest:{corpus['dev_manifest']}",
                             "--batch-size", str(MAX_BATCH), "--device",
                             dev.type])
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    print("manifest_recognize_ema " + json.dumps(last))
    check(last == got and last["n"] == corpus["dev_utts"]
          and all(np.isfinite(last[k]) for k in ("wer", "rtf")),
          f"the decode CLI with --use-ema printed {last}")
    return {"serve": served, "recognize": last}


def manifest_phase(seed: int, dev, profile_dir, tmp: str) -> dict:
    """Phase 5g: configs[2] on manifest data, (a)-(e) above, its files
    under `tmp` (phase 5h reads the corpus); the CLI run's launch counts
    on a line of their own."""
    out, seconds = {}, {}
    for name, fn in (
            ("corpus", lambda: manifest_corpus(seed, tmp, dev)),
            ("batches", lambda: bucket_batches(out["corpus"], seed, dev)),
            ("f32", lambda: manifest_f32(out["corpus"], out["batches"],
                                         seed, dev)),
            ("cli", lambda: manifest_cli(out["corpus"], seed, tmp, dev)),
            ("timing", lambda: manifest_timing(
                out["corpus"], out["batches"], seed, dev, profile_dir)),
            ("resume", lambda: manifest_resume(out["corpus"], seed, tmp,
                                               dev)),
            ("serve", lambda: manifest_serve(out["corpus"], out["cli"],
                                             dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("manifest_launches " + json.dumps(
        {k: v for k, v in out["cli"]["launches"].items() if v}))
    print("manifest_seconds " + json.dumps(seconds))
    return out


# ------------------------------ phase 5h ---------------------------------
#
# The training recipes at libri100 width on phase 5g's corpus: the C++
# prefetch loader, lattice distillation from an offline BiLSTM teacher
# and MWER fine-tuning on the live beam N-best.
RECIPE_STEPS = 9  # the CLI epoch of each loader (5g's epoch length)
# the CLI's regularizers without SortaGrad, which the native loader lacks
RECIPE_REG = [a for a in MANIFEST_REG if a != "--sortagrad"]
DISTILL_F32_B, DISTILL_CLI_B = 4, 8
MWER_B, MWER_BEAM, MWER_EXPANSIONS, MWER_MAX_SYMBOLS = 8, 4, 2, 64
MWER_STEPS = 3  # timed bf16 MWER steps, each ended by a synchronise


def recipe_loader_gate(corpus: dict, dev) -> dict:
    """(a) One thread, seed=None, the dev batch held out, CMVN on the
    padded batch: every batch of the native loader's pass equal bit for
    bit to the python loader's first epoch (manifest order, CMVN a record
    before padding). The first batch of each bucket is kept for (c)."""
    from rnn_transducer_tpu_torch.data.manifest import manifest_batches
    from rnn_transducer_tpu_torch.data.native_loader import NativeLoader

    cfg, tcfg = config_libri100(), TrainConfig(batch_size=MANIFEST_B)
    t0 = time.perf_counter()
    build.load_loader_library()  # g++, once
    gxx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with NativeLoader(corpus["manifest"], cfg, tcfg.buckets, MANIFEST_B,
                      seed=None, n_threads=1, skip_first=MANIFEST_B,
                      cmvn=corpus["stats"], device=dev) as ld:
        got = [b[:4] for b in ld]
        dropped = ld.dropped
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = list(itertools.islice(manifest_batches(
        corpus["manifest"], cfg, tcfg, skip_first=MANIFEST_B,
        cmvn=corpus["stats"], device=dev), len(got)))
    python_s = time.perf_counter() - t0
    equal = len(got) == len(want) and all(
        a.shape == b.shape and np.array_equal(a, b)
        for g, w in zip(got, want) for a, b in zip(g, w))
    row = {"batches": len(got), "frames": [b[0].shape[1] for b in got],
           "dropped": dropped, "bit_equal": equal, "gxx_build_s": gxx_s,
           "native_pass_s": native_s, "python_pass_s": python_s}
    print("recipe_loader_gate " + json.dumps(row))
    check(equal and len(got) >= 3,
          f"the native loader's batches differ from the python loader's: "
          f"{row}")
    check(dropped == MANIFEST_SPANS[-1][0],
          f"the native loader dropped {dropped} utterances")
    first = {}
    for b in got:
        first.setdefault(b[0].shape[1], b)
    return first


def recipe_loader_cli(corpus: dict, seed: int, tmp: str, dev,
                      load_5g=None) -> dict:
    """(a) The configs[2] CLI epoch, libri100 bf16, B=32, RECIPE_REG and
    CMVN, with --loader native (two threads) and with --loader python,
    each its launch counts set to 0 just before it and read just after:
    every step finite, every bucket seen; the training thread's wait for
    a batch and the step's host ms a bucket from the CLI's log (each
    step's `load_ms` and `step_ms`; the first step's wait, the threads'
    start, apart), beside phase 5g's host ms to load a batch of the
    bucket in this run (`load_5g`, when 5g ran)."""
    rows = {}
    for loader in ("native", "python"):
        log = os.path.join(tmp, f"recipe_{loader}.jsonl")
        argv = ["--config", "libri100", "--data",
                f"manifest:{corpus['manifest']}", "--batch-size",
                str(MANIFEST_B), "--steps", str(RECIPE_STEPS), *RECIPE_REG,
                "--cmvn", corpus["cmvn"], "--loader", loader,
                "--eval-every", "0", "--log-every", "1", "--log-file", log,
                "--seed", str(seed), "--device", dev.type]
        reset_counts()
        t0 = time.perf_counter()
        cli_json(argv, RECIPE_STEPS, f"recipe_{loader}")
        wall = time.perf_counter() - t0
        counts = read_counts()
        with open(log) as f:
            steps = [json.loads(ln) for ln in f]
        wait, step_ms = collections.defaultdict(list), \
            collections.defaultdict(list)
        for r in steps[1:]:
            wait[r["frames"]].append(r["load_ms"])
            step_ms[r["frames"]].append(r["step_ms"])
        row = {"loader": loader, "wall_s": wall,
               "frames": [r["frames"] for r in steps],
               "first_wait_ms": steps[0]["load_ms"],
               "wait_ms": {str(T): statistics.mean(v)
                           for T, v in sorted(wait.items())},
               "wait_max_ms": {str(T): max(v)
                               for T, v in sorted(wait.items())},
               "step_ms": {str(T): statistics.mean(v)
                           for T, v in sorted(step_ms.items())},
               "phase_5g_load_ms": load_5g,
               "launches": {k: v for k, v in counts.items() if v},
               "card": card_line()}
        print(f"recipe_loader_{loader} " + json.dumps(row))
        check(len(steps) == RECIPE_STEPS and all(
            np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0
            for r in steps), f"the {loader} loader's CLI epoch: {steps}")
        check(set(row["frames"]) == {b[0] for b in TrainConfig().buckets},
              f"the {loader} loader's CLI epoch saw buckets "
              f"{sorted(set(row['frames']))}")
        for name in ("lstm_fwd_with_acts", "lstm_bwd", "joint_fwd",
                     "joint_bwd", "lattice_alpha", "lattice_beta"):
            check(counts[name] > 0,
                  f"the {loader} loader's CLI epoch never launched {name}")
        rows[loader] = row
    return rows


# A distillation step's launches: the student's 4 encoder layers and
# predictor with activations and their backward, the BiLSTM teacher's 4 x 2
# directions and predictor forward under no_grad, the xla lattice's alpha
# and beta once each, no K1 / K2 / K5.
DISTILL_STEP = {"lstm_fwd": 9, "lstm_fwd_with_acts": 5, "lstm_bwd": 5,
                "lattice_alpha": 1, "lattice_beta": 1, "joint_fwd": 0,
                "joint_bwd": 0, "extract_lp": 0, "assemble_grad": 0}
# An MWER step's (nll_weight 0): the encoder's 4 layers and the predictor
# over the B*K hypotheses with activations and their backward, the xla
# lattice's alpha and beta once each; the beam's predictor steps are
# products (`DecodeWeights.predict_step`), no K4.
MWER_STEP = {**DISTILL_STEP, "lstm_fwd": 0}


def recipe_distill(seed: int, tmp: str, dev) -> dict:
    """(b) The teacher, dataclasses.replace(config_libri100(),
    bidirectional=True), trained 2 CLI steps into a checkpoint; the
    student config_libri100 distilled from it (weight 0.3, tau 2): bf16
    steps at B=32, T=400, U=40 (ms a step by slope, peak GB, launches a
    step by DISTILL_STEP); the f32 loss and gradients at B=4 through
    the kernels and the plain versions (LOSS_RTOL, GRAD_RTOL); the
    --distill-from CLI for 2 steps, its launches read around it."""
    teacher_cfg = dataclasses.replace(config_libri100(), bidirectional=True)
    cfg_path = os.path.join(tmp, "libri100_bilstm.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(teacher_cfg), f)
    tdir = os.path.join(tmp, "teacher")
    cli_json(["--config", cfg_path, "--data", "synthetic", "--steps", "2",
              "--batch-size", str(DISTILL_CLI_B), "--max-frames", "200",
              "--max-labels", "20", "--eval-every", "0", "--ckpt-dir", tdir,
              "--seed", str(seed), "--device", dev.type], 2, "teacher")
    teacher = ckpt.restore_checkpoint(tdir, device=dev)[0].params
    check(ckpt.load_model_config(tdir).bidirectional,
          "the teacher checkpoint is not a BiLSTM")
    cfg = config_libri100()
    tcfg = TrainConfig(batch_size=TRAIN_B, warmup_steps=100,
                       total_steps=10000, distill_weight=0.3,
                       distill_temp=2.0, seed=seed)
    state = tl.init_train_state(np.random.default_rng(seed + 80), cfg, tcfg,
                                dev)
    step = tl.make_train_step(cfg, tcfg, teacher_cfg=teacher_cfg, device=dev)
    batch = bench_batch(cfg, seed + 80, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, res = timed_steps(lambda st, *b: step(st, *b, teacher), state,
                             batch)
    check_step_counts(res, DISTILL_STEP, "the distillation steps")
    res.update({"B": TRAIN_B, "T": TRAIN_T, "U": TRAIN_U, "dtype": "bfloat16",
                "card": card_line()})
    print("recipe_distill_bf16 " + json.dumps(res))
    del state, step
    torch.cuda.empty_cache()

    # f32 at B=4: the student's loss and gradients, kernels vs plain
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    t32 = dataclasses.replace(teacher_cfg, compute_dtype="float32")
    params = m.init_params(c32, np.random.default_rng(seed + 81), dev)
    small = bench_batch(c32, seed + 81, dev, B=DISTILL_F32_B, ragged=True)
    flat, spec = torch.utils._pytree.tree_flatten(params)

    def loss_and_grads(plain: bool):
        with plain_kernels() if plain else contextlib.nullcontext():
            xs = [p.detach().requires_grad_(True) for p in flat]
            loss, _ = tl.distill_loss_fn(
                torch.utils._pytree.tree_unflatten(xs, spec), teacher, c32,
                t32, *small, distill_weight=0.3, distill_temp=2.0)
            return float(loss.detach()), torch.autograd.grad(loss, xs)

    reset_counts()
    lk, gk = loss_and_grads(False)
    f32_counts = read_counts()
    lp, gp = loss_and_grads(True)
    f32 = {"B": DISTILL_F32_B, "T": TRAIN_T, "U": TRAIN_U, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_worst_rel_err": max(rel_err(a, b) for a, b in zip(gk, gp)),
           "loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL,
           "launches": {k: v for k, v in f32_counts.items() if v}}
    print("recipe_distill_f32 " + json.dumps(f32))
    check_step_counts({"launches": f32_counts, "steps": 1}, DISTILL_STEP,
                      "the f32 distillation loss")
    check(f32["loss_rel_err"] <= LOSS_RTOL,
          f"f32 distillation loss: kernels {lk} vs plain {lp}")
    check(f32["grad_worst_rel_err"] <= GRAD_RTOL,
          f"f32 distillation gradients: {f32['grad_worst_rel_err']}")
    del gk, gp, params
    torch.cuda.empty_cache()

    reset_counts()
    cli = cli_json(["--config", "libri100", "--data", "synthetic", "--steps",
                    "2", "--batch-size", str(DISTILL_CLI_B), "--max-frames",
                    "200", "--max-labels", "20", "--eval-every", "0",
                    "--distill-from", tdir, "--distill-temp", "2.0",
                    "--seed", str(seed), "--device", dev.type], 2,
                   "distill")
    counts = read_counts()
    print("recipe_distill_cli " + json.dumps(
        {k: v for k, v in counts.items() if v}))
    check_step_counts({"launches": counts, "steps": 2}, DISTILL_STEP,
                      "the --distill-from CLI")
    return {"bf16": res, "f32": f32, "cli": cli, "cli_launches": counts}


def recipe_mwer(batch, seed: int, dev) -> dict:
    """(c) libri100 made to emit by `emitting_model`, on the first MWER_B
    rows of the corpus's 400-frame batch, beam 4, 2 expansions, 64
    symbols. f32: the N-best through the kernels and the plain versions
    (`beams_agree`), then the risk and its gradients on the kernels'
    N-best both ways (LOSS_RTOL, GRAD_RTOL); bf16: MWER_STEPS steps of
    make_train_step(loss_kind="mwer"), each timed to a synchronise, the
    beam alone on the same batch (its share of a step), launches a step by
    MWER_STEP; the CLI with --mwer-steps 2 of 3."""
    from rnn_transducer_tpu_torch.decode.beam import beam_search
    from rnn_transducer_tpu_torch.train import mwer

    cfg = config_libri100()
    params = m.init_params(cfg, np.random.default_rng(seed + 90), dev)
    cal = emitting_model(params, cfg, dev, np.random.default_rng(seed + 91),
                         (200, 400))
    feats, fl, labels, ll = (torch.from_numpy(x[:MWER_B]).to(dev)
                             for x in batch)
    kw = dict(beam=MWER_BEAM, expansions=MWER_EXPANSIONS,
              max_symbols=MWER_MAX_SYMBOLS)
    c32 = dataclasses.replace(cfg, compute_dtype="float32")

    def nbest(plain: bool):
        with plain_kernels() if plain else contextlib.nullcontext(), \
                torch.no_grad():
            enc, lens = m.encode(params, c32, feats, fl)
            return tuple(beam_search(params, c32, enc, lens, **kw)[:3])

    got, want = nbest(False), nbest(True)
    agree = beams_agree(tuple(t.cpu().numpy() for t in got),
                        tuple(t.cpu().numpy() for t in want), "mwer f32")
    hyps, hyp_lens, scores = got
    valid = scores > mwer.NEG_INF / 2
    distinct = [len({tuple(h[:n].tolist()) for h, n, v in zip(
        hyps[b].cpu(), hyp_lens[b].tolist(), valid[b].tolist()) if v})
        for b in range(hyps.shape[0])]
    flat, spec = torch.utils._pytree.tree_flatten(params)

    def risk_and_grads(plain: bool, weights=None):
        """The hypotheses' log-probs, the risk, its weights d risk / d
        logp, and the params' gradients of sum(weights * logp) with these
        weights and with `weights` (the kernels' run's) where given."""
        with plain_kernels() if plain else contextlib.nullcontext():
            xs = [p.detach().requires_grad_(True) for p in flat]
            p = torch.utils._pytree.tree_unflatten(xs, spec)
            enc, lens = m.encode(p, c32, feats, fl)
            logp = mwer.hyp_logprobs(p, c32, enc, lens, hyps, hyp_lens)
            per_utt = mwer.expected_edits(logp, valid, hyps, hyp_lens,
                                          labels, ll)
            risk = per_utt.mean()
            w = torch.autograd.grad(risk, logp, retain_graph=True)[0]
            own = torch.autograd.grad(logp, xs, w, retain_graph=True)
            fixed = (own if weights is None else
                     torch.autograd.grad(logp, xs, weights))
            return logp.detach(), float(risk.detach()), w, own, fixed

    lk, rk, wk, gk, _ = risk_and_grads(False)
    lp, rp, _, gp, fp = risk_and_grads(True, wk)
    live = valid & (lp.abs() > 0)
    # the risk's weights d risk / d logp_k = p_k (W_k - W_bar) / B are
    # differences of nearly equal f32 numbers when one hypothesis holds
    # almost all of a row's mass (p_hat up to 0.999994 here; W_bar then
    # sits within an ulp of W_top), so the risk's own gradient differs
    # between two runs by f32 rounding, whatever computes the lattices;
    # the kernels are held on what they compute: the log-probs
    # (LOSS_RTOL) and the gradient of sum(w * logp) with the kernels'
    # weights w on both paths (GRAD_RTOL)
    f32 = {"B": MWER_B, "T": int(feats.shape[1]), "U": int(labels.shape[1]),
           **kw, "calibration_offset": cal["offset"], "beams": agree,
           "distinct_hyps": distinct, "risk_kernels": rk, "risk_plain": rp,
           "risk_rel_err": abs(rk - rp) / abs(rp),
           "logp_max_abs": float(lp[valid].abs().max()),
           "logp_max_abs_err": float((lk - lp)[valid].abs().max()),
           "logp_worst_rel_err": float(((lk - lp).abs() / lp.abs())[live]
                                       .max()),
           "p_hat_max": torch.softmax(torch.where(
               valid, lk, torch.full_like(lk, mwer.NEG_INF)), -1)
           .max(-1).values.tolist(),
           "grad_fixed_weights_worst_rel_err": max(
               rel_err(a, b) for a, b in zip(gk, fp)),
           "grad_own_weights_worst_rel_err": max(
               rel_err(a, b) for a, b in zip(gk, gp)),
           "loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL}
    print("recipe_mwer_f32 " + json.dumps(f32))
    check(sum(d > 1 for d in distinct) >= len(distinct) // 2,
          f"MWER: the N-best of fewer than half the rows differ: {distinct}")
    check(f32["risk_rel_err"] <= LOSS_RTOL,
          f"f32 MWER risk: kernels {rk} vs plain {rp}")
    check(f32["logp_worst_rel_err"] <= LOSS_RTOL,
          f"f32 MWER hypothesis log-probs: {f32['logp_worst_rel_err']}")
    check(f32["grad_fixed_weights_worst_rel_err"] <= GRAD_RTOL,
          "f32 MWER gradients (the kernels' weights): "
          f"{f32['grad_fixed_weights_worst_rel_err']}")
    del gk, gp, fp
    torch.cuda.empty_cache()

    tcfg = TrainConfig(batch_size=MWER_B, warmup_steps=1, mwer_beam=MWER_BEAM,
                       mwer_expansions=MWER_EXPANSIONS,
                       mwer_max_symbols=MWER_MAX_SYMBOLS)
    state = tl.init_train_state(None, cfg, tcfg, params=params)
    step = tl.make_train_step(cfg, tcfg, device=dev, loss_kind="mwer")
    state, info = step(state, feats, fl, labels, ll)  # warm
    torch.cuda.synchronize()
    reset_counts()
    ms, risks = [], []
    for _ in range(MWER_STEPS):
        t0 = time.perf_counter()
        state, info = step(state, feats, fl, labels, ll)
        risks.append(float(info["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(int(info["skipped_nonfinite"]) == 0, "an MWER step skipped")
    counts = read_counts()
    with torch.no_grad():
        enc, lens = m.encode(state.params, cfg, feats, fl)
        torch.cuda.synchronize()
        beam_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            beam_search(state.params, cfg, enc, lens, **kw)[2].cpu()
            beam_ms.append((time.perf_counter() - t0) * 1e3)
    bf16 = {"B": MWER_B, "T": int(feats.shape[1]), "dtype": "bfloat16",
            "ms_per_step": statistics.mean(ms), "step_ms": ms,
            "beam_ms": min(beam_ms), "beam_share": min(beam_ms)
            / statistics.mean(ms), "risks": risks,
            "launches": {k: v for k, v in counts.items() if v},
            "card": card_line()}
    print("recipe_mwer_bf16 " + json.dumps(bf16))
    check(all(np.isfinite(risks)), f"MWER risks {risks}")
    check_step_counts({"launches": counts, "steps": MWER_STEPS}, MWER_STEP,
                      "the MWER steps")
    del state, step
    torch.cuda.empty_cache()

    reset_counts()
    cli = cli_json(["--config", "libri100", "--data", "synthetic", "--steps",
                    "3", "--mwer-steps", "2", "--mwer-beam", str(MWER_BEAM),
                    "--batch-size", str(MWER_B), "--max-frames", "200",
                    "--max-labels", "20", "--eval-every", "0", "--seed",
                    str(seed), "--device", dev.type], 3, "mwer")
    counts = read_counts()
    print("recipe_mwer_cli " + json.dumps(
        {k: v for k, v in counts.items() if v}))
    # one NLL step (fused: K1 / K2) and two MWER steps
    check(counts["lstm_fwd_with_acts"] == 15 and counts["lstm_bwd"] == 15
          and counts["lattice_alpha"] == counts["lattice_beta"] == 3
          and counts["joint_fwd"] == counts["joint_bwd"] == 1,
          f"the --mwer-steps CLI's launches {counts}")
    return {"f32": f32, "bf16": bf16, "cli": cli, "cli_launches": counts}


def recipes_phase(seed: int, dev, corpus: dict, tmp: str,
                  load_5g=None) -> dict:
    """Phase 5h: the training recipes, (a)-(c) above, on phase 5g's
    corpus; each part's seconds on a line of their own."""
    out, seconds = {}, {}
    for name, fn in (
            ("loader_gate", lambda: recipe_loader_gate(corpus, dev)),
            ("loader_cli", lambda: recipe_loader_cli(corpus, seed, tmp,
                                                     dev, load_5g)),
            ("distill", lambda: recipe_distill(seed, tmp, dev)),
            ("mwer", lambda: recipe_mwer(out["loader_gate"][400], seed,
                                         dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("recipe_seconds " + json.dumps(seconds))
    return out



# ------------------------------ phase 5i ---------------------------------

# Phase 5i's model: libri100 (4x512 LSTM, 2x stacking, V=1024, bf16) with
# the stateless predictor at JAX's default context of 2 and the CTC head,
# the CTC term at the CLI's typical --ctc-weight.
CTC_WEIGHT = 0.3
STATELESS = dict(pred_type="stateless", pred_context=2, ctc_head=True)
CTC_F32_B = 4  # the f32 gates' batch (rows of bench_batch, ragged)
CTC_BUCKET = 400  # (c)'s utterances: 150-400 frames, one serving bucket
# Per-step launches of the bf16 cells. CTC pretraining: the encoder's 4
# layers (K4 with activations and K4-bwd), no joint, no RNN-T lattice
# (the CTC lattice is plain PyTorch). Multitask: those and the LSTM
# predictor's, and K1, K2 and K3 once each (the fused route). Stateless:
# the multitask step without the predictor's recurrence. The conformer:
# the predictor's K4, 48 LayerNorms (K8), K1 / K2 / K3. libri960: 6 + 2
# layers, the two-pass route (K5, K3).
NO_LAUNCH = {k: 0 for k in ("lstm_fwd", "lstm_fwd_with_acts", "lstm_bwd",
                            "joint_fwd", "joint_bwd", "lattice_alpha",
                            "lattice_beta", "extract_lp", "assemble_grad",
                            "lstm_fwd_int8", "greedy_fused", "fused_ln_fwd",
                            "fused_ln_bwd")}
CTC_STEP = {**NO_LAUNCH, "lstm_fwd_with_acts": 4, "lstm_bwd": 4}
MULTITASK_STEP = {**CTC_STEP, "lstm_fwd_with_acts": 5, "lstm_bwd": 5,
                  "joint_fwd": 1, "joint_bwd": 1, "lattice_alpha": 1,
                  "lattice_beta": 1}
STATELESS_STEP = {**MULTITASK_STEP, "lstm_fwd_with_acts": 4, "lstm_bwd": 4}
CONF_STEP = {**MULTITASK_STEP, "lstm_fwd_with_acts": 1, "lstm_bwd": 1,
             "fused_ln_fwd": LN_PER_ENCODE, "fused_ln_bwd": LN_PER_ENCODE}
L960_STEP = {**NO_LAUNCH, "lstm_fwd_with_acts": 8, "lstm_bwd": 8,
             "extract_lp": 1, "assemble_grad": 1, "lattice_alpha": 1,
             "lattice_beta": 1}


def remat_step(want: dict, cfg) -> dict:
    """A step's launches under remat_encoder: every encoder layer's (or
    block's) forward kernels run again in the backward."""
    if cfg.enc_type == "conformer":
        return {**want, "fused_ln_fwd": 2 * want["fused_ln_fwd"]}
    return {**want, "lstm_fwd_with_acts": want["lstm_fwd_with_acts"]
            + cfg.enc_layers * (2 if cfg.bidirectional else 1)}


def ctc_f32_gate(what: str, cfg, seed: int, dev, fn, U: int = TRAIN_U,
                 remat: bool = False, **kw) -> dict:
    """(a) One f32 loss and its gradients, fn(params, cfg, *batch, **kw),
    on CTC_F32_B ragged rows of bench.py's batch through the kernels and
    the plain versions (LOSS_RTOL, GRAD_RTOL; the conformer's attention
    key bias held to 1e-4 of the largest gradient, its noise level, as in
    `f32_kernels_vs_plain`); with remat=True also through the kernels with
    remat_encoder, whose loss and gradients should be the same bits, and
    whose launches show each encoder layer recomputed."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    params = m.init_params(cfg, np.random.default_rng(seed), dev)
    batch = bench_batch(cfg, seed, dev, U, CTC_F32_B, ragged=True)
    flat, spec = torch.utils._pytree.tree_flatten(params)
    noise = [n.endswith("/att/k/b") for n in leaf_paths(params)]

    def run(c, plain: bool):
        with plain_kernels() if plain else contextlib.nullcontext():
            xs = [p.detach().requires_grad_(True) for p in flat]
            reset_counts()
            loss, _ = fn(torch.utils._pytree.tree_unflatten(xs, spec), c,
                         *batch, **kw)
            grads = torch.autograd.grad(loss, xs, allow_unused=True)
            torch.cuda.synchronize()
            counts = read_counts()
        return (float(loss.detach()), [torch.zeros_like(x) if g is None
                                       else g for x, g in zip(xs, grads)],
                {k: v for k, v in counts.items() if v})

    lk, gk, ck = run(cfg, plain=False)
    lp, gp, _ = run(cfg, plain=True)
    top = max(float(a.abs().max()) for a in gp)
    row = {"what": what, "B": CTC_F32_B, "T": TRAIN_T, "U": U,
           "loss_kernels": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_worst_rel_err": max(rel_err(a, b) for a, b, z
                                     in zip(gk, gp, noise) if not z),
           "key_bias_max_abs": max([float(a.abs().max()) for a, z in
                                    zip(gk + gp, noise + noise) if z]
                                   or [0.0]),
           "max_abs_grad": top, "loss_rtol": LOSS_RTOL,
           "grad_rtol": GRAD_RTOL, "launches": ck}
    if remat:
        lr_, gr, cr = run(dataclasses.replace(cfg, remat_encoder=True),
                          plain=False)
        row.update(remat_launches=cr, remat_loss=lr_,
                   remat_same_bits=lr_ == lk and all(
                       torch.equal(a, b) for a, b in zip(gr, gk)),
                   remat_loss_gap=abs(lr_ - lk),
                   remat_grad_gap=max(float((a - b).abs().max())
                                      for a, b in zip(gr, gk)))
        want = remat_step({k: ck.get(k, 0) for k in NO_LAUNCH}, cfg)
        check(all(cr.get(k, 0) == v for k, v in want.items()),
              f"f32 {what} with remat launched {cr}, not {want}")
        check(abs(lr_ - lp) / abs(lp) <= LOSS_RTOL and max(
            rel_err(a, b) for a, b, z in zip(gr, gp, noise) if not z)
            <= GRAD_RTOL, f"f32 {what} with remat against the plain path")
    print("ctc_f32 " + json.dumps(row))
    check(row["loss_rel_err"] <= LOSS_RTOL,
          f"f32 {what}: loss kernels {lk} vs plain {lp}")
    check(row["grad_worst_rel_err"] <= GRAD_RTOL,
          f"f32 {what}: gradients {row['grad_worst_rel_err']}")
    check(row["key_bias_max_abs"] <= 1e-4 * top,
          f"f32 {what}: key-bias gradients above noise level")
    return row


def ctc_gates(seed: int, dev) -> dict:
    """(a) The f32 gates: the CTC pretraining loss, the fused multitask
    loss, the stateless fused loss, and libri100_conformer and libri100
    with and without remat."""
    lib = dataclasses.replace(config_libri100(), ctc_head=True)
    out = {
        "ctc": ctc_f32_gate("ctc_pretrain", lib, seed + 90, dev,
                            tl.ctc_loss_fn),
        "multitask": ctc_f32_gate("multitask", lib, seed + 91, dev,
                                  tl.loss_fn, loss_impl="fused",
                                  ctc_weight=CTC_WEIGHT),
        "stateless": ctc_f32_gate(
            "stateless", dataclasses.replace(config_libri100(), **STATELESS),
            seed + 92, dev, tl.loss_fn, loss_impl="fused",
            ctc_weight=CTC_WEIGHT),
        "conformer": ctc_f32_gate("conformer", config_libri100_conformer(),
                                  seed + 93, dev, tl.loss_fn, remat=True,
                                  loss_impl="fused"),
        "lstm": ctc_f32_gate("lstm", config_libri100(), seed + 94, dev,
                             tl.loss_fn, remat=True, loss_impl="fused")}
    torch.cuda.empty_cache()
    return out


def ctc_cell(what: str, cfg, seed: int, dev, want: dict, B: int, U: int,
             profile: bool = False, profile_dir=None, loss_kind: str = "rnnt",
             params=None, **tcfg_kw) -> dict:
    """(b) bf16 steps of one cell at bench.py's T=400: ms a step by slope,
    peak GB, launches a step (`want`); with profile (a CTC cell) a
    profiled step and the share of its wall time in the CTC spans (the
    forward's `ctc` and the backward's `ctc_backward`). `params` (the
    step leaves them as they are) spares a second init of a remat pair."""
    tcfg = TrainConfig(batch_size=B, warmup_steps=100, total_steps=10000,
                       **tcfg_kw)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev,
                                params=params)
    step = tl.make_train_step(cfg, tcfg, device=dev, loss_kind=loss_kind)
    batch = bench_batch(cfg, seed, dev, U, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, res = timed_steps(step, state, batch, B)
    check_step_counts(res, want, f"phase 5i's {what} steps")
    res.update({"what": what, "B": B, "T": TRAIN_T, "U": U,
                "dtype": "bfloat16", "remat": cfg.remat_encoder,
                "launches_per_step": {k: v / res["steps"] for k, v in
                                      res["launches"].items() if v}})
    if profile:
        # one window: the spans' host ms are read, not kernel counts
        state, prof = profile_step(step, state, batch, profile_dir,
                                   f"ctc_{what}_step", windows=1)
        host, span = prof["host_span_ms"], prof["device_span_ms"]
        ctc_ms = host.get("ctc", 0.0) + host.get("ctc_backward", 0.0)
        res["profile"] = {"wall_ms": prof["wall_ms"],
                          "device_busy_share": prof["device_busy_share"],
                          "host_span_ms": host, "device_span_ms": span,
                          "ctc_host_ms": ctc_ms,
                          "ctc_share": ctc_ms / prof["wall_ms"],
                          "top_device_ops": prof["top_device_ops"][:5]}
    res["card"] = card_line()
    print("ctc_bf16 " + json.dumps(res))
    del state, step
    torch.cuda.empty_cache()
    return res


def ctc_cells(seed: int, dev, profile_dir) -> dict:
    """(b) The bf16 cells: CTC pretraining, the multitask step and the
    stateless hybrid at (32, 400, 40) (each with a profiled step);
    libri100_conformer at B=64 and libri960 at B=64, U=60 with and without
    remat; `remat_saved_gb` and `remat_added_ms` of the last two."""
    lib = dataclasses.replace(config_libri100(), ctc_head=True)
    sl = dataclasses.replace(config_libri100(), **STATELESS)
    prof = dict(profile=True, profile_dir=profile_dir)
    out = {
        "ctc": ctc_cell("ctc_pretrain", lib, seed + 95, dev, CTC_STEP,
                        TRAIN_B, TRAIN_U, loss_kind="ctc", **prof),
        "multitask": ctc_cell("multitask", lib, seed + 96, dev,
                              MULTITASK_STEP, TRAIN_B, TRAIN_U,
                              ctc_weight=CTC_WEIGHT, **prof),
        "stateless": ctc_cell("stateless", sl, seed + 97, dev,
                              STATELESS_STEP, TRAIN_B, TRAIN_U,
                              ctc_weight=CTC_WEIGHT, **prof)}
    for name, cfg, want, B, U in (
            ("conformer", config_libri100_conformer(), CONF_STEP, CONF_B,
             CONF_U),
            ("libri960", config_libri960(), L960_STEP, L960_B, L960_U)):
        params = m.init_params(cfg, np.random.default_rng(seed + 98), dev)
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat_encoder=remat)
            out[f"{name}{'_remat' if remat else ''}"] = ctc_cell(
                name + ("_remat" if remat else ""), c, seed + 98, dev,
                remat_step(want, c) if remat else want, B, U, params=params)
        del params
        a, b = out[name], out[f"{name}_remat"]
        row = {"what": name, "remat_saved_gb": a["peak_mem_gb"]
               - b["peak_mem_gb"], "remat_added_ms": b["ms_per_step"]
               - a["ms_per_step"], "card": card_line()}
        print("ctc_remat " + json.dumps(row))
        out[f"{name}_remat_delta"] = row
    return out


def ctc_tokens(params, cfg, dev, feats, lens) -> dict:
    """(c) f32 tokens through the kernels and through the plain versions:
    stateless greedy, its beam (`beams_agree`), CTC greedy and the CTC
    prefix beam's n-best (equal lists, scores within BEAM_SCORE_ATOL)."""
    from rnn_transducer_tpu_torch.decode.ctc import recognize_ctc

    c = dataclasses.replace(cfg, compute_dtype="float32")
    out = {}
    _, tok_k = decode_batch(params, c, feats, lens, plain=False)
    _, tok_p = decode_batch(params, c, feats, lens, plain=True)
    check(tok_k == tok_p, "stateless greedy: f32 tokens differ between the "
                          "kernel path and the plain path")
    out["greedy_tokens"] = [len(t) for t in tok_k]
    out["beam"] = beams_agree(*decode_beam_pair(params, c, feats, lens),
                              "stateless")

    def ctc(mode: str, plain: bool):
        with plain_kernels() if plain else contextlib.nullcontext(), \
                torch.inference_mode():
            res = recognize_ctc(params, c, feats, lens, mode=mode, beam=BEAM,
                                max_symbols=MAX_SYMBOLS)
        return [a.cpu().numpy() for a in res]

    gk, gp = ctc("greedy", False), ctc("greedy", True)
    check(all(np.array_equal(a, b) for a, b in zip(gk, gp)),
          "CTC greedy: f32 tokens differ between the kernel path and the "
          "plain path")
    out["ctc_greedy_tokens"] = gk[1].tolist()
    bk, bp = ctc("beam", False), ctc("beam", True)
    live = bp[2] > -5e29
    check(np.array_equal(bk[0], bp[0]) and np.array_equal(bk[1], bp[1])
          and np.array_equal(bk[2] > -5e29, live)
          and float(np.abs(bk[2] - bp[2])[live].max()) <= BEAM_SCORE_ATOL,
          "CTC prefix beam: the f32 n-best differs between the kernel path "
          "and the plain path")
    out["ctc_beam_top_lengths"] = bk[1][:, 0].tolist()
    out["ctc_beam_max_score_err"] = float(np.abs(bk[2] - bp[2])[live].max())
    print("ctc_tokens " + json.dumps(out))
    check(sum(out["greedy_tokens"]) > 0 and sum(out["ctc_greedy_tokens"]) > 0,
          "the f32 token checks compare empty lists")
    return out


def ctc_serving(params, cfg, dev, utts) -> dict:
    """(c) The stateless model in the engines on the card, one bucket of
    CTC_BUCKET frames: a greedy and a beam BatchingEngine (4 K4-fwd launches a batch, no K9), a
    StreamingEngine session (4 a tick) and an int8 engine (4 K7 a batch, no
    K4-fwd), the launches read around the served requests."""
    out = {}
    for what, p, kw, kernel in (
            ("greedy", params, {}, "lstm_fwd"),
            ("beam", params, {"mode": "beam", "beam": BEAM,
                              "expansions": EXPANSIONS}, "lstm_fwd"),
            ("int8", quantize_params(params), {}, "lstm_fwd_int8")):
        eng = BatchingEngine(p, cfg, max_symbols=MAX_SYMBOLS, device=dev,
                             frame_buckets=(CTC_BUCKET,), **kw)
        try:
            eng.warmup()
            torch.cuda.synchronize()
            reset_counts()
            answers = serve_requests(eng, utts)
            counts = read_counts()
            batches = eng.stats.summary()["batches"]
        finally:
            eng.close()
        others = {k: v for k, v in counts.items() if v and k != kernel}
        row = {"requests": len(answers), "batches": batches,
               "launches": counts[kernel], "other_launches": others,
               "tokens": [len(a[1]["tokens"]) for a in answers]}
        print(f"ctc_serve_{what} " + json.dumps(row))
        check(all(a[0] == 200 for a in answers) and not others
              and counts[kernel] == cfg.enc_layers * batches,
              f"stateless {what} serving: {row}")
        out[what] = row
    st = StreamingEngine(params, cfg, max_symbols=MAX_SYMBOLS, device=dev)
    try:
        st.warmup()
        torch.cuda.synchronize()
        reset_counts()
        sid = st.open_session()
        utt = utts[0]
        ticks = 0
        for t0 in range(0, utt.shape[0], CHUNK_FRAMES):
            res = st.feed_full(sid, utt[t0:t0 + CHUNK_FRAMES])
            ticks += 1
        final = st.close_session(sid)
        counts = read_counts()
    finally:
        st.close()
    row = {"ticks": ticks, "launches": counts["lstm_fwd"],
           "tokens": len(final), "stable_len": res["stable_len"]}
    print("ctc_serve_session " + json.dumps(row))
    check(counts["lstm_fwd"] == cfg.enc_layers * ticks
          and counts["lstm_fwd_int8"] == 0 and counts["greedy_fused"] == 0,
          f"stateless streaming: {row}")
    out["session"] = row
    return out


def ctc_cli(seed: int, tmp: str, dev) -> dict:
    """(c) The CLI path on synthetic B=8 data: the training CLI (libri100,
    --pred-type stateless, 2 CTC steps then 2 RNN-T steps with
    --ctc-weight 0.3) with its launches and phases; the decode CLI on its
    checkpoint in greedy, beam, ctc_greedy and ctc_beam with a trigram (4
    K4-fwd launches an encode: a warm-up and a timed batch); serve.py
    --ckpt-dir (greedy with a /session, --mode beam, --quantize int8); on
    a fresh model of its config made to emit by `emitting_model`, the
    engines in this process (`ctc_serving`) and the f32 tokens of the
    kernel and the plain paths (`ctc_tokens`)."""
    from rnn_transducer_tpu_torch.models.ngram import save_ngram, train_ngram
    from rnn_transducer_tpu_torch.recognize import main as recognize_cli

    d = os.path.join(tmp, "stateless_ctc")
    log = os.path.join(tmp, "stateless_ctc.jsonl")
    reset_counts()
    cli = cli_json(["--config", "libri100", "--pred-type", "stateless",
                    "--ctc-pretrain-steps", "2", "--ctc-weight",
                    str(CTC_WEIGHT), "--steps", "4", "--batch-size", "8",
                    "--max-frames", "200", "--max-labels", "20",
                    "--warmup-steps", "1", "--log-every", "1",
                    "--eval-every", "0", "--log-file", log, "--ckpt-dir", d,
                    "--seed", str(seed), "--device", dev.type], 4,
                   "stateless_ctc")
    counts = read_counts()
    phases = [r["phase"] for r in map(json.loads, open(log)) if "loss" in r]
    cfg = ckpt.load_model_config(d)
    want = {k: 2 * (CTC_STEP[k] + STATELESS_STEP[k]) for k in NO_LAUNCH}
    row = {"phases": phases, "launches": {k: v for k, v in counts.items()
                                          if v},
           "pred_type": cfg.pred_type, "pred_context": cfg.pred_context,
           "ctc_head": cfg.ctc_head}
    print("ctc_cli_train " + json.dumps(row))
    check(phases == ["ctc", "ctc", "rnnt", "rnnt"],
          f"the training CLI's phases: {phases}")
    check(cfg == dataclasses.replace(config_libri100(), **STATELESS),
          f"the checkpoint's config: {cfg}")
    check_step_counts({"launches": counts, "steps": 1}, want,
                      "the stateless CTC training CLI")
    out = {"train": cli, "train_row": row}

    trigram = os.path.join(tmp, "ctc_lm3")
    rng = np.random.default_rng(seed + 99)
    save_ngram(train_ngram([rng.integers(1, cfg.vocab_size, size=20).tolist()
                            for _ in range(200)], 3, cfg.vocab_size), trigram)
    for mode, extra in (("greedy", []), ("beam", []), ("ctc_greedy", []),
                        ("ctc_beam", ["--ngram", trigram + ".npz"])):
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = recognize_cli(["--ckpt-dir", d, "--mode", mode,
                                 "--batch-size", "8", "--batches", "1",
                                 "--beam", str(BEAM), "--device", dev.type,
                                 *extra])
        counts = read_counts()
        others = {k: v for k, v in counts.items() if v and k != "lstm_fwd"}
        row = {"mode": mode, "out": got, "lstm_fwd": counts["lstm_fwd"],
               "other_launches": others}
        print("ctc_cli_decode " + json.dumps(row))
        check(got["n"] == 8 and np.isfinite(got["wer"]) and not others
              and counts["lstm_fwd"] == 2 * cfg.enc_layers,
              f"the decode CLI --mode {mode}: {row}")
        out[f"decode_{mode}"] = row

    # a fresh model of the checkpoint's config made to emit (the 4-step
    # checkpoint itself needs a blank offset of ~7, outside the [-4, 4]
    # that `emitting_model` searches, and then emits ~2 tokens a row),
    # served and decoded: 8 utterances of 150-800 frames (noise from the
    # seed) in the 400-frame bucket
    params = m.init_params(cfg, np.random.default_rng(seed + 102), dev)
    cal = emitting_model(params, cfg, dev, np.random.default_rng(seed + 101),
                         (150, CTC_BUCKET))
    print("emitting_model " + json.dumps({"what": "stateless_ctc", **cal}))
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(150, CTC_BUCKET + 1, size=MAX_BATCH)
    lengths[:2] = (150, CTC_BUCKET)
    srv = {"cfg": cfg, "lengths": lengths,
           "utts": [rng.normal(size=(int(T), cfg.input_dim)).astype(
               np.float32) for T in lengths]}
    feats, lens = served_batch(srv, dev, CTC_BUCKET)
    out["tokens"] = ctc_tokens(params, cfg, dev, feats, lens)
    out["serve"] = ctc_serving(params, cfg, dev, srv["utts"])
    # the three servers at once: each a process of its own on the card
    utt = srv["utts"][0]
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(serve_cli, ["--ckpt-dir", d, *extra], utt, None)
                for extra in ([], ["--mode", "beam"], ["--quantize", "int8"])]
        out["serve_cli"] = [f.result() for f in futs]
    return out


def ctc_phase(seed: int, dev, profile_dir, tmp: str) -> dict:
    """Phase 5i: CTC, the stateless predictor and encoder remat, (a)-(c)
    above; each part's seconds on a line of their own, and the launches
    of the bf16 cells, the engines and the CLIs for the kernels line."""
    out, seconds = {}, {}
    for name, fn in (("gates", lambda: ctc_gates(seed, dev)),
                     ("cells", lambda: ctc_cells(seed, dev, profile_dir)),
                     ("cli", lambda: ctc_cli(seed, tmp, dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("ctc_seconds " + json.dumps(seconds))
    launches = dict.fromkeys(NO_LAUNCH, 0)
    for cell in out["cells"].values():
        for k, v in cell.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    serve = out["cli"]["serve"]
    launches["lstm_fwd"] += (serve["greedy"]["launches"]
                             + serve["beam"]["launches"]
                             + serve["session"]["launches"])
    launches["lstm_fwd_int8"] += serve["int8"]["launches"]
    out["launches"] = launches
    print("ctc_launches " + json.dumps(launches))
    return out


# ------------------------------ phase 5j ---------------------------------

# The duration families at libri100 width: multi-blank with big blanks of
# 2, 4 and 8 frames (the joint's 1027 columns) and TDT over the durations
# 0, 1, 2 and 4 (a 4-logit duration head); tools/bench_duration.py's sets.
DUR_FAMILIES = {"multiblank": dict(big_blank_durations=(2, 4, 8)),
                "tdt": dict(tdt_durations=(0, 1, 2, 4))}
DUR_F32_B = 4  # the f32 gates' batch (rows of bench_batch, ragged)
DUR_BUCKET = 400  # the decode gates' utterances: 150-400 frames
DUR_SESSIONS = 4  # streaming sessions in the gates and per served CLI
# The jump models (`jump_models`): the big blanks' noise, in units of the
# output columns' spread, and the TDT durations' > 1 bias.
DUR_NOISE, DUR_JUMP_BIAS = 0.1, 0.3
# A bf16 step of either family: the encoder's 4 layers and the predictor
# through K4 each way; the xla route runs no K1, K2, K3 or K5 (the
# consumed-frames lattice is plain PyTorch).
DUR_STEP = {**NO_LAUNCH, "lstm_fwd_with_acts": 5, "lstm_bwd": 5}


def dur_cfg(family: str, **kw):
    return dataclasses.replace(config_libri100(), **DUR_FAMILIES[family],
                               **kw)


class StepRecorder(m.DecodeWeights):
    """DecodeWeights that keeps each lock-step iteration's argmax class
    (and, for TDT, its argmax duration index): one joint call an
    iteration of `greedy_decode`."""

    def __init__(self, params, cfg):
        super().__init__(params, cfg)
        self.ks, self.ds = [], []

    def joint(self, f, g):
        logits = super().joint(f, g)
        self.ks.append(logits.argmax(-1))
        return logits

    def joint_tdt(self, f, g):
        logits, dur = super().joint_tdt(f, g)
        self.ks.append(logits.argmax(-1))
        self.ds.append(dur.argmax(-1))
        return logits, dur


def replay_steps(rec: StepRecorder, cfg, lens, max_symbols: int) -> dict:
    """greedy_decode's state machine replayed on the host from the
    recorded argmaxes: its lock-step iterations, each row's steps, the
    jumps taken (an advance of more than one frame) and the tokens."""
    ks = torch.stack(rec.ks).cpu()
    lens = lens.cpu().to(torch.int64)
    B = ks.shape[1]
    t, u = torch.zeros(B, dtype=torch.int64), torch.zeros(B, dtype=torch.int64)
    steps, jumps = torch.zeros_like(t), torch.zeros_like(t)
    durs = torch.ones(cfg.n_classes, dtype=torch.int64)
    for i, d in enumerate(cfg.big_blank_durations):
        durs[cfg.vocab_size + i] = d
    dvals = torch.tensor(cfg.tdt_durations or (1,), dtype=torch.int64)
    done = (t >= lens) | (u >= max_symbols)
    for i in range(ks.shape[0]):
        k, active = ks[i], ~done
        blank = (k == cfg.blank) | (k >= cfg.vocab_size)
        if cfg.tdt_durations:
            d = dvals[rec.ds[i].cpu()]
            d = torch.where(blank & (d == 0), 1, d)
        else:
            d = torch.where(blank, durs[k], 0)
        steps += active
        jumps += active & (d > 1)
        u += active & ~blank
        t += torch.where(active, d, 0)
        done = (t >= lens) | (u >= max_symbols)
    return {"iterations": int(ks.shape[0]), "row_steps": steps.tolist(),
            "jumps": int(jumps.sum()), "tokens": u.tolist(),
            "frames": int(lens.sum())}


def dur_f32_gate(family: str, seed: int, dev) -> dict:
    """(a) The family's f32 loss and gradients through loss_fn on the card
    (K4 each way) against the same call on the CPU (the plain LSTM),
    DUR_F32_B ragged rows of bench.py's batch: the loss within
    LOSS_RTOL, every gradient leaf within GRAD_RTOL of its largest
    value; 5 K4-fwd and 5 K4-bwd, and no K1, K2, K3 or K5."""
    cfg = dur_cfg(family, compute_dtype="float32")
    params = m.init_params(cfg, np.random.default_rng(seed), dev)
    batch = bench_batch(cfg, seed, dev, TRAIN_U, DUR_F32_B, ragged=True)

    def run(p, b):
        flat, spec = torch.utils._pytree.tree_flatten(p)
        xs = [x.detach().requires_grad_(True) for x in flat]
        reset_counts()
        loss, per_utt = tl.loss_fn(torch.utils._pytree.tree_unflatten(
            xs, spec), cfg, *b)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        if loss.is_cuda:
            torch.cuda.synchronize()
        return (float(loss.detach()), per_utt.detach().cpu(),
                [torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads)], read_counts())

    t0 = time.perf_counter()
    lk, pk, gk, ck = run(params, batch)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp, pp, gp, _ = run(torch.utils._pytree.tree_map(lambda x: x.cpu(),
                                                     params),
                        tuple(a.cpu() for a in batch))
    cpu_s = time.perf_counter() - t0
    row = {"what": family, "B": DUR_F32_B, "T": TRAIN_T, "U": TRAIN_U,
           "classes": cfg.n_classes, "loss_card": lk, "loss_cpu": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "per_utt_max_rel_err": float(((pk - pp).abs()
                                         / pp.abs()).max()),
           "grad_worst_rel_err": max(rel_err(a.cpu(), b)
                                     for a, b in zip(gk, gp)),
           "max_abs_grad": max(float(b.abs().max()) for b in gp),
           "loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL,
           "launches": {k: v for k, v in ck.items() if v},
           "card_s": card_s, "cpu_s": cpu_s}
    print("dur_f32 " + json.dumps(row))
    check(row["loss_rel_err"] <= LOSS_RTOL,
          f"f32 {family}: loss card {lk} vs CPU {lp}")
    check(row["grad_worst_rel_err"] <= GRAD_RTOL,
          f"f32 {family}: gradients {row['grad_worst_rel_err']}")
    check(all(ck[k] == v for k, v in DUR_STEP.items()),
          f"f32 {family}: launches {ck}, not {DUR_STEP}")
    return row


def jump_models(seed: int, dev) -> dict:
    """A libri100 model made to emit by `emitting_setup` (the standard
    family) and its two duration twins on the same encoder, predictor and
    token columns, made to jump: multi-blank's big-blank columns are the
    blank's column plus noise of DUR_NOISE times the columns' spread, at
    the blank's bias (a blank-like frame picks among the four by the
    noise, and the blank-like and the label classes compete as in the
    standard model); TDT's duration head is its init's draws with the
    durations > 1 raised by DUR_JUMP_BIAS."""
    base = config_libri100()
    setup = emitting_setup(seed, MAX_BATCH, dev, base, (150, DUR_BUCKET),
                           "duration_base")
    params = setup["params"]
    rng = np.random.default_rng(seed + 3)
    models = {"standard": (base, params)}
    for family in DUR_FAMILIES:
        cfg = dur_cfg(family)
        p = {**params, "joint": dict(params["joint"])}
        jp = p["joint"]
        if family == "multiblank":
            w, b = jp["out"]["w"], jp["out"]["b"]
            K = len(cfg.big_blank_durations)
            noise = torch.from_numpy(rng.normal(size=(w.shape[0], K))).to(
                w) * (DUR_NOISE * w.std())
            jp["out"] = {"w": torch.cat([w, w[:, cfg.blank:cfg.blank + 1]
                                         + noise], 1),
                         "b": torch.cat([b, b[cfg.blank].repeat(K)])}
        else:
            D = len(cfg.tdt_durations)
            k = 1.0 / np.sqrt(cfg.joint_dim)
            dur_b = torch.from_numpy(rng.uniform(-k, k, D)).float().to(dev)
            dur_b += torch.tensor([DUR_JUMP_BIAS if d > 1 else 0.0
                                   for d in cfg.tdt_durations], device=dev)
            jp["dur"] = {"w": torch.from_numpy(rng.uniform(
                -k, k, (cfg.joint_dim, D))).float().to(dev), "b": dur_b}
        models[family] = (cfg, p)
    return {"models": models, "setup": setup}


def dur_decode_gates(jm_: dict, dev) -> dict:
    """(a) On the models made to jump, f32: greedy tokens, frames and
    t_over equal through the kernels (K4-fwd) and the plain LSTM, with
    the jumps taken; beam n-best (`beams_agree`); DUR_SESSIONS
    StreamingEngine sessions at 32-frame chunks equal to the offline
    greedy tokens, 4 K4-fwd a tick."""
    feats, lens = served_batch(jm_["setup"], dev, DUR_BUCKET)
    utts = jm_["setup"]["utts"][:DUR_SESSIONS]
    out = {}
    for family in DUR_FAMILIES:
        cfg, p = jm_["models"][family]
        c = dataclasses.replace(cfg, compute_dtype="float32")
        res = []
        for plain in (False, True):
            with plain_kernels() if plain else contextlib.nullcontext(), \
                    torch.inference_mode():
                reset_counts()
                enc, el = m.encode(p, c, feats, lens)
                rec = StepRecorder(p, c)
                tok, n, st = greedy_decode(p, c, enc, el, MAX_SYMBOLS,
                                           decode_weights=rec)
                res.append(([tok[b, :n[b]].tolist() for b in range(len(n))],
                            st[3].cpu(), st[7].cpu(), read_counts(),
                            replay_steps(rec, c, el, MAX_SYMBOLS)))
        (tk, fk, ok, ck, sk), (tp, fp, op, _, _) = res
        check(tk == tp and torch.equal(fk, fp) and torch.equal(ok, op),
              f"{family} greedy: f32 tokens, frames or t_over differ "
              "between the kernel path and the plain path")
        check(sk["tokens"] == [len(x) for x in tk],
              f"{family} greedy: the replayed steps disagree: {sk}")
        check(ck["lstm_fwd"] == c.enc_layers,
              f"{family} greedy: {ck['lstm_fwd']} K4-fwd launches")
        check(sk["jumps"] > 0 and sum(sk["tokens"]) > 0,
              f"{family} greedy: no jump taken, or no token: {sk}")
        row = {"what": family, "greedy_tokens": [len(x) for x in tk],
               "t_over": ok.tolist(), "jumps": sk["jumps"],
               "iterations": sk["iterations"]}
        row["beam"] = beams_agree(*decode_beam_pair(p, c, feats, lens),
                                  family)
        st_eng = StreamingEngine(p, c, slots=DUR_SESSIONS,
                                 chunk_frames=CHUNK_FRAMES,
                                 max_symbols=MAX_SYMBOLS, device=dev)
        try:
            st_eng.warmup()
            torch.cuda.synchronize()
            reset_counts()
            sids = [st_eng.open_session() for _ in utts]
            for t0 in range(0, max(u.shape[0] for u in utts), CHUNK_FRAMES):
                for sid, u in zip(sids, utts):
                    if t0 < u.shape[0]:
                        st_eng.feed_full(sid, u[t0:t0 + CHUNK_FRAMES])
            finals = [st_eng.close_session(s) for s in sids]
            counts = read_counts()
            ticks = st_eng.stats.batches
        finally:
            st_eng.close()
        check(finals == tk[:len(utts)],
              f"{family}: streaming sessions differ from offline greedy")
        check(counts["lstm_fwd"] == c.enc_layers * ticks,
              f"{family} streaming: {counts['lstm_fwd']} K4-fwd in "
              f"{ticks} ticks")
        row["sessions"] = {"ticks": ticks, "launches": counts["lstm_fwd"],
                           "tokens": [len(x) for x in finals]}
        print("dur_decode " + json.dumps(row))
        out[family] = row
    return out


def dur_cell(family: str, seed: int, dev, profile_dir,
             ctc_weight: float = 0.0) -> dict:
    """(b) bf16 steps of the family at (32, 400, 40), with ctc_weight:
    ms a step by slope, peak GB, DUR_STEP's launches a step, and a
    profiled step: its kernels, the `joint_loss` span's share of the
    step and the lattice walks' (`duration_lattice` in the forward,
    `duration_lattice_backward` in the backward)."""
    what = family + ("_ctc" if ctc_weight else "")
    cfg = dur_cfg(family, ctc_head=bool(ctc_weight))
    tcfg = TrainConfig(batch_size=TRAIN_B, warmup_steps=100,
                       total_steps=10000, ctc_weight=ctc_weight)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev)
    step = tl.make_train_step(cfg, tcfg, device=dev)
    batch = bench_batch(cfg, seed, dev, TRAIN_U, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, res = timed_steps(step, state, batch, TRAIN_B)
    check_step_counts(res, DUR_STEP, f"phase 5j's {what} steps")
    state, prof = profile_step(step, state, batch, profile_dir,
                               f"dur_{what}_step", windows=1)
    host, wall = prof["host_span_ms"], prof["wall_ms"]
    lat_ms = (host.get("duration_lattice", 0.0)
              + host.get("duration_lattice_backward", 0.0))
    res.update({"what": what, "B": TRAIN_B, "T": TRAIN_T, "U": TRAIN_U,
                "dtype": "bfloat16", "ctc_weight": ctc_weight,
                "launches_per_step": {k: v / res["steps"] for k, v in
                                      res["launches"].items() if v},
                "profile": {
                    "wall_ms": wall,
                    "device_busy_share": prof["device_busy_share"],
                    "kernels": sum(prof["device_launches"].values()),
                    "host_span_ms": host,
                    "device_span_ms": prof["device_span_ms"],
                    "joint_loss_share": host.get("joint_loss", 0.0) / wall,
                    "lattice_host_ms": lat_ms, "lattice_share": lat_ms / wall,
                    "lattice_fwd_share_of_joint_loss":
                        host.get("duration_lattice", 0.0)
                        / max(host.get("joint_loss", 0.0), 1e-9),
                    "top_device_ops": prof["top_device_ops"][:5]},
                "card": card_line()})
    print("dur_bf16 " + json.dumps(res))
    del state, step
    torch.cuda.empty_cache()
    return res


def ckpt_serve_cli(ckpt_dir: str, utts: list, extra=(),
                   what: str = "dur") -> dict:
    """serve.py --ckpt-dir (and `extra`) in a process of its own: the
    model config (durations, experts) from its meta.json; MAX_BATCH
    /recognize requests and DUR_SESSIONS /session streams of 32-frame
    chunks at once; /stats; SIGTERM drains it and exits 0."""
    with serve_process(["--ckpt-dir", ckpt_dir, "--port", "0",
                        *extra]) as srv:
        url = srv["url"]
        with concurrent.futures.ThreadPoolExecutor(
                len(utts) + DUR_SESSIONS) as ex:
            recs = [ex.submit(post, url + "/recognize",
                              {"feats": u.tolist()}) for u in utts]
            sids = [post(url + "/session", {})[1]["sid"]
                    for _ in range(DUR_SESSIONS)]
            sess = [ex.submit(session_over_http, url, s, u, CHUNK_FRAMES)
                    for s, u in zip(sids, utts)]
            answers = [f.result() for f in recs]
            sessions = [f.result() for f in sess]
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    row = {"argv": srv["argv"], "start_s": srv["start_s"],
           "codes": [a[0] for a in answers], "rc": srv["rc"],
           "tokens": [len(a[1]["tokens"]) for a in answers],
           "session_tokens": [len(s["final"]) for s in sessions],
           "sessions_equal_recognize": sum(
               s["final"] == a[1]["tokens"]
               for s, a in zip(sessions, answers)),
           "offline": stats.get("offline"),
           "streaming": stats.get("streaming"), "drained": srv["drained"]}
    print(f"{what}_serve_cli " + json.dumps(row))
    check(all(c == 200 for c in row["codes"]) and row["rc"] == 0
          and row["drained"]
          and stats.get("streaming", {}).get("requests", 0) >= DUR_SESSIONS,
          f"serve CLI --ckpt-dir {ckpt_dir}: {row}, log {srv['lines'][-5:]}")
    return row


def dur_cli_train(family: str, seed: int, tmp: str, dev) -> dict:
    """(c) The training CLI for 2 steps with the family's flag into a
    checkpoint directory (5 K4 each way a step); the config it records."""
    flag = ("--big-blanks", "2,4,8") if family == "multiblank" else (
        "--tdt-durations", "0,1,2,4")
    d = os.path.join(tmp, f"dur_{family}")
    reset_counts()
    last = cli_json(["--config", "libri100", *flag, "--steps", "2",
                     "--batch-size", "8", "--max-frames", "200",
                     "--max-labels", "20", "--warmup-steps", "1",
                     "--log-every", "1", "--eval-every", "0",
                     "--ckpt-dir", d, "--seed", str(seed),
                     "--device", dev.type], 2, f"dur_{family}")
    counts = read_counts()
    cfg = ckpt.load_model_config(d)
    check(cfg == dur_cfg(family), f"the {family} checkpoint's config: {cfg}")
    check_step_counts({"launches": counts, "steps": 2}, DUR_STEP,
                      f"the {family} training CLI")
    return {"dir": d, "last": last,
            "launches": {k: v for k, v in counts.items() if v}}


def ckpt_cli_decode(what: str, cfg, d: str, dev) -> dict:
    """(c) The decode CLI on the checkpoint, greedy and beam 4: 8
    utterances, a finite WER, 4 K4-fwd an encode (a warm-up and the
    batch)."""
    from rnn_transducer_tpu_torch.recognize import main as recognize_cli

    rows = {}
    for mode in ("greedy", "beam"):
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = recognize_cli(["--ckpt-dir", d, "--mode", mode,
                                 "--batch-size", "8", "--batches", "1",
                                 "--beam", "4", "--device", dev.type])
        counts = read_counts()
        others = {k: v for k, v in counts.items() if v and k != "lstm_fwd"}
        row = {"what": what, "mode": mode, "out": got,
               "lstm_fwd": counts["lstm_fwd"], "other_launches": others}
        print("cli_decode " + json.dumps(row))
        check(got["n"] == 8 and np.isfinite(got["wer"]) and not others
              and counts["lstm_fwd"] == 2 * cfg.enc_layers,
              f"the decode CLI --mode {mode} on {what}: {row}")
        rows[mode] = row
    return rows


def lockstep_iterations(jm_: dict, dev) -> dict:
    """(c) The served batch (bucket 400, bf16) through the lock-step
    greedy loop of the standard model and of its two duration twins on
    the same encoder output: iterations, frames, tokens and jumps."""
    feats, lens = served_batch(jm_["setup"], dev, DUR_BUCKET)
    cfg0, p0 = jm_["models"]["standard"]
    with torch.inference_mode():
        enc, el = m.encode(p0, cfg0, feats, lens)
        row = {}
        for name, (cfg, p) in jm_["models"].items():
            rec = StepRecorder(p, cfg)
            t0 = time.perf_counter()
            greedy_decode(p, cfg, enc, el, MAX_SYMBOLS, decode_weights=rec)
            torch.cuda.synchronize()
            row[name] = {**replay_steps(rec, cfg, el, MAX_SYMBOLS),
                         "host_ms": (time.perf_counter() - t0) * 1e3}
    row["iterations_vs_standard"] = {
        k: row[k]["iterations"] / row["standard"]["iterations"]
        for k in DUR_FAMILIES}
    row["card"] = card_line()
    print("dur_lockstep " + json.dumps(row))
    return row


def duration_phase(seed: int, dev, profile_dir, tmp: str) -> dict:
    """Phase 5j: the duration families, (a)-(c) above. The CLI
    checkpoints come first, so that their two servers (processes of
    their own) run while the f32 gates and the decode CLI do; the timed
    bf16 cells run with no server alive. Each part's seconds on a line,
    and `dur_launches` for the kernels line."""
    out, seconds = {}, {}
    with part(seconds, "cli_train"):
        out["train_cli"] = {f: dur_cli_train(f, seed, tmp, dev)
                            for f in DUR_FAMILIES}
    with part(seconds, "models"):
        jm_ = jump_models(seed + 110, dev)
    utts = jm_["setup"]["utts"][:MAX_BATCH]
    with concurrent.futures.ThreadPoolExecutor(len(DUR_FAMILIES)) as ex:
        servers = {f: ex.submit(ckpt_serve_cli, out["train_cli"][f]["dir"],
                                utts) for f in DUR_FAMILIES}
        with part(seconds, "f32_gates"):
            out["f32"] = {f: dur_f32_gate(f, seed + 111, dev)
                          for f in DUR_FAMILIES}
        with part(seconds, "decode_gates"):
            out["decode"] = dur_decode_gates(jm_, dev)
        with part(seconds, "cli_decode"):
            out["decode_cli"] = {f: ckpt_cli_decode(
                f, dur_cfg(f), out["train_cli"][f]["dir"], dev)
                for f in DUR_FAMILIES}
        with part(seconds, "serve_cli_wait"):
            out["serve_cli"] = {f: s.result() for f, s in servers.items()}
    torch.cuda.empty_cache()
    with part(seconds, "cells"):
        out["cells"] = {}
        for i, family in enumerate(DUR_FAMILIES):
            for ctc_weight in (0.0, CTC_WEIGHT):
                res = dur_cell(family, seed + 112 + i, dev, profile_dir,
                               ctc_weight)
                out["cells"][res["what"]] = res
    with part(seconds, "lockstep"):
        out["lockstep"] = lockstep_iterations(jm_, dev)
    print("dur_seconds " + json.dumps(seconds))
    launches = dict.fromkeys(NO_LAUNCH, 0)
    for cell in out["cells"].values():
        for k, v in cell["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for row in out["decode"].values():
        launches["lstm_fwd"] += row["sessions"]["launches"]
    out["launches"] = launches
    print("dur_launches " + json.dumps(launches))
    return out


# ------------------------------ phase 5k ---------------------------------

# libri100 with an 8-expert MoE joint of expert hidden 1024 (the shape of
# docs/PERFORMANCE.md:172-181), capacity factor 1.25, aux weight 0.01.
MOE_KW = dict(joint_experts=8, joint_expert_hidden=1024,
              moe_capacity_factor=1.25, moe_aux_weight=0.01)
MOE_F32_B = 4  # the f32 gates' batch (rows of bench_batch, ragged)
# The two-rank f32 gates run at a capacity factor of E: per-rank capacity
# (JAX's ep semantics) then drops no token, as the one process drops none.
MOE_AMPLE_CF = 8.0
MOE_RANKS = 2  # a 1x2 (data, model) mesh on gloo, the ranks sharing a card
MOE_MP_STEPS = 3  # bf16 steps of each mode on the ranks; the first untimed
MOE_CONF_B = 8  # the conformer's ep step (K8 under ep): rows of bench_batch
MOE_BUCKET = 400  # the served utterances: 150-400 frames
# A bf16 step of the one-process MoE model: the encoder's 4 layers and the
# predictor through K4 each way, K3's alpha and beta once (the xla route
# over the routed joint's logits); no K1, K2 or K5.
MOE_STEP = {**NO_LAUNCH, "lstm_fwd_with_acts": 5, "lstm_bwd": 5,
            "lattice_alpha": 1, "lattice_beta": 1}
# The two-rank steps against one process: test_moe.py's bounds (:224-232).
LOSS_RTOL_MP, PARAM_ATOL_MP = 2e-5, 2e-5
# the f32 gate's step must move the params: no warm-up (lr > 0 at step 0)
MOE_MOVED_MIN = 1e-4


def moe_cfg(**kw):
    return dataclasses.replace(config_libri100(), **{**MOE_KW, **kw})


def moe_f32_gates(seed: int, dev) -> dict:
    """(a) The MoE model's f32 loss and gradients on the card against the
    CPU at MOE_F32_B ragged rows of bench.py's batch: the routes of every
    lattice token equal (the count that differs, 0), the loss within
    LOSS_RTOL, every gradient leaf within GRAD_RTOL of its largest value,
    on `auto` (the xla route: K3) and `pallas` (K5 and K3) against the
    CPU's one loss; each route's launches. Then the dense decode step
    (`DecodeWeights.joint` on every expert) at B=8 positions, card
    against CPU, within ATOL."""
    cfg = moe_cfg(compute_dtype="float32")
    params = m.init_params(cfg, np.random.default_rng(seed), dev)
    batch = bench_batch(cfg, seed, dev, TRAIN_U, MOE_F32_B, ragged=True)

    def routes(p, b):
        with torch.no_grad():
            enc, _ = m.encode(p, cfg, *b[:2])
            pred, _ = m.predict(p, cfg, b[2])
            f, g, _, _ = m.joint_activations(p, cfg, enc, pred)
            z = torch.tanh(f[:, :, None] + g[:, None])
            return moe.router_top1(p["moe"], z.reshape(-1, z.shape[-1])
                                   )[1].cpu()

    def run(p, b, impl):
        flat, spec = torch.utils._pytree.tree_flatten(p)
        xs = [x.detach().requires_grad_(True) for x in flat]
        reset_counts()
        loss, _ = tl.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec),
                             cfg, *b, loss_impl=impl)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        if loss.is_cuda:
            torch.cuda.synchronize()
        return (float(loss.detach()), [torch.zeros_like(x) if g is None
                                       else g for x, g in zip(xs, grads)],
                read_counts())

    cpu_params = torch.utils._pytree.tree_map(lambda x: x.cpu(), params)
    cpu_batch = tuple(a.cpu() for a in batch)
    t0 = time.perf_counter()
    lp, gp, _ = run(cpu_params, cpu_batch, "auto")
    cpu_s = time.perf_counter() - t0
    diff = int((routes(params, batch) != routes(cpu_params, cpu_batch)).sum())
    row = {"B": MOE_F32_B, "T": TRAIN_T, "U": TRAIN_U, **MOE_KW,
           "tokens": MOE_F32_B * TRAIN_T // 2 * (TRAIN_U + 1),
           "routes_differing": diff, "loss_cpu": lp, "cpu_s": cpu_s,
           "loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL}
    check(diff == 0, f"MoE f32: {diff} tokens routed differently on the card")
    want = {"auto": {**MOE_STEP}, "pallas": {**MOE_STEP, "extract_lp": 1,
                                              "assemble_grad": 1}}
    launches = dict.fromkeys(NO_LAUNCH, 0)
    for impl in ("auto", "pallas"):
        lk, gk, ck = run(params, batch, impl)
        r = {"loss_card": lk, "loss_rel_err": abs(lk - lp) / abs(lp),
             "grad_worst_rel_err": max(rel_err(a.cpu(), b)
                                       for a, b in zip(gk, gp)),
             "launches": {k: v for k, v in ck.items() if v}}
        row[impl] = r
        check(r["loss_rel_err"] <= LOSS_RTOL,
              f"MoE f32 {impl}: loss card {lk} vs CPU {lp}")
        check(r["grad_worst_rel_err"] <= GRAD_RTOL,
              f"MoE f32 {impl}: gradients {r['grad_worst_rel_err']}")
        check(all(ck[k] == v for k, v in want[impl].items()),
              f"MoE f32 {impl}: launches {ck}, not {want[impl]}")
        for k, v in ck.items():
            launches[k] = launches.get(k, 0) + v
    rng = np.random.default_rng(seed + 1)
    enc_t = torch.from_numpy(rng.normal(size=(8, cfg.enc_out_dim))).float()
    pred_u = torch.from_numpy(rng.normal(size=(8, cfg.pred_hidden))).float()
    outs = []
    for p, d in ((params, dev), (cpu_params, "cpu")):
        dw = m.DecodeWeights(p, cfg)
        with torch.no_grad():
            outs.append(dw.joint(dw.enc_proj(enc_t.to(d)),
                                 dw.pred_proj(pred_u.to(d))).cpu())
    row["decode_step_max_abs_err"] = float((outs[0] - outs[1]).abs().max())
    check(row["decode_step_max_abs_err"] <= ATOL[torch.float32],
          f"MoE dense decode step: card vs CPU {row}")
    row["launches"] = launches
    print("moe_f32 " + json.dumps(row))
    return row


def step_errs(params, mu, want, want_mu) -> dict:
    """The errors of one optimizer step against another from the same
    params. Adam's first moment after one step is 0.1 times the (clipped)
    gradient, so mu holds the gradient: each leaf's largest error over its
    largest value (`grad_worst_rel_err`). The params after Adam's first
    step moved by lr * g / (|g| + eps), about +-lr whatever the size of
    g, so where the gradient is at the level of its rounding, a sign that
    differs puts two params 2 lr apart: the params are held where the
    gradient exceeds GRAD_RTOL of its leaf's largest
    (`param_max_abs_err_above_noise`); `param_max_abs_err` is over all of
    them, and `params_at_noise` counts the rest."""
    g_err, p_err, p_all, n_noise = 0.0, 0.0, 0.0, 0
    for p, g, wp, wg in zip(leaves(params), leaves(mu), leaves(want),
                            leaves(want_mu)):
        g, wg = g.float(), wg.float()
        top = float(wg.abs().max())
        g_err = max(g_err, float((g - wg).abs().max()) / max(top, 1e-30))
        d = (p.float() - wp.float()).abs()
        above = wg.abs() > GRAD_RTOL * top
        p_all = max(p_all, float(d.max()))
        if bool(above.any()):
            p_err = max(p_err, float(d[above].max()))
        n_noise += int((~above).sum())
    return {"grad_worst_rel_err": g_err, "param_max_abs_err_above_noise":
            p_err, "param_max_abs_err": p_all, "params_at_noise": n_noise}


def moe_f32_tcfg() -> TrainConfig:
    """The f32 gate's one step: no warm-up, so that it moves the params,
    and no clip, so that the ranks' gradient norm is held on its own."""
    return TrainConfig(batch_size=MOE_F32_B, warmup_steps=0,
                       total_steps=100, grad_clip_norm=1e9)


def moe_rank(mesh, seed: int) -> dict:
    """One rank of phase 5k's 1x2 mesh (`parallel/tp.py`). (a) f32 at
    MOE_AMPLE_CF: one sp step and one ep step of the MoE model on the
    rank's batch, the plain params after it (ep's experts gathered). (b)
    bf16 at (32, 400, 40): MOE_MP_STEPS ep and sp steps, ms a step and
    the host ms of the exchanges and gathers (`COLLECTIVE_STATS`) a step;
    one ep step of libri100_conformer with the same experts (K8 under
    ep). Rank 0's launches over each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {"rank": mesh.rank, "backend": mesh.backend}
    c32 = moe_cfg(compute_dtype="float32", moe_capacity_factor=MOE_AMPLE_CF)
    tcfg = moe_f32_tcfg()
    batch = shard_batch_2d(mesh, bench_batch(c32, seed, "cpu", TRAIN_U,
                                             MOE_F32_B, ragged=True))
    for mode in ("sp", "ep"):
        params = m.init_params(c32, np.random.default_rng(seed + 2), dev)
        state = (tpx.init_ep_train_state(None, c32, tcfg, mesh.n_model,
                                         mesh.model_rank, dev, params=params)
                 if mode == "ep" else
                 tpx.init_sp_train_state(None, c32, tcfg, dev, params=params))
        state, info = tpx.make_tp_train_step(c32, tcfg, mesh, mode)(state,
                                                                   *batch)
        out[f"f32_{mode}"] = (
            float(info["loss"]), float(info["grad_norm"]),
            tpx.plain_params(mesh, state.params, mode, c32),
            tpx.plain_params(mesh, state.opt_state["mu"], mode, c32))
        del params, state
    torch.cuda.empty_cache()
    cfg = moe_cfg()
    tcfg = TrainConfig(batch_size=TRAIN_B, warmup_steps=100,
                       total_steps=10000)
    batch = shard_batch_2d(mesh, bench_batch(cfg, seed, "cpu", TRAIN_U,
                                             TRAIN_B))
    for mode in ("ep", "sp"):
        state = (tpx.init_ep_train_state(np.random.default_rng(seed), cfg,
                                         tcfg, mesh.n_model, mesh.model_rank,
                                         dev) if mode == "ep" else
                 tpx.init_sp_train_state(np.random.default_rng(seed), cfg,
                                         tcfg, dev))
        step = tpx.make_tp_train_step(cfg, tcfg, mesh, mode)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rows = []
        for i in range(MOE_MP_STEPS):
            meshlib.COLLECTIVE_STATS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, info = step(state, *batch)
            torch.cuda.synchronize()
            rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": float(info["loss"]),
                         "skipped": int(info["skipped_nonfinite"]),
                         "collectives": {k: dict(v) for k, v in
                                         meshlib.COLLECTIVE_STATS.items()}})
        out[f"bf16_{mode}"] = {"steps": rows, "launches": read_counts(),
                               "peak_mem_gb":
                                   torch.cuda.max_memory_allocated() / 1e9}
        del state, step
        torch.cuda.empty_cache()
    conf = dataclasses.replace(config_libri100_conformer(), **MOE_KW)
    tcfg = TrainConfig(batch_size=MOE_CONF_B, warmup_steps=100,
                       total_steps=10000)
    state = tpx.init_ep_train_state(np.random.default_rng(seed), conf, tcfg,
                                    mesh.n_model, mesh.model_rank, dev)
    reset_counts()
    state, info = tpx.make_tp_train_step(conf, tcfg, mesh, "ep")(
        state, *shard_batch_2d(mesh, bench_batch(conf, seed, "cpu", TRAIN_U,
                                                 MOE_CONF_B)))
    torch.cuda.synchronize()
    out["bf16_conformer_ep"] = {"loss": float(info["loss"]),
                                "skipped": int(info["skipped_nonfinite"]),
                                "launches": read_counts()}
    return out


def moe_ranks(seed: int, dev, one_process_ms: float) -> dict:
    """(a) and (b) on MOE_RANKS gloo ranks sharing the card: the f32 sp
    and ep steps against one process's step on the card (LOSS_RTOL_MP,
    PARAM_ATOL_MP), and the bf16 rows."""
    c32 = moe_cfg(compute_dtype="float32", moe_capacity_factor=MOE_AMPLE_CF)
    tcfg = moe_f32_tcfg()
    init = m.init_params(c32, np.random.default_rng(seed + 2), dev)
    state = tl.init_train_state(None, c32, tcfg, params=init)
    state, info = tl.make_train_step(c32, tcfg)(state, *bench_batch(
        c32, seed, dev, TRAIN_U, MOE_F32_B, ragged=True))
    want_loss, want = float(info["loss"]), state.params
    want_norm, want_mu = float(info["grad_norm"]), state.opt_state["mu"]
    moved = max(float((a - b).abs().max()) for a, b in zip(leaves(want),
                                                           leaves(init)))
    check(moved > MOE_MOVED_MIN, f"the one-process f32 MoE step moved the "
          f"params by {moved}")
    del state, init
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = meshlib.spawn(moe_rank, MOE_RANKS, [str(dev)] * MOE_RANKS,
                        args=(seed,), timeout_s=DP_TIMEOUT_S,
                        n_model=MOE_RANKS)
    row = {"ranks": MOE_RANKS, "mesh": f"1x{MOE_RANKS}",
           "backend": got["backend"], "wall_s": time.perf_counter() - t0}
    for mode in ("sp", "ep"):
        loss, norm, params, mu = got.pop(f"f32_{mode}")
        row[f"f32_{mode}"] = {"loss": loss, "loss_one_process": want_loss,
                              "loss_rel_err": abs(loss - want_loss)
                              / abs(want_loss),
                              "grad_norm": norm,
                              "grad_norm_one_process": want_norm,
                              "grad_norm_rel_err": abs(norm - want_norm)
                              / abs(want_norm),
                              **step_errs(params, mu, want, want_mu),
                              "one_process_param_max_change": moved}
        r = row[f"f32_{mode}"]
        check(r["loss_rel_err"] <= LOSS_RTOL_MP
              and r["grad_norm_rel_err"] <= LOSS_RTOL_MP
              and r["grad_worst_rel_err"] <= GRAD_RTOL
              and r["param_max_abs_err_above_noise"] <= PARAM_ATOL_MP,
              f"MoE {mode} on {MOE_RANKS} ranks against one process: "
              f"{row[f'f32_{mode}']}")
    for mode in ("ep", "sp"):
        r = got[f"bf16_{mode}"]
        timed = r["steps"][1:]
        ex = [sum(v["ms"] for v in s["collectives"].values()) for s in timed]
        row[f"bf16_{mode}"] = {
            "ms_per_step": statistics.mean(s["ms"] for s in timed),
            "step_ms": [s["ms"] for s in r["steps"]],
            "one_process_ms_per_step": one_process_ms,
            "collective_host_ms_per_step": statistics.mean(ex),
            "collectives": timed[-1]["collectives"],
            "losses": [s["loss"] for s in r["steps"]],
            "peak_mem_gb_rank0": r["peak_mem_gb"],
            "launches_rank0": {k: v for k, v in r["launches"].items() if v}}
        check(all(s["skipped"] == 0 and np.isfinite(s["loss"])
                  for s in r["steps"]),
              f"a bf16 {mode} step was skipped or non-finite")
        check_step_counts({"launches": r["launches"],
                           "steps": MOE_MP_STEPS}, MOE_STEP,
                          f"rank 0's bf16 {mode} steps")
    ce = got["bf16_conformer_ep"]
    row["bf16_conformer_ep"] = {**ce, "launches": {
        k: v for k, v in ce["launches"].items() if v}}
    check(ce["skipped"] == 0 and np.isfinite(ce["loss"])
          and ce["launches"]["fused_ln_fwd"] == LN_PER_ENCODE
          and ce["launches"]["fused_ln_bwd"] == LN_PER_ENCODE,
          f"the conformer's ep step: {row['bf16_conformer_ep']}")
    row["card"] = card_line()
    print("moe_ranks " + json.dumps(row))
    launches = dict.fromkeys(NO_LAUNCH, 0)
    for r in (got["bf16_ep"], got["bf16_sp"], ce):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    row["launches"] = launches
    return row


def moe_cell(seed: int, dev, profile_dir) -> dict:
    """(b) bf16 steps of the one-process MoE model at (32, 400, 40) (the
    xla route over the routed joint's logits): ms a step by slope, peak
    GB, MOE_STEP's launches a step, and a profiled step: the MoE spans'
    host ms and the device time inside them, each as a share of the
    step."""
    cfg = moe_cfg()
    tcfg = TrainConfig(batch_size=TRAIN_B, warmup_steps=100,
                       total_steps=10000)
    state = tl.init_train_state(np.random.default_rng(seed), cfg, tcfg, dev)
    step = tl.make_train_step(cfg, tcfg, device=dev)
    batch = bench_batch(cfg, seed, dev, TRAIN_U, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, res = timed_steps(step, state, batch, TRAIN_B)
    check_step_counts(res, MOE_STEP, "phase 5k's MoE steps")
    state, prof = profile_step(step, state, batch, profile_dir,
                               "moe_step", windows=1)
    host, wall = prof["host_span_ms"], prof["wall_ms"]
    res.update({"B": TRAIN_B, "T": TRAIN_T, "U": TRAIN_U, **MOE_KW,
                "dtype": "bfloat16",
                "tokens": TRAIN_B * TRAIN_T // 2 * (TRAIN_U + 1),
                "capacity": moe.capacity(TRAIN_B * TRAIN_T // 2
                                         * (TRAIN_U + 1), 8, 1.25),
                "launches_per_step": {k: v / res["steps"] for k, v in
                                      res["launches"].items() if v},
                "profile": {
                    "wall_ms": wall,
                    "device_busy_share": prof["device_busy_share"],
                    "host_span_ms": host,
                    "device_span_ms": prof["device_span_ms"],
                    "moe_span_share": {k: host.get(k, 0.0) / wall
                                       for k in moe.SPANS},
                    "moe_device_span_share": {
                        k: prof["device_span_ms"].get(k, 0.0) / wall
                        for k in moe.SPANS},
                    "device_ms": prof["device_ms"],
                    "top_device_ops": prof["top_device_ops"][:6]},
                "card": card_line()})
    print("moe_bf16 " + json.dumps(res))
    del state, step
    torch.cuda.empty_cache()
    return res


def moe_cli(seed: int, tmp: str, dev) -> dict:
    """(c) The training CLI on the MoE config (a JSON file): 2 steps with
    --model-parallel 2 --parallel-mode ep into a checkpoint (rank 0's
    launches: MOE_STEP's a step), one more on --resume, and a resume under
    another topology refused."""
    path = os.path.join(tmp, "moe_libri100.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(moe_cfg()), f)
    d = os.path.join(tmp, "moe_ep")
    common = ["--config", path, "--model-parallel", str(MOE_RANKS),
              "--parallel-mode", "ep", "--batch-size", "8",
              "--max-frames", "200", "--max-labels", "20",
              "--warmup-steps", "1", "--log-every", "1", "--eval-every", "0",
              "--ckpt-dir", d, "--seed", str(seed), "--device", dev.type]
    reset_counts()
    first = cli_json(common + ["--steps", "2"], 2, "moe_ep")
    resumed = cli_json(common + ["--steps", "3", "--resume"], 3,
                       "moe_ep_resume")
    counts = read_counts()
    check_step_counts({"launches": counts, "steps": 3}, MOE_STEP,
                      "the ep training CLI (rank 0)")
    meta = ckpt.load_meta(d)
    check(meta.get("parallel") == {"mode": "ep", "mp": MOE_RANKS}
          and ckpt.load_model_config(d) == moe_cfg(),
          f"the ep checkpoint's meta.json: {meta.get('parallel')}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli([*common[:5], "sp", *common[6:], "--steps", "4",
                       "--resume"])
        refused = None
    except SystemExit as e:
        refused = str(e)
    check(refused is not None and "topology" in refused,
          f"a resume under another topology: {refused}")
    return {"dir": d, "first": first, "resumed": resumed,
            "refused": refused,
            "launches": {k: v for k, v in counts.items() if v}}


def moe_phase(seed: int, dev, profile_dir, tmp: str) -> dict:
    """Phase 5k: the MoE joint with the sp and ep modes, (a)-(c) above.
    The CLI's checkpoint comes first, so that its two serve.py processes
    (float and --quantize int8) answer while the f32 gates, the decode
    CLI and the served emitting model run; the timed bf16 cells run with
    no server alive. Each part's seconds on a line, and `moe_launches`
    for the kernels line."""
    out, seconds = {}, {}
    with part(seconds, "cli_train"):
        out["cli"] = moe_cli(seed, tmp, dev)
    d = out["cli"]["dir"]
    with part(seconds, "serving_setup"):
        serving = emitting_setup(seed + 120, MAX_BATCH, dev, moe_cfg(),
                                 (150, MOE_BUCKET), "moe")
    utts = serving["utts"]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        servers = {what: ex.submit(ckpt_serve_cli, d, utts, extra, "moe")
                   for what, extra in (("float", ()),
                                       ("int8", ("--quantize", "int8")))}
        with part(seconds, "f32_gates"):
            out["f32"] = moe_f32_gates(seed + 121, dev)
        with part(seconds, "cli_decode"):
            out["decode_cli"] = ckpt_cli_decode("moe", moe_cfg(), d, dev)
        with part(seconds, "served"):
            out["served"], _ = config_serving(
                moe_cfg(), seed + 120, MAX_BATCH, dev, (150, MOE_BUCKET),
                MOE_BUCKET, True, "moe", serving=serving)
        with part(seconds, "serve_cli_wait"):
            out["serve_cli"] = {w: s.result() for w, s in servers.items()}
    torch.cuda.empty_cache()
    with part(seconds, "cell"):
        out["cell"] = moe_cell(seed + 122, dev, profile_dir)
    with part(seconds, "ranks"):
        out["ranks"] = moe_ranks(seed + 123, dev, out["cell"]["ms_per_step"])
    print("moe_seconds " + json.dumps(seconds))
    launches = dict.fromkeys(NO_LAUNCH, 0)
    for counts in (out["cell"]["launches"], out["f32"]["launches"],
                   out["ranks"]["launches"]):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for name, row in out["served"].items():
        launches[row["kernel"]] += row["launches"]
    out["launches"] = launches
    print("moe_launches " + json.dumps(launches))
    return out


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bnd: dict, library_ms=None, kernel=None,
                 device_ms=None) -> dict:
    entry = {"name": name, "route": "cuda",
             "source": f"rnn_transducer_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
             "bound_by": bnd["bound_by"], "library_ms": library_ms}
    if kernel:  # the device kernel's name, where it differs from `name`
        entry["kernel"] = kernel
    if device_ms is not None:  # the device's ms, where `ms` is a call's
        entry["device_ms"] = device_ms
    return entry


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--profile-dir", default=None,
                   help="write the training step's torch.profiler trace "
                        "and table here")
    p.add_argument("--only", default=None, choices=["moe"],
                   help="phases 1-2, then this phase alone (moe: 5k), and "
                        "no kernels line")
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
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"build: {line.strip()}")
    if args.only == "moe":
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            moe_phase(args.seed, dev, args.profile_dir, tmp)
        print(f"phase moe: {time.perf_counter() - t0:.1f} s")
        print(card_line())
        print(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    # phase 3: each kernel against its plain version
    t0 = time.perf_counter()
    k = kernel_vs_plain(np.random.default_rng(args.seed + 1), dev)
    kt = lstm_train_vs_plain(np.random.default_rng(args.seed + 3), dev)
    k960 = lstm_train_vs_plain(np.random.default_rng(args.seed + 10), dev,
                               1024, L960_LSTM_CASES, None)
    kj = joint_vs_plain(np.random.default_rng(args.seed + 4), dev)
    kl = lattice_vs_plain(np.random.default_rng(args.seed + 5), dev)
    kr = loss_rows_vs_plain(np.random.default_rng(args.seed + 6), dev)
    kq = lstm_int8_vs_plain(np.random.default_rng(args.seed + 7), dev)
    serving = serving_setup(args.seed, args.requests, dev)
    kg = greedy_fused_vs_plain(serving, dev)
    kln = fused_ln_vs_plain(np.random.default_rng(args.seed + 8), dev)
    kb = band_fused_vs_plain(np.random.default_rng(args.seed + 9), dev)
    print(f"phase kernel: {time.perf_counter() - t0:.1f} s")

    # phase 4: serving end to end, float and int8, and the fused decoder
    t0 = time.perf_counter()
    e2e = end_to_end(serving, dev)
    print(f"phase e2e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e2e_q = int8_serving(serving, dev)
    print(f"phase e2e_int8: {time.perf_counter() - t0:.1f} s")
    qparams = e2e_q.pop("qparams")
    t0 = time.perf_counter()
    fused = fused_greedy(serving, qparams, dev)
    print(f"phase fused: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    conf = conformer_serving_setup(serving, args.seed, dev)
    e2e_c = conformer_end_to_end(conf, dev)
    print(f"phase e2e_conformer: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    utt = serving["utts"][0]
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(4) as ex:
        # the beam entry point: libri100, --mode beam with a trigram
        from rnn_transducer_tpu_torch.models.ngram import save_ngram
        save_ngram(serve_trigram(serving["cfg"], args.seed),
                   os.path.join(tmp, "lm3"))
        # the four servers at once, each a process of its own on the card;
        # libri100 at the CLI's defaults answers a /session too
        futs = [ex.submit(serve_cli, extra, utt, **kw) for extra, kw in (
            ([], {}), (["--quantize", "int8"], {}),
            ([], {"config": "libri100"}),
            (["--mode", "beam", "--ngram", os.path.join(tmp, "lm3")],
             {"config": "libri100"}))]
        for f in futs:
            f.result()
    print(f"phase serve_cli: {time.perf_counter() - t0:.1f} s")
    del conf
    torch.cuda.empty_cache()

    # phase 5: training
    t0 = time.perf_counter()
    train = train_phase(args.seed, dev, args.profile_dir)
    print(f"phase train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pallas = train_pallas_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_pallas: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    conf_train = train_conformer_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_conformer: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pruned = train_pruned_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_pruned: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_ar_phase(args.seed, dev, args.profile_dir)
    print(f"phase train_ar: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phase 5f: configs[1] (TIMIT) and configs[4] (libri960, two ranks)
    t0 = time.perf_counter()
    configs_phase(args.seed, dev, args.profile_dir, args.requests)
    print(f"phase configs: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phase 5g: configs[2] on manifest data (its profiled step before 4f);
    # phase 5h: the training recipes on its corpus
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        manifest = manifest_phase(args.seed, dev, args.profile_dir, tmp)
        print(f"phase manifest: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        recipes_phase(args.seed, dev, manifest["corpus"], tmp,
                      {str(T): ms for T, (_, ms)
                       in manifest["batches"].items()})
        print(f"phase recipes: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # phase 5i: CTC, the stateless predictor and encoder remat
        t0 = time.perf_counter()
        ctc = ctc_phase(args.seed, dev, args.profile_dir, tmp)
        print(f"phase ctc: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # phase 5j: the duration families (multi-blank and TDT)
        t0 = time.perf_counter()
        dur = duration_phase(args.seed, dev, args.profile_dir, tmp)
        print(f"phase duration: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # phase 5k: the MoE joint with the sp and ep modes
        t0 = time.perf_counter()
        mo = moe_phase(args.seed, dev, args.profile_dir, tmp)
        print(f"phase moe: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    # phase 4f: beam serving (its profiled windows after the training
    # phases' kernel-name checks); then 4g, after every profiled window
    t0 = time.perf_counter()
    beam_serving(beam_serving_setup(serving, args.seed, dev), dev)
    print(f"phase beam: {time.perf_counter() - t0:.1f} s")
    del qparams
    t0 = time.perf_counter()
    lattice_tiles_vs_plain(np.random.default_rng(args.seed + 22), dev)
    print(f"phase lattice_tiles: {time.perf_counter() - t0:.1f} s")

    # phase 4h: streaming sessions (after every profiled window of the
    # earlier phases)
    t0 = time.perf_counter()
    stream = streaming_phase(serving, args.seed, dev)
    print(f"phase streaming: {time.perf_counter() - t0:.1f} s")
    # phase 4i: raw audio in, text out
    t0 = time.perf_counter()
    audio = audio_phase(serving, args.seed, dev)
    print(f"phase audio: {time.perf_counter() - t0:.1f} s")
    del serving
    print("audio_launches " + json.dumps({
        kernel: audio["bf16"][what]["audio"]["launches"]
        for what, kernel in (("float", "lstm_fwd"),
                             ("int8", "lstm_fwd_int8"))}))
    print("streaming_launches " + json.dumps({
        "lstm_fwd": stream["greedy"]["launches"]
        + stream["greedy_emitting"]["launches"] + stream["beam"]["launches"],
        "lstm_fwd_int8": stream["int8"]["launches"],
        "fused_ln_fwd": stream["conformer_chunked"]["launches"]}))

    # phase 6: results
    lp = "rnn_transducer_tpu/ops/lstm_pallas.py"
    jp = "rnn_transducer_tpu/ops/rnnt_joint_fused.py"
    wp = "rnn_transducer_tpu/ops/rnnt_lattice_pallas.py"
    rp = "rnn_transducer_tpu/ops/rnnt_loss_pallas.py"
    gp = "rnn_transducer_tpu/decode/greedy_pallas.py"
    fp = "rnn_transducer_tpu/ops/fused_ln.py"
    bp = "rnn_transducer_tpu/ops/rnnt_band_fused.py"
    counts = train["launches"]
    two_pass = pallas["launches"]
    km, tm_, jm_, lm, rm, lnm, bm = (k["main"], kt["main"], kj["main"],
                                     kl["main"], kr["main"], kln["main"],
                                     kb["main"])
    band_counts = pruned["launches"]
    cl = ctc["launches"]  # phase 5i's cells, engines: added to each count
    dl = dur["launches"]  # phase 5j's cells and sessions: K4 alone
    ml = mo["launches"]  # phase 5k's cells, gates, rank 0 and engines
    print(json.dumps({"kernels": [
        kernel_entry("lstm_fwd", "lstm_fwd.cu", f"{lp}:119",
                     e2e["launches"] + cl["lstm_fwd"] + dl["lstm_fwd"]
                     + ml["lstm_fwd"],
                     k["max_abs_err"], km["kernel_ms"], km["plain_ms"], km,
                     km["library_ms"]),
        kernel_entry("lstm_fwd_with_acts", "lstm_fwd.cu", f"{lp}:119",
                     counts["lstm_fwd_with_acts"]
                     + cl["lstm_fwd_with_acts"] + dl["lstm_fwd_with_acts"]
                     + ml["lstm_fwd_with_acts"],
                     max(kt["worst"]["fwd"], k960["worst"]["fwd"]),
                     tm_["fwd_kernel_ms"], tm_["fwd_plain_ms"],
                     tm_["fwd_bound"], tm_["cudnn_train_fwd_ms"]),
        kernel_entry("lstm_bwd", "lstm_bwd.cu", f"{lp}:222",
                     counts["lstm_bwd"] + cl["lstm_bwd"] + dl["lstm_bwd"]
                     + ml["lstm_bwd"],
                     max(kt["worst"]["bwd"], k960["worst"]["bwd"]),
                     tm_["bwd_kernel_ms"], tm_["bwd_plain_ms"],
                     tm_["bwd_bound"], tm_["cudnn_bwd_ms"]),
        kernel_entry("joint_fwd", "joint_fwd.cu", f"{jp}:132",
                     counts["joint_fwd"] + cl["joint_fwd"], kj["worst_fwd"],
                     jm_["fwd_kernel_ms"], jm_["fwd_plain_ms"],
                     jm_["fwd_bound"]),
        kernel_entry("joint_bwd", "joint_bwd.cu", f"{jp}:374",
                     counts["joint_bwd"] + cl["joint_bwd"], kj["worst_bwd"],
                     jm_["bwd_kernel_ms"], jm_["bwd_plain_ms"],
                     jm_["bwd_bound"]),
        kernel_entry("lattice_alpha", "lattice.cu", f"{wp}:65",
                     counts["lattice_alpha"] + cl["lattice_alpha"]
                     + ml["lattice_alpha"],
                     kl["worst_alpha"],
                     lm["alpha_kernel_ms"], lm["alpha_plain_ms"],
                     lm["alpha_bound"], device_ms=lm["alpha_device_ms"]),
        kernel_entry("lattice_beta", "lattice.cu", f"{wp}:65",
                     counts["lattice_beta"] + cl["lattice_beta"]
                     + ml["lattice_beta"],
                     kl["worst_beta"],
                     lm["beta_kernel_ms"], lm["beta_plain_ms"],
                     lm["beta_bound"], device_ms=lm["beta_device_ms"]),
        kernel_entry("extract_lp", "loss_rows.cu", f"{rp}:82",
                     two_pass["extract_lp"] + cl["extract_lp"]
                     + ml["extract_lp"],
                     kr["worst_extract"],
                     rm["extract_kernel_ms"], rm["extract_plain_ms"],
                     rm["extract_bound"]),
        kernel_entry("assemble_grad", "loss_rows.cu", f"{rp}:126",
                     two_pass["assemble_grad"] + cl["assemble_grad"]
                     + ml["assemble_grad"],
                     kr["worst_grad"],
                     rm["grad_kernel_ms"], rm["grad_plain_ms"],
                     rm["grad_bound"]),
        kernel_entry("lstm_fwd_int8", "lstm_fwd_q.cu", f"{lp}:532",
                     e2e_q["launches"] + cl["lstm_fwd_int8"]
                     + ml["lstm_fwd_int8"],
                     kq["max_abs_err"],
                     kq["main"]["kernel_ms"], kq["main"]["plain_ms"],
                     kq["main"], kernel="lstm_q_persistent_kernel"),
        kernel_entry("greedy_fused", "greedy_fused.cu", f"{gp}:107",
                     fused["launches"], kg["max_abs_err"],
                     kg["main"]["kernel_ms"], kg["main"]["plain_ms"],
                     kg["main"], kernel=" + ".join(K9_KERNELS)),
        kernel_entry("fused_ln_fwd", "fused_ln.cu", f"{fp}:118",
                     e2e_c["launches"] + cl["fused_ln_fwd"]
                     + ml["fused_ln_fwd"],
                     kln["worst"]["fwd"],
                     lnm["fwd_kernel_ms"], lnm["fwd_plain_ms"],
                     lnm["fwd_bound"], lnm["fwd_library_ms"]),
        kernel_entry("fused_ln_bwd", "fused_ln.cu", f"{fp}:152",
                     conf_train["launches"]["fused_ln_bwd"]
                     + cl["fused_ln_bwd"] + ml["fused_ln_bwd"],
                     kln["worst"]["bwd"],
                     lnm["bwd_kernel_ms"], lnm["bwd_plain_ms"],
                     lnm["bwd_bound"],
                     lnm["bwd_library_ms"]),
        kernel_entry("band_lp_fwd", "band_fused.cu", f"{bp}:95",
                     band_counts["band_lp_fwd"], kb["worst"]["fwd"],
                     bm["fwd_kernel_ms"], bm["fwd_plain_ms"],
                     bm["fwd_bound"]),
        kernel_entry("band_lp_bwd_a", "band_fused.cu", f"{bp}:157",
                     band_counts["band_lp_bwd_a"], kb["worst"]["bwd_a"],
                     bm["bwd_a_kernel_ms"], bm["bwd_a_plain_ms"],
                     bm["bwd_a_bound"]),
        kernel_entry("band_lp_bwd_b", "band_fused.cu", f"{bp}:238",
                     band_counts["band_lp_bwd_b"], kb["worst"]["bwd_b"],
                     bm["bwd_b_kernel_ms"], bm["bwd_b_plain_ms"],
                     bm["bwd_b_bound"]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
