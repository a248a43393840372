"""Checkpoints of the training state (port of `rnn_transducer_tpu/train/checkpoint.py`).

A checkpoint directory holds one `step_<N>.pt` per saved step, written
with `torch.save` ({"params", "opt_state", "step", "ema"}; "ema" is None
unless the run keeps a Polyak average, and a file without it loads with
ema None), and a `meta.json` beside them with the model and train configs
(and the global CMVN stats and the tokenizer when the run had them), as
the JAX package's `save_meta` writes it, so a run can be resumed or
served without naming its config again. `load_plain_params` gives the
params, or with prefer_ema the EMA, of a checkpoint to the decode CLI and
the server; a checkpoint of the expert-parallel trainer (meta.json's
"parallel" {"mode": "ep"}: its params are the stacked TPParams dict
{"rep", "shd"}) is merged into plain params first, as JAX's
`load_plain_params` merges it. The JAX package's orbax format is not
read.

A step file is written to a temporary name and renamed into place, so a
reader never sees half of one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.train.loop import TrainState

META_FILE = "meta.json"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def save_meta(ckpt_dir: str, model_cfg=None, **extra) -> None:
    """Write meta.json: the TransducerConfig (asdict) + extra metadata."""
    os.makedirs(ckpt_dir, exist_ok=True)
    meta = dict(extra)
    if model_cfg is not None:
        meta["model_config"] = dataclasses.asdict(model_cfg)
    with open(os.path.join(ckpt_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


def load_meta(ckpt_dir: str) -> dict | None:
    path = os.path.join(ckpt_dir, META_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_model_config(ckpt_dir: str) -> TransducerConfig | None:
    """The TransducerConfig saved in meta.json, or None (JAX
    `load_model_config`): JSON gives lists back for the tuple fields, which
    become tuples again so that the config compares equal to a fresh one."""
    meta = load_meta(ckpt_dir)
    if not meta or "model_config" not in meta:
        return None
    d = dict(meta["model_config"])
    for k in ("big_blank_durations", "tdt_durations"):
        if k in d:
            d[k] = tuple(d[k])
    return TransducerConfig(**d)


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def latest_step(ckpt_dir: str) -> int | None:
    """The highest saved step under ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(mt.group(1)) for name in os.listdir(ckpt_dir)
             if (mt := _STEP_FILE.match(name))]
    return max(steps) if steps else None


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState,
                    model_cfg=None, **extra_meta) -> str:
    """Save the state's params, optimizer state and step under ckpt_dir;
    model_cfg and extra keywords (e.g. train_config=...) go to meta.json."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = step_path(ckpt_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"params": state.params, "opt_state": state.opt_state,
                "step": state.step, "ema": state.ema}, tmp)
    os.replace(tmp, path)
    if model_cfg is not None or extra_meta:
        save_meta(ckpt_dir, model_cfg, **extra_meta)
    return path


def restore_checkpoint(ckpt_dir: str, step: int | None = None,
                       device: str | torch.device = "cpu"
                       ) -> tuple[TrainState, int]:
    """The TrainState saved at `step` (default: the latest), on `device`,
    and its step."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    tree = torch.load(step_path(ckpt_dir, step), map_location=device,
                      weights_only=True)
    return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                      step=tree["step"], ema=tree.get("ema")), step


def load_plain_params(ckpt_dir: str, cfg=None, prefer_ema: bool = False,
                      device: str | torch.device = "cpu"):
    """The latest checkpoint's params (with prefer_ema, its Polyak
    average, which a checkpoint without one refuses) on `device`, an ep
    checkpoint's merged: (params, cfg, step, meta). cfg defaults to the
    one in meta.json (JAX `load_plain_params`)."""
    meta = load_meta(ckpt_dir) or {}
    if cfg is None:
        cfg = load_model_config(ckpt_dir)
        if cfg is None:
            raise FileNotFoundError(
                f"{ckpt_dir}/meta.json has no model_config; pass cfg")
    state, got = restore_checkpoint(ckpt_dir, device=device)
    tree = state.params
    if prefer_ema:
        if state.ema is None:
            raise ValueError(f"{ckpt_dir} carries no EMA params (train "
                             "with --ema-decay > 0)")
        tree = state.ema  # the same layout as the params: merged alike
    if (meta.get("parallel") or {}).get("mode") == "ep":
        from rnn_transducer_tpu_torch.parallel.tp import merge_params_ep
        tree = merge_params_ep(tree, cfg)
    return tree, cfg, got, meta
