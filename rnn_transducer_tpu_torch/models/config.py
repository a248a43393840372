"""Model / training configuration dataclasses (PyTorch port).

A field-for-field copy of `rnn_transducer_tpu/models/config.py`: the same
dataclasses, fields, defaults and named configs, so a config serialised by
either package loads in the other. It is a copy and not an import because
importing the JAX package imports jax. The only difference is `cdtype`,
which returns a `torch.dtype`. Field documentation lives in the JAX module.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    """Architecture of encoder + prediction network + joint."""

    input_dim: int = 80
    enc_type: str = "lstm"
    enc_layers: int = 2
    enc_hidden: int = 256
    bidirectional: bool = False
    time_reduction: int = 1
    enc_heads: int = 8
    enc_ff_mult: int = 4
    enc_conv_kernel: int = 15
    enc_att_left: int = 0
    enc_chunk_att: int = 0
    pred_layers: int = 1
    pred_hidden: int = 256
    embed_dim: int = 256
    pred_type: str = "lstm"
    pred_context: int = 2
    joint_dim: int = 256
    vocab_size: int = 64
    blank: int = 0
    big_blank_durations: tuple = ()
    tdt_durations: tuple = ()
    compute_dtype: str = "bfloat16"
    remat_encoder: bool = False
    ctc_head: bool = False
    pruned_range: int = 0
    joint_experts: int = 0
    joint_expert_hidden: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def moe_hidden(self) -> int:
        return self.joint_expert_hidden or 2 * self.joint_dim

    @property
    def streamable(self) -> bool:
        if self.enc_type == "conformer":
            return self.enc_att_left > 0 or self.enc_chunk_att > 0
        return not self.bidirectional

    @property
    def n_classes(self) -> int:
        """Joint output columns: vocab plus one per big-blank duration."""
        return self.vocab_size + len(self.big_blank_durations)

    @property
    def enc_out_dim(self) -> int:
        if self.enc_type == "conformer":
            return self.enc_hidden
        return self.enc_hidden * (2 if self.bidirectional else 1)

    @property
    def cdtype(self) -> torch.dtype:
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        return _DTYPES[self.compute_dtype]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: float = 5.0
    warmup_steps: int = 500
    total_steps: int = 100_000
    lr_schedule: str = "warmup_cosine"
    decay_rate: float = 0.5
    decay_every: int = 10_000
    seed: int = 0
    weight_noise_std: float = 0.0
    dropout: float = 0.0
    embed_dropout: float = 0.0
    ctc_weight: float = 0.0
    fastemit_lambda: float = 0.0
    ema_decay: float = 0.0
    grad_accum: int = 1
    loss_impl: str = "auto"
    simple_loss_scale: float = 0.5
    mwer_beam: int = 4
    mwer_expansions: int = 2
    mwer_max_symbols: int = 64
    mwer_nll_weight: float = 0.0
    distill_weight: float = 0.0
    distill_temp: float = 1.0
    ar_range: int = 0
    ar_left: int = -1
    data_parallel: int = 1
    buckets: tuple[tuple[int, int], ...] = ((400, 50), (800, 100), (1600, 200))


def config_greedy_smoke() -> TransducerConfig:
    """configs[0]: 2x256 LSTM encoder + 1x256 prediction net, 80-dim log-mel."""
    return TransducerConfig(enc_layers=2, enc_hidden=256, pred_layers=1,
                            pred_hidden=256, embed_dim=256, joint_dim=256,
                            vocab_size=64)


def config_timit() -> TransducerConfig:
    """configs[1]: TIMIT phonemes — 3x320 BiLSTM encoder. 62 phones + blank."""
    return TransducerConfig(enc_layers=3, enc_hidden=320, bidirectional=True,
                            pred_layers=1, pred_hidden=320, embed_dim=320,
                            joint_dim=320, vocab_size=63)


def config_libri100() -> TransducerConfig:
    """configs[2]: LibriSpeech train-clean-100 — 4x512 LSTM encoder."""
    return TransducerConfig(enc_layers=4, enc_hidden=512, pred_layers=1,
                            pred_hidden=512, embed_dim=512, joint_dim=512,
                            vocab_size=1024, time_reduction=2)


def config_libri960() -> TransducerConfig:
    """configs[4]: LibriSpeech 960h — 6x1024 encoder, char vocab (~30)."""
    return TransducerConfig(enc_layers=6, enc_hidden=1024, pred_layers=2,
                            pred_hidden=1024, embed_dim=512, joint_dim=1024,
                            vocab_size=32, time_reduction=2)


def config_libri100_conformer() -> TransducerConfig:
    """Conformer-encoder twin of configs[2]: 8 blocks x d=512."""
    return TransducerConfig(enc_type="conformer", enc_layers=8,
                            enc_hidden=512, enc_heads=8, enc_ff_mult=4,
                            enc_conv_kernel=15, pred_layers=1,
                            pred_hidden=512, embed_dim=512, joint_dim=512,
                            vocab_size=1024, time_reduction=4)


def config_conformer_smoke() -> TransducerConfig:
    """Smoke-scale conformer (2 blocks x d=128)."""
    return TransducerConfig(enc_type="conformer", enc_layers=2,
                            enc_hidden=128, enc_heads=4, enc_ff_mult=2,
                            enc_conv_kernel=7, pred_layers=1,
                            pred_hidden=128, embed_dim=128, joint_dim=128,
                            vocab_size=64, time_reduction=4)


def config_libri100_conformer_stream() -> TransducerConfig:
    """Causal/streamable conformer twin: 64-frame left attention window."""
    return dataclasses.replace(config_libri100_conformer(), enc_att_left=64)


def config_libri100_conformer_chunked() -> TransducerConfig:
    """Chunked-attention streamable twin: 32-frame chunks + 64 left."""
    return dataclasses.replace(config_libri100_conformer(), enc_chunk_att=32,
                               enc_att_left=64)


NAMED_CONFIGS = {
    "greedy_smoke": config_greedy_smoke,
    "timit": config_timit,
    "libri100": config_libri100,
    "libri960": config_libri960,
    "libri100_conformer": config_libri100_conformer,
    "conformer_smoke": config_conformer_smoke,
    "libri100_conformer_stream": config_libri100_conformer_stream,
    "libri100_conformer_chunked": config_libri100_conformer_chunked,
}
