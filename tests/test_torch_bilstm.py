"""The port's bidirectional LSTM encoder against the JAX package's.

`reverse_padded`, `bilstm_layer` and a bidirectional `encode` (f32 within
1e-5, bf16, int8 params, with and without frame stacking), a 2-step
`make_train_step` trajectory (xla loss on both sides), greedy and beam
tokens, `load_state_dict` of a `tools/export_torch_ckpt.py` export of
BiLSTM params, and the decode CLI on a BiLSTM config (float and int8,
streaming refused with JAX's words). Params come from the JAX
`init_params` and cross through `params_from_numpy`. Also the host-side
LSTM plans at every shape chip_smoke's TIMIT and libri960 phases launch,
on an H100's limits.
"""

import dataclasses
import functools
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import beam as jb
from rnn_transducer_tpu.decode.greedy import recognize_greedy as jax_greedy
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import lstm as jax_lstm
from rnn_transducer_tpu.ops import quant as jq
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch import recognize as rec
from rnn_transducer_tpu_torch.data.synthetic import (learnable_batch,
                                                     random_batch)
from rnn_transducer_tpu_torch.decode import beam as tb
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import lstm as tl
from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
from rnn_transducer_tpu_torch.ops import quant as tq
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.weights import (load_state_dict,
                                              params_from_numpy,
                                              params_to_numpy)

pytestmark = pytest.mark.quick

REPO = pathlib.Path(__file__).resolve().parents[1]
BI = dict(input_dim=8, enc_layers=2, enc_hidden=16, bidirectional=True,
          time_reduction=2, pred_layers=1, pred_hidden=12, embed_dim=10,
          joint_dim=14, vocab_size=11, compute_dtype="float32")
MAX_SYMBOLS = 30


def _cfgs(**kw):
    fields = {**BI, **kw}
    return (jax_config.TransducerConfig(**fields),
            port_config.TransducerConfig(**fields))


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))


def _feats(seed=0, B=5, T=21, scale=1.0):
    rng = np.random.default_rng(seed)
    feats = (scale * rng.normal(size=(B, T, BI["input_dim"]))).astype(
        np.float32)
    lens = np.array([T, T - 6, 0, 4, 1, 13, T, 9], np.int32)[:B]
    return feats, lens


# ----------------------------- the layer --------------------------------

@pytest.mark.parametrize("trailing", [(), (3,), (2, 3)])
def test_reverse_padded_matches_jax(trailing):
    """Ragged lengths with a zero-length row: the valid prefix reversed,
    padding mapped to itself, bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 9) + trailing).astype(np.float32)
    lens = np.array([9, 4, 0, 1, 7], np.int32)
    want = np.asarray(jax_lstm.reverse_padded(jnp.asarray(x),
                                              jnp.asarray(lens)))
    got = tl.reverse_padded(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[2].numpy(), x[2])  # zero length
    back = tl.reverse_padded(got, torch.from_numpy(lens))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("cd, atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_bilstm_layer_matches_jax(cd, atol):
    jcfg, _ = _cfgs()
    layer = _params(jcfg)["encoder"][0]
    feats, lens = _feats(seed=2)
    jdt, tdt = jnp.dtype(cd), getattr(torch, cd)
    want = jax_lstm.bilstm_layer(
        jax.tree.map(jnp.asarray, layer["fwd"]),
        jax.tree.map(jnp.asarray, layer["bwd"]), jnp.asarray(feats),
        jnp.asarray(lens), compute_dtype=jdt)
    tp = params_from_numpy(layer)
    got = tl.bilstm_layer(tp["fwd"], tp["bwd"], torch.from_numpy(feats),
                          torch.from_numpy(lens), compute_dtype=tdt)
    assert got.shape == (5, 21, 2 * BI["enc_hidden"])
    valid = np.arange(21)[None, :] < lens[:, None]  # pads are garbage
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=atol, rtol=0)


# ---------------------------- the encoder -------------------------------

def test_check_supported_takes_timit():
    tm.check_supported(port_config.config_timit())
    jcfg, tcfg = _cfgs()
    want = jax.tree.map(np.shape, _params(jcfg))
    got = jax.tree.map(np.shape, params_to_numpy(
        tm.init_params(tcfg, np.random.default_rng(0), device="cpu")))
    assert got == want
    assert got["encoder"][1]["fwd"]["w_ih"] == (2 * 2 * 16, 64)


@pytest.mark.parametrize("kw, atol", [
    (dict(), 1e-5),                                   # 2x stacking
    (dict(time_reduction=1, enc_layers=3), 1e-5),     # TIMIT's layout
    (dict(compute_dtype="bfloat16"), 2e-2),
])
def test_bidirectional_encode_matches_jax(kw, atol):
    jcfg, tcfg = _cfgs(**kw)
    p = _params(jcfg)
    feats, lens = _feats(seed=3)
    want, want_lens = jm.encode(jax.tree.map(jnp.asarray, p), jcfg,
                                jnp.asarray(feats), jnp.asarray(lens))
    got, got_lens = tm.encode(params_from_numpy(p), tcfg,
                              torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape and got.shape[-1] == 2 * BI["enc_hidden"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("H, B", [(16, 5), (128, 8)])
def test_int8_bidirectional_encode_matches_jax(H, B, monkeypatch):
    """quantize_params quantizes the {"fwd", "bwd"} dicts leaf for leaf as
    JAX's. At H = 16 (TIMIT's H % 128 != 0 alike) both sides dequantize
    w_hh; at H = 128, B = 8 the port takes the W8A8 recurrence, held
    against JAX's int8 Pallas core in interpret mode (the TPU's route)."""
    jcfg, tcfg = _cfgs(enc_hidden=H)
    p = _params(jcfg)
    feats, lens = _feats(seed=4, B=B)
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, p))
    tqp = tq.quantize_params(params_from_numpy(p))
    for a, b in zip(jax.tree.leaves(params_to_numpy(tqp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jqp))):
        np.testing.assert_array_equal(a, b)
    if tl.w8a8_supported(B, H):
        monkeypatch.setattr(jax_lstm, "lstm_layer", functools.partial(
            jax_lstm.lstm_layer, impl="pallas"))
    want, _ = jm.encode(jqp, jcfg, jnp.asarray(feats), jnp.asarray(lens))
    launches = q8.LAUNCHES
    got, _ = tm.encode(tqp, tcfg, torch.from_numpy(feats),
                       torch.from_numpy(lens))
    assert q8.LAUNCHES == launches  # the CPU takes the plain versions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ----------------------------- training ---------------------------------

def test_bidirectional_trajectory_matches_jax():
    """2 steps of make_train_step on a BiLSTM with the xla loss: losses
    within 1e-5, params within 2e-6 (tests/test_torch_train.py's bounds)."""
    fields = dict(BI, enc_hidden=12, pred_hidden=10, joint_dim=12)
    jcfg = jax_config.TransducerConfig(**fields)
    tcfg = port_config.TransducerConfig(**fields)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              loss_impl="xla")
    rng = np.random.default_rng(5)
    batches = [random_batch(rng, 3, 12, 4, 8, 11) for _ in range(2)]
    jstate = jloop.init_train_state(jax.random.PRNGKey(0), jcfg,
                                    jax_config.TrainConfig(**kw))
    p0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(jcfg, jax_config.TrainConfig(**kw))
    tstate = tloop.init_train_state(None, tcfg, port_config.TrainConfig(**kw),
                                    params=params_from_numpy(p0))
    tstep = tloop.make_train_step(tcfg, port_config.TrainConfig(**kw),
                                  device="cpu")
    for batch in batches:
        jstate, jinfo = jstep(jstate, *(jnp.asarray(a) for a in batch))
        tstate, tinfo = tstep(tstate, *(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(float(tinfo["loss"]), float(jinfo["loss"]),
                                   rtol=1e-5, atol=1e-5)
    moved = 0.0
    for (path, a), b, c in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(
                tstate.params)),
            jax.tree.leaves(jax.tree.map(np.asarray, jstate.params)),
            jax.tree.leaves(p0)):
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0, err_msg=str(path))
        moved = max(moved, float(np.abs(a - c).max()))
    assert moved > 1e-4


# ----------------------------- decoding ---------------------------------

def _walking(jcfg, seed=3, blank_offset=0.04):
    p = _params(jcfg, seed)
    p["joint"]["out"]["b"] = p["joint"]["out"]["b"].copy()
    p["joint"]["out"]["b"][jcfg.blank] += blank_offset
    return p


def test_greedy_tokens_match_jax():
    jcfg, tcfg = _cfgs()
    p = _walking(jcfg)
    feats, lens = _feats(seed=6, B=5, T=40, scale=3.0)
    want = jax_greedy(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(feats),
                      jnp.asarray(lens), max_symbols=MAX_SYMBOLS,
                      with_confidence=True, with_timestamps=True)
    got = recognize_greedy(params_from_numpy(p), tcfg, torch.from_numpy(feats),
                           torch.from_numpy(lens), max_symbols=MAX_SYMBOLS,
                           with_confidence=True, with_timestamps=True)
    tok, n, conf, fr = (a.numpy() for a in got)
    np.testing.assert_array_equal(n, np.asarray(want[1]))
    np.testing.assert_array_equal(tok, np.asarray(want[0]))
    np.testing.assert_array_equal(fr, np.asarray(want[3]))
    np.testing.assert_allclose(conf, np.asarray(want[2]), atol=1e-5, rtol=0)
    assert n.sum() > 0


def test_beam_tokens_match_jax():
    jcfg, tcfg = _cfgs()
    p = _walking(jcfg, blank_offset=0.0)
    out = p["joint"]["out"]
    out["w"], out["b"] = out["w"] * np.float32(12), out["b"] * np.float32(12)
    out["b"][jcfg.blank] -= 1.0
    feats, lens = _feats(seed=7, B=5, T=40, scale=3.0)
    want = [np.asarray(a) for a in jb.recognize_beam(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(feats),
        jnp.asarray(lens), beam=4, max_symbols=MAX_SYMBOLS,
        with_confidence=True, with_timestamps=True)]
    got = [a.numpy() for a in tb.recognize_beam(
        params_from_numpy(p), tcfg, torch.from_numpy(feats),
        torch.from_numpy(lens), beam=4, max_symbols=MAX_SYMBOLS,
        with_confidence=True, with_timestamps=True)]
    live = want[2] > -5e29
    np.testing.assert_array_equal(got[2] > -5e29, live)
    np.testing.assert_array_equal(got[1][live], want[1][live])
    np.testing.assert_allclose(got[2][live], want[2][live], atol=1e-4,
                               rtol=0)
    for b, k in zip(*np.nonzero(live)):
        m = want[1][b, k]
        np.testing.assert_array_equal(got[0][b, k, :m], want[0][b, k, :m])
    assert want[1][live].max() >= 2


# ------------------------- weights and the CLI ----------------------------

def test_load_state_dict_reads_a_bidirectional_export(tmp_path):
    """`_reverse` keys into "bwd", and the next layer's in_dim 2H (x2
    after the stacked layer 0): every leaf bit for bit."""
    jcfg, tcfg = _cfgs(enc_layers=3)
    p = _params(jcfg, seed=8)
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from export_torch_ckpt import params_to_torch_state_dict
    finally:
        sys.path.remove(str(REPO / "tools"))
    sd = params_to_torch_state_dict(p, jcfg)
    assert "enc_layers.2.weight_ih_l0_reverse" in sd
    path = tmp_path / "bilstm.pt"
    torch.save(sd, path)
    got = params_to_numpy(load_state_dict(str(path), tcfg, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(p)
    for (path_, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                             jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b, err_msg=str(path_))
    with pytest.raises(ValueError, match="shape"):
        load_state_dict(str(path), dataclasses.replace(tcfg,
                                                       bidirectional=False))


def _cfg_file(tmp_path):
    path = tmp_path / "bilstm.json"
    path.write_text(json.dumps({k: v for k, v in BI.items()}))
    return str(path)


@pytest.mark.parametrize("quantize", [[], ["--quantize", "int8"]])
def test_decode_cli_runs_a_bilstm(tmp_path, quantize):
    """The decode CLI on a BiLSTM config (fresh weights from --seed),
    float and int8: its hyps are the port's recognize_greedy on the same
    weights."""
    cfg_path = _cfg_file(tmp_path)
    hyps = tmp_path / "h.jsonl"
    out = rec.main(["--config", cfg_path, "--batch-size", "4", "--batches",
                    "1", "--hyps-file", str(hyps), "--device", "cpu",
                    *quantize])
    assert out["mode"] == "greedy" and np.isfinite(out["wer"])
    tcfg = port_config.TransducerConfig(**BI)
    params = tm.init_params(tcfg, np.random.default_rng(0), device="cpu")
    if quantize:
        params = tq.quantize_params(params)
    feats, fl, _, _ = learnable_batch(np.random.default_rng(1), 4,
                                      n_labels=10, input_dim=8, vocab=11,
                                      frames_per_label=4)
    toks, n = recognize_greedy(params, tcfg, torch.from_numpy(feats),
                               torch.from_numpy(fl), max_symbols=100)
    want = [toks[i, :n[i]].tolist() for i in range(4)]
    got = [json.loads(line)["hyp"] for line in hyps.read_text().splitlines()]
    assert got == want


@pytest.mark.parametrize("mode", ["streaming", "streaming_beam"])
def test_decode_cli_refuses_to_stream_a_bilstm(tmp_path, mode):
    with pytest.raises(SystemExit, match="unidirectional encoder"):
        rec.main(["--config", _cfg_file(tmp_path), "--mode", mode,
                  "--device", "cpu"])


# ------------------- the card's plans at chip_smoke's shapes ---------------

N_SM, SMEM = 132, 232_448  # H100 SXM: SMs, opt-in shared bytes a block
# (B, H) of every K4 launch of chip_smoke's TIMIT and libri960 phases:
# TIMIT training B=16 and serving up to max_batch 8 at H=320; libri960
# training at B=64, its two ranks' B=32, the f32 check's B=8, serving and
# streaming up to B=8, at H=1024.
K4_SHAPES = [(16, 320), (8, 320), (1, 320), (64, 1024), (32, 1024),
             (8, 1024), (1, 1024)]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, H", K4_SHAPES)
def test_k4_plans_place_the_new_shapes(direction, dtype, B, H):
    plan = lstm_cuda.lstm_plan(direction, B, H, dtype, N_SM, SMEM)
    assert plan.grid[0] * plan.grid[1] <= N_SM
    assert plan.smem_bytes <= SMEM
    owned = {(u, r) for x in range(plan.grid[0]) for y in range(plan.grid[1])
             for u in plan.owned(x, y)[0] for r in plan.owned(x, y)[1]}
    assert len(owned) == B * H


@pytest.mark.parametrize("B", [8, 64])
def test_k7_groups_place_libri960(B):
    """int8 libri960 serving (B=8) and the card test's B=64 at H=1024:
    whole batch tiles, each group in one wave."""
    gs = q8.groups(B, 1024, N_SM, SMEM)
    assert gs[0][0] == 0 and gs[-1][1] == B
    for (start, end, plan), nxt in zip(gs, gs[1:] + ((B, B, None),)):
        assert end == nxt[0] and plan.grid[0] * plan.grid[1] <= N_SM
        assert plan.smem_bytes <= SMEM
