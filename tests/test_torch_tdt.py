"""The port's token-and-duration transducer (`ops/rnnt_tdt.py`, the
joint's duration head, its training step, MWER, greedy and streaming
decode, the CLIs) against the JAX package's on the CPU, after
tests/test_tdt.py.

Inputs are seeded numpy draws. The loss within 1e-5 relative and its
gradients within 1e-5 of the largest, at duration sets with and without
0 (ragged lengths, a zero-frame row, a row whose labels its frames cannot
hold: 1e30 and no gradient); `joint_tdt` and `joint_step_tdt`, float and
int8; the params tree and the refusals of `init_params`; `loss_fn` and a
`make_train_step` step with and without ctc_weight; MWER; greedy decode
(tokens, lengths, frames, t_over, confidences) and its chunk carry on a
model made to jump; `stream_transcribe`; the training CLI, then the
decode CLI and the serving engines on its checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import streaming as jstreaming
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import quant as jq
from rnn_transducer_tpu.ops import rnnt_tdt as jtdt
from rnn_transducer_tpu_torch import recognize as rec
from rnn_transducer_tpu_torch import serve as port_serve
from rnn_transducer_tpu_torch.decode import streaming as tstreaming
from rnn_transducer_tpu_torch.decode.beam import recognize_beam
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import quant as tq
from rnn_transducer_tpu_torch.ops import rnnt_tdt as ttdt
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.weights import (load_state_dict,
                                              params_from_numpy,
                                              params_to_numpy)
from test_torch_multiblank import (SMALL, _j, _t, assert_grads_close,
                                   chunked_greedy, configs, family_params,
                                   greedy_matches_jax, loss_fn_matches_jax,
                                   mwer_matches_jax, train_step_matches_jax)

pytestmark = pytest.mark.quick


# --------------------------------- the loss ---------------------------------

def _tdt_case(durs, seed):
    rng = np.random.default_rng(seed)
    B, T, U, V = 5, 14, 5, 9
    logits = (2 * rng.normal(size=(B, T, U + 1, V))).astype(np.float32)
    dur = rng.normal(size=(B, T, U + 1, len(durs))).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    fl = np.array([14, 11, 0, 3, 9], np.int32)
    # row 3: 5 labels in 3 frames, which a set without 0 cannot hold
    ll = np.array([5, 3, 2, 5, 0], np.int32)
    return logits, dur, labels, fl, ll


@pytest.mark.parametrize("durs", [(0, 1, 2, 4), (1, 2), (0, 1, 2)],
                         ids=["durs_0_1_2_4", "durs_1_2", "durs_0_1_2"])
@pytest.mark.parametrize("form", ["logits", "from_lp"])
def test_loss_and_gradients_match_jax(durs, form):
    logits, dur, labels, fl, ll = _tdt_case(durs, len(durs))
    weights = np.arange(1, 6, dtype=np.float32)
    if form == "logits":
        inputs = (logits, dur)

        def jfn(a, b):
            return jtdt.rnnt_loss_tdt(a, b, labels, fl, ll, durs)

        def tfn(a, b):
            return ttdt.rnnt_loss_tdt(a, b, _t(labels), _t(fl), _t(ll), durs)
    else:
        lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
        lp_y = np.take_along_axis(lp[:, :, :-1], labels[:, None, :, None],
                                  axis=-1)[..., 0]
        lp_y = np.concatenate([lp_y, np.full(lp_y.shape[:2] + (1,), -1e30,
                                             np.float32)], -1)
        inputs = (lp[..., 0], lp_y,
                  np.asarray(jax.nn.log_softmax(dur, axis=-1)))

        def jfn(a, b, c):
            return jtdt.rnnt_loss_tdt_from_lp(a, b, c, fl, ll, durs)

        def tfn(a, b, c):
            return ttdt.rnnt_loss_tdt_from_lp(a, b, c, _t(fl), _t(ll), durs)
    want = np.asarray(jfn(*inputs))
    want_g = jax.grad(lambda *x: jnp.sum(jfn(*x) * weights),
                      argnums=tuple(range(len(inputs))))(*inputs)
    xs = [_t(x).clone().requires_grad_(True) for x in inputs]
    got = tfn(*xs)
    (got * _t(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert float(got[2].detach()) == 0.0
    dead = 0 not in durs  # row 3 cannot be aligned
    assert (float(got[3].detach()) == float(np.float32(1e30))) == dead
    assert_grads_close([x.grad for x in xs], want_g)
    for x in xs:
        assert torch.isfinite(x.grad).all()
        assert float(x.grad[2].abs().max()) == 0.0
        if dead:
            assert float(x.grad[3].abs().max()) == 0.0


@pytest.mark.parametrize("durs, dur_d, match", [
    ((0, 1, 1), 3, "bad TDT duration set"),
    ((0, -1, 2), 3, "bad TDT duration set"),
    ((0,), 1, "bad TDT duration set"),
    ((0, 1, 2), 4, "dur_logits"),
], ids=["repeat", "negative", "no_jump", "dur_shape"])
def test_validation_matches_jax(durs, dur_d, match):
    logits, dur, labels, fl, ll = _tdt_case((0,) * dur_d, 0)
    with pytest.raises(ValueError, match=match):
        jtdt.rnnt_loss_tdt(logits, dur, labels, fl, ll, durs)
    with pytest.raises(ValueError, match=match):
        ttdt.rnnt_loss_tdt(_t(logits), _t(dur), _t(labels), _t(fl), _t(ll),
                           durs)


# ------------------------------ model and joint -----------------------------

@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_init_params_has_the_jax_tree_shapes(family):
    jcfg, cfg = configs(family, ctc_head=True)
    want = jax.tree.map(np.shape, jax.tree.map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg)))
    got = jax.tree.map(np.shape, params_to_numpy(
        tm.init_params(cfg, np.random.default_rng(0), device="cpu")))
    assert got == want


@pytest.mark.parametrize("fields, match", [
    (dict(big_blank_durations=(2,)), "mutually exclusive"),
    (dict(joint_experts=2), "MoE joint"),
], ids=["both_families", "moe"])
def test_init_params_refusals_match_jax(fields, match):
    jcfg, cfg = configs("tdt", **fields)
    with pytest.raises(ValueError, match=match):
        jm.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match=match):
        tm.init_params(cfg, np.random.default_rng(0), device="cpu")


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_joint_tdt_matches_jax(quantized):
    """joint_tdt over a (B, T, U+1) lattice and joint_step_tdt at single
    positions: token and duration logits within 1e-5; int8 params
    (quantize_params on both sides) dequantized as JAX does."""
    jcfg, cfg = configs("tdt")
    p_np = family_params("tdt")
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = params_from_numpy(p_np)
    if quantized:
        jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
        assert isinstance(tp["joint"]["dur"]["w"], tq.QTensor)
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(2, 5, SMALL["enc_hidden"])).astype(np.float32)
    pred = rng.normal(size=(2, 3, SMALL["pred_hidden"])).astype(np.float32)
    want = jm.joint_tdt(jp, jcfg, _j(enc), _j(pred))
    got = tm.joint_tdt(tp, cfg, _t(enc), _t(pred))
    want_s = jm.joint_step_tdt(jp, jcfg, _j(enc[:, 0]), _j(pred[:, 0]))
    got_s = tm.joint_step_tdt(tp, cfg, _t(enc[:, 0]), _t(pred[:, 0]))
    for g, w in zip(got + got_s, want + want_s):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_load_state_dict_refuses_a_tdt_config(tmp_path):
    """tools/export_torch_ckpt.py writes no duration head."""
    _, cfg = configs("tdt")
    with pytest.raises(NotImplementedError, match="item 18"):
        load_state_dict(str(tmp_path / "none.pt"), cfg, device="cpu")


# --------------------------------- training ---------------------------------

@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_loss_fn_matches_jax(ctc_weight):
    loss_fn_matches_jax("tdt", ctc_weight)


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_train_step_matches_jax(ctc_weight):
    train_step_matches_jax("tdt", ctc_weight)


def test_mwer_loss_fn_matches_jax():
    mwer_matches_jax("tdt")


# ---------------------------------- decode ----------------------------------

@pytest.mark.parametrize("family", ["tdt", "tdt_no_zero"])
def test_greedy_matches_jax(family):
    """Every emission advances by its argmax duration: the recipe's
    frames jump by more than one."""
    tok, n, st = greedy_matches_jax(family)
    frames = st[3][0, :int(n[0])].numpy()
    assert int(n.sum()) > 0 and np.diff(frames).max() > 1


@pytest.mark.parametrize("family", ["tdt", "tdt_no_zero"])
def test_streaming_jumps_across_chunk_boundaries(family):
    assert chunked_greedy(family).max() > 0


@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_stream_transcribe_matches_jax_and_offline(family):
    """The whole streaming path (encode_chunk, then the greedy carry) at
    4-frame chunks equals JAX's stream_transcribe and the port's offline
    decode."""
    jcfg, cfg = configs(family)
    p_np = family_params(family)
    rng = np.random.default_rng(9)
    feats = (2 * rng.normal(size=(3, 16, SMALL["input_dim"]))).astype(
        np.float32)
    lens = np.array([16, 11, 6], np.int32)
    want = jstreaming.stream_transcribe(
        jax.tree.map(jnp.asarray, p_np), jcfg, _j(feats), _j(lens), 4,
        max_symbols=10, with_timestamps=True)
    params = params_from_numpy(p_np)
    got = tstreaming.stream_transcribe(params, cfg, _t(feats), _t(lens), 4,
                                       max_symbols=10, with_timestamps=True,
                                       device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    off = recognize_greedy(params, cfg, _t(feats), _t(lens), max_symbols=10)
    for g, w in zip(got[:2], off):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ----------------------------------- CLIs -----------------------------------

@pytest.fixture(scope="module")
def tdt_ckpt(tmp_path_factory):
    """Two CPU steps of the training CLI with --tdt-durations."""
    ck = str(tmp_path_factory.mktemp("tdt") / "ck")
    train_main(["--config", "smoke", "--steps", "2", "--batch-size", "2",
                "--max-frames", "24", "--max-labels", "4",
                "--tdt-durations", "0,1,2", "--ckpt-dir", ck,
                "--eval-every", "0", "--device", "cpu"])
    return ck


def test_train_then_recognize_cli(tdt_ckpt, capsys):
    """--tdt-durations through train -> checkpoint (the tuple restored
    from meta.json) -> the decode CLI, greedy, beam and streaming (as
    tests/test_tdt.py:297)."""
    cfg = ckpt.load_model_config(tdt_ckpt)
    assert cfg.tdt_durations == (0, 1, 2)
    capsys.readouterr()
    for mode in ("greedy", "beam", "streaming"):
        rec.main(["--ckpt-dir", tdt_ckpt, "--mode", mode, "--data",
                  "synthetic", "--batches", "1", "--batch-size", "2",
                  "--max-symbols", "6", "--beam", "2", "--chunk-frames",
                  "8", "--device", "cpu"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["mode"] == mode and "wer" in out


def test_train_cli_refusals():
    with pytest.raises(SystemExit, match="must be > 1"):
        train_main(["--big-blanks", "1,2", "--device", "cpu"])
    for flag, value in (("--big-blanks", "2,4"), ("--tdt-durations", "0,1")):
        with pytest.raises(SystemExit, match="auto\\|xla"):
            train_main([flag, value, "--loss-impl", "fused", "--device",
                        "cpu"])


def test_engines_serve_the_checkpoint(tdt_ckpt):
    """serve.py's --ckpt-dir path: the config with its durations from
    meta.json; BatchingEngine (greedy and beam) and a StreamingEngine
    session answer as the decoders do on the same params."""
    args = port_serve.parse_args(["--ckpt-dir", tdt_ckpt])
    cfg, _, _ = port_serve.model_meta(args)
    assert cfg.tdt_durations == (0, 1, 2)
    params = port_serve.load_params(args, cfg, device="cpu")
    utt = np.random.default_rng(2).normal(
        size=(40, cfg.input_dim)).astype(np.float32)
    feats, lens = _t(utt[None]), torch.tensor([40], dtype=torch.int32)
    greedy = recognize_greedy(params, cfg, feats, lens, max_symbols=20)
    beam = recognize_beam(params, cfg, feats, lens, beam=2, max_symbols=20)
    for mode, want in (("greedy", greedy[0][0, :int(greedy[1][0])]),
                       ("beam", beam[0][0, 0, :int(beam[1][0, 0])])):
        eng = port_serve.BatchingEngine(params, cfg, mode=mode, beam=2,
                                        max_symbols=20, device="cpu")
        try:
            assert eng.submit(utt) == want.tolist()
        finally:
            eng.close()
    st = port_serve.StreamingEngine(params, cfg, slots=2, chunk_frames=8,
                                    max_symbols=20, device="cpu")
    try:
        sid = st.open_session()
        for c0 in range(0, 40, 8):
            st.feed(sid, utt[c0:c0 + 8])
        assert st.close_session(sid) == greedy[0][0, :int(greedy[1][0])
                                                  ].tolist()
    finally:
        st.close()
