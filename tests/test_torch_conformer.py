"""The port's conformer encoder (ops/conformer.py, the conformer branch of
models/transducer.py) against the JAX package's, on the CPU.

Params come from the JAX `init_params` / `init_conformer_block` and cross
through `params_from_numpy`; inputs come from numpy seeds; compute_dtype
is float32 on both sides unless a test says otherwise. Every LayerNorm of
the port runs the plain version of K8 here; the JAX block runs its XLA
LayerNorm (its fused kernel is TPU-only), the same function to f32
tolerance (tests/test_fused_ln.py).

Tolerances, f32: the block within 2e-5 absolute (outputs are O(1) after
the final LN; f32 sums of attention, FFN and depthwise taps in another
order), its input gradient within 1e-4 of its largest value; `encode`
within 1e-4 absolute over two blocks. bf16: see
`test_encode_bf16_within_bound`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode.greedy import recognize_greedy as jax_recognize
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import conformer as jcf
from rnn_transducer_tpu.ops import quant as jquant
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.decode import greedy_fused as gf
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import conformer as tcf
from rnn_transducer_tpu_torch.ops import quant as tquant
from rnn_transducer_tpu_torch.serve import BatchingEngine
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.weights import (load_state_dict,
                                              params_from_numpy,
                                              params_to_numpy)

pytestmark = pytest.mark.quick

SMALL = dict(enc_type="conformer", input_dim=8, enc_layers=2, enc_hidden=32,
             enc_heads=4, enc_ff_mult=2, enc_conv_kernel=5, pred_layers=1,
             pred_hidden=16, embed_dim=8, joint_dim=16, vocab_size=13,
             time_reduction=4, compute_dtype="float32")
BLOCK_ATOL = 2e-5
BLOCK_GRAD_RTOL = 1e-4
ENC_ATOL = 1e-4
# (stacking, attention form): 2x and 4x stacking offline, and the causal
# (left window) and chunked (lookahead) forms of the offline encoder
ENC_CASES = [(2, {}), (4, {}), (4, {"enc_att_left": 3}),
             (4, {"enc_chunk_att": 2, "enc_att_left": 2})]
ENC_IDS = ["x2-offline", "x4-offline", "x4-causal", "x4-chunked"]


def _cfgs(**kw):
    fields = {**SMALL, **kw}
    return (jax_config.TransducerConfig(**fields),
            port_config.TransducerConfig(**fields))


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                   cfg))


def _feats(seed=0, B=4, T=24, scale=1.0):
    rng = np.random.default_rng(seed)
    feats = (scale * rng.normal(size=(B, T, SMALL["input_dim"]))).astype(
        np.float32)
    lens = np.array([T, T - 7, 0, 5], np.int32)[:B]  # ragged, a zero row
    return feats, lens


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------- block ----------------------------------

@pytest.mark.parametrize("att_left, chunk_att", [(0, 0), (3, 0), (2, 4)],
                         ids=["offline", "causal", "chunked"])
def test_conformer_block_and_input_grad_match_jax(att_left, chunk_att):
    d, heads, T = 32, 4, 12
    p = jax.tree.map(np.asarray, jcf.init_conformer_block(
        jax.random.PRNGKey(0), d, heads, 2, 5))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, T, d)).astype(np.float32)
    lens = np.array([T, 9, 0, 5], np.int32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jblock(x):
        return jcf.conformer_block(jax.tree.map(jnp.asarray, p), x,
                                   jnp.asarray(lens), heads, jnp.float32,
                                   att_left=att_left, chunk_att=chunk_att)

    want = np.asarray(jblock(jnp.asarray(x)))
    want_gx = np.asarray(jax.grad(lambda x: jnp.sum(jblock(x) * w))(
        jnp.asarray(x)))
    xs = torch.from_numpy(x).requires_grad_(True)
    got = tcf.conformer_block(params_from_numpy(p), xs,
                              torch.from_numpy(lens), heads, torch.float32,
                              att_left=att_left, chunk_att=chunk_att)
    (gx,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xs)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=BLOCK_ATOL,
                               rtol=0)
    assert _rel_err(gx.numpy(), want_gx) <= BLOCK_GRAD_RTOL


def test_init_conformer_block_distributions():
    p = tcf.init_conformer_block(np.random.default_rng(0), 64, 4, 4, 15)
    want = jax.tree.map(np.shape, jax.tree.map(np.asarray,
                        jcf.init_conformer_block(jax.random.PRNGKey(0), 64,
                                                 4, 4, 15)))
    assert jax.tree.map(np.shape, p) == want
    k = 1.0 / np.sqrt(64)
    assert np.abs(p["ff1"]["in"]["w"]).max() <= k
    assert np.abs(p["ff1"]["out"]["w"]).max() <= 1.0 / np.sqrt(256)
    assert 0.015 < p["att"]["rel"].std() < 0.025
    assert 0.8 < p["conv"]["dw_w"].std() * np.sqrt(15) < 1.2
    assert not p["conv"]["dw_b"].any() and (p["ln_out"]["g"] == 1).all()
    with pytest.raises(ValueError, match="heads"):
        tcf.init_conformer_block(np.random.default_rng(0), 30, 4, 4, 15)


# ------------------------------- encode ---------------------------------

@pytest.mark.parametrize("tr, variant", ENC_CASES, ids=ENC_IDS)
def test_encode_matches_jax(tr, variant):
    """JAX params carried into the port give the JAX encoder output."""
    jcfg, tcfg = _cfgs(time_reduction=tr, **variant)
    p = _jax_params(jcfg)
    feats, lens = _feats()
    want, want_lens = jm.encode(jax.tree.map(jnp.asarray, p), jcfg,
                                jnp.asarray(feats), jnp.asarray(lens))
    got, got_lens = tm.encode(params_from_numpy(p), tcfg,
                              torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL,
                               rtol=0)
    assert not got[2].any()  # the zero-length row is masked


def test_encode_bf16_within_bound():
    """At bf16 both sides round the same activations to bf16 at the same
    points, but a 1-ulp difference before a rounding (2^-8 relative) can
    flip a value and travel through both blocks; the final LN keeps the
    output O(1). Bound: 0.05 absolute, mean difference 5e-3."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    p = _jax_params(jcfg)
    feats, lens = _feats(seed=3)
    want, _ = jm.encode(jax.tree.map(jnp.asarray, p), jcfg,
                        jnp.asarray(feats), jnp.asarray(lens))
    got, _ = tm.encode(params_from_numpy(p), tcfg, torch.from_numpy(feats),
                       torch.from_numpy(lens))
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() <= 0.05 and err.mean() <= 5e-3, (err.max(), err.mean())


def test_pad_length_invariance():
    """Valid frames' encoder output does not depend on the padding behind
    them (attention key mask, GLU mask before the depthwise conv)."""
    _, tcfg = _cfgs()
    params = params_from_numpy(_jax_params(_cfgs()[0], seed=1))
    feats, lens = _feats(seed=4)
    pad = 100.0 * np.random.default_rng(5).normal(
        size=(4, 16, SMALL["input_dim"])).astype(np.float32)
    out1, l1 = tm.encode(params, tcfg, torch.from_numpy(feats),
                         torch.from_numpy(lens))
    out2, l2 = tm.encode(params, tcfg,
                         torch.from_numpy(np.concatenate([feats, pad], 1)),
                         torch.from_numpy(lens))
    assert torch.equal(l1, l2)
    for b in range(4):
        n = int(l1[b])
        torch.testing.assert_close(out2[b, :n], out1[b, :n], rtol=0,
                                   atol=1e-5)
        assert not out2[b, n:].any()


# ---------------------------- params bridge -----------------------------

def test_init_params_has_the_jax_tree_shapes():
    jcfg, tcfg = _cfgs()
    want = jax.tree.map(np.shape, _jax_params(jcfg))
    got = jax.tree.map(np.shape, params_to_numpy(
        tm.init_params(tcfg, np.random.default_rng(0), device="cpu")))
    assert got == want


def test_params_round_trip_is_exact():
    p = _jax_params(_cfgs()[0])
    back = params_to_numpy(params_from_numpy(p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_remat_encoder_raises_naming_its_roadmap_item():
    _, tcfg = _cfgs(remat_encoder=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        tm.init_params(tcfg, np.random.default_rng(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        tm.encode({}, tcfg, torch.zeros(1, 8, 8), torch.ones(1))


def test_load_state_dict_refuses_the_conformer(tmp_path):
    path = tmp_path / "model.pt"
    torch.save({}, path)
    with pytest.raises(NotImplementedError, match="export_torch_ckpt"):
        load_state_dict(str(path), _cfgs()[1], device="cpu")


# ------------------------------- int8 -----------------------------------

def test_int8_encode_matches_jax():
    """JAX quantize_params dequantizes every 2-D leaf in the conformer's
    encode (no w_hh to keep); the port's quantized tree is the JAX one bit
    for bit and its encoder output the JAX one within ENC_ATOL."""
    jcfg, tcfg = _cfgs()
    p = _jax_params(jcfg, seed=2)
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, p))
    tq = tquant.quantize_params(params_from_numpy(p))
    want_leaves = jax.tree.leaves(jax.tree.map(np.asarray, jq))
    got_leaves = jax.tree.leaves(params_to_numpy(tq))
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a, b)
    feats, lens = _feats(seed=6)
    want, _ = jm.encode(jq, jcfg, jnp.asarray(feats), jnp.asarray(lens))
    got, _ = tm.encode(tq, tcfg, torch.from_numpy(feats),
                       torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL,
                               rtol=0)


# ------------------------------- decode ---------------------------------

MAX_SYMBOLS = 12


def _walking(p, cfg):
    """The random model with the encoder side of the joint scaled up and
    blank raised, so utterances emit at several frames and walk on."""
    p = jax.tree.map(np.copy, p)
    p["joint"]["enc_proj"]["w"] *= 8.0
    p["joint"]["out"]["b"][cfg.blank] += 0.25
    return p


def test_recognize_greedy_matches_jax():
    jcfg, tcfg = _cfgs()
    p = _walking(_jax_params(jcfg, seed=3), jcfg)
    feats, lens = _feats(seed=7, B=4, T=40, scale=3.0)
    want = jax_recognize(jax.tree.map(jnp.asarray, p), jcfg,
                         jnp.asarray(feats), jnp.asarray(lens),
                         max_symbols=MAX_SYMBOLS, with_timestamps=True)
    got = recognize_greedy(params_from_numpy(p), tcfg,
                           torch.from_numpy(feats), torch.from_numpy(lens),
                           max_symbols=MAX_SYMBOLS, with_timestamps=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n = got[1].numpy()
    assert n[2] == 0 and n.sum() > 0 and len(set(n.tolist())) > 1


def test_tokens_do_not_depend_on_the_bucket():
    """The engine pads each batch to a frame bucket; the full-attention
    encoder sees the padded keys only through the mask, so an utterance
    served at its bucket gets the tokens of recognize_greedy on it padded
    to the largest bucket. (Against the unpadded utterance the frame
    count may differ: frame stacking keeps min(ceil(T / k), T_pad // k)
    frames, in JAX too.)"""
    jcfg, tcfg = _cfgs()
    params = params_from_numpy(_walking(_jax_params(jcfg, seed=3), jcfg))
    rng = np.random.default_rng(9)
    utts = [(3.0 * rng.normal(size=(T, SMALL["input_dim"]))).astype(
        np.float32) for T in (5, 13, 21, 30, 45)]
    eng = BatchingEngine(params, tcfg, max_symbols=MAX_SYMBOLS,
                         frame_buckets=(16, 32, 48), max_batch=4,
                         window_ms=1.0, device="cpu")
    emitted = 0
    try:
        for u in utts:
            padded = np.zeros((1, 48, SMALL["input_dim"]), np.float32)
            padded[0, :len(u)] = u
            tok, n = recognize_greedy(params, tcfg, torch.from_numpy(padded),
                                      torch.tensor([len(u)]),
                                      max_symbols=MAX_SYMBOLS)
            want = tok[0, :n[0]].tolist()
            assert eng.submit(u) == want
            emitted += len(want)
    finally:
        eng.close()
    assert emitted > 0


def _sigmoid_cases():
    rng = np.random.default_rng(11)
    return [(3 * rng.normal(size=4096)).astype(np.float32) for _ in range(2)]


def test_bf16_silu_and_glu_round_as_jax():
    """At bf16 jax.nn.sigmoid lowers to 1 / (1 + exp(-x)), each op rounding
    to bf16; the port's silu and GLU give those bits (torch.sigmoid, which
    rounds once, differs on about a third of the inputs)."""
    a, b = _sigmoid_cases()
    ja, jb_ = (jnp.asarray(v).astype(jnp.bfloat16) for v in (a, b))
    ta, tb = (torch.from_numpy(v).to(torch.bfloat16) for v in (a, b))
    for got, want in ((tcf._silu(ta), jax.nn.silu(ja)),
                      (ta * tcf._sigmoid(tb), ja * jax.nn.sigmoid(jb_))):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


SERVED_SYMBOLS = 100  # serve.py's max_symbols
# A bf16 greedy decision may go either way where the top two logits are
# closer than the encoder's bf16 noise (f32 sums in another order flip a
# bf16 rounding now and then): about one bf16 ulp at |logit| ~ 1.
NEAR_TIE = 1e-2


def test_bf16_greedy_tokens_match_jax_at_the_served_width():
    """recognize_greedy at bf16 on libri100_conformer's width (d 512, 8
    heads, FFN x4, conv 15, 4x stacking, V 1024), two blocks instead of
    eight, the same weights on both sides, four utterances padded to the
    800-frame bucket. Every row's tokens and frames equal JAX's up to the
    first decision whose top two JAX logits are a near-tie; at least half
    the rows equal throughout."""
    fields = {k: (tuple(v) if isinstance(v, list) else v) for k, v in
              dataclasses.asdict(port_config.config_libri100_conformer())
              .items()}
    fields["enc_layers"] = 2
    jcfg = jax_config.TransducerConfig(**fields)
    tcfg = port_config.TransducerConfig(**fields)
    assert tcfg.compute_dtype == "bfloat16"
    p = jax.tree.map(np.copy, _jax_params(jcfg, seed=0))
    # the random model walks: its predictor moves the joint and blank wins
    # on some frames (as chip_smoke.py's conformer_serving_setup)
    p["joint"]["pred_proj"]["w"] *= 8.0
    p["joint"]["out"]["b"][jcfg.blank] += 1.2
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(4, 800, jcfg.input_dim)).astype(np.float32)
    lens = np.array([800, 600, 400, 150], np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    want = [np.asarray(a) for a in jax_recognize(
        jp, jcfg, jnp.asarray(feats), jnp.asarray(lens),
        max_symbols=SERVED_SYMBOLS, with_timestamps=True)[:3]]
    got = [a.numpy() for a in recognize_greedy(
        params_from_numpy(p), tcfg, torch.from_numpy(feats),
        torch.from_numpy(lens), max_symbols=SERVED_SYMBOLS,
        with_timestamps=True)[:3]]
    enc, _ = jm.encode(jp, jcfg, jnp.asarray(feats), jnp.asarray(lens))
    same = 0
    for b in range(4):
        w_seq = list(zip(want[0][b, :want[1][b]], want[2][b, :want[1][b]]))
        g_seq = list(zip(got[0][b, :got[1][b]], got[2][b, :got[1][b]]))
        if w_seq == g_seq:
            same += 1
            continue
        i = next((i for i, (x, y) in enumerate(zip(w_seq, g_seq)) if x != y),
                 min(len(w_seq), len(g_seq)))
        frame = min(s[i][1] for s in (w_seq, g_seq) if i < len(s))
        prefix = np.asarray([[int(t) for t, _ in w_seq[:i]]], np.int32)
        pred, _ = jm.predict(jp, jcfg, jnp.asarray(prefix.reshape(1, -1)))
        logits = np.asarray(jm.joint_step(jp, jcfg, enc[b:b + 1, frame],
                                          pred[:, -1]), np.float32)[0]
        top = np.sort(logits)[-2:]
        assert top[1] - top[0] < NEAR_TIE, (b, i, frame, top)
    assert same >= 2, same


def test_fused_greedy_decodes_the_conformer_output():
    """recognize_greedy_fused (K9's plain version on the CPU) looks only at
    the predictor, so it decodes a conformer's encoder output as the
    lock-step decoder does."""
    jcfg, tcfg = _cfgs(pred_hidden=128, embed_dim=128, joint_dim=128)
    assert gf.supported(tcfg)
    params = params_from_numpy(_walking(_jax_params(jcfg, seed=4), jcfg))
    feats, lens = _feats(seed=8, B=4, T=40, scale=3.0)
    f_tok, f_n = gf.recognize_greedy_fused(params, tcfg,
                                           torch.from_numpy(feats),
                                           torch.from_numpy(lens),
                                           MAX_SYMBOLS)
    g_tok, g_n = recognize_greedy(params, tcfg, torch.from_numpy(feats),
                                  torch.from_numpy(lens), MAX_SYMBOLS)
    assert torch.equal(f_tok, g_tok) and torch.equal(f_n, g_n)


# ------------------------------- training -------------------------------

# Losses: f32 sums in another order; params move by at most lr per step
# under Adam and differ where a gradient near zero is amplified by
# mu / sqrt(nu): bounded well below the lr of 1e-3. The exception is the
# attention's key bias: the softmax of each query is invariant to adding
# q . b_k to all its logits, so that gradient is zero in exact arithmetic
# and f32 rounding noise on either side, which Adam turns into steps of
# up to lr in either direction; it is held to 2 lr.
LR = 1e-3
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)
KEY_BIAS_TOL = dict(rtol=0, atol=2 * LR)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [random_batch(rng, 3, 16, 3, SMALL["input_dim"],
                         SMALL["vocab_size"]) for _ in range(n)]


def test_two_train_steps_match_jax():
    """A 2-step make_train_step trajectory, loss_impl="xla" on both sides:
    the losses and the params after each step."""
    jcfg, tcfg = _cfgs()
    tkw = dict(batch_size=3, learning_rate=LR, warmup_steps=1,
               total_steps=10, loss_impl="xla")
    jstate = jloop.init_train_state(jax.random.PRNGKey(0), jcfg,
                                    jax_config.TrainConfig(**tkw))
    params0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(jcfg, jax_config.TrainConfig(**tkw))
    tstate = tloop.init_train_state(None, tcfg, port_config.TrainConfig(**tkw),
                                    params=params_from_numpy(params0))
    tstep = tloop.make_train_step(tcfg, port_config.TrainConfig(**tkw))
    for batch in _batches(2):
        jstate, jinfo = jstep(jstate, *(jnp.asarray(a) for a in batch))
        tstate, tinfo = tstep(tstate, *(torch.from_numpy(a) for a in batch))
        assert int(tinfo["skipped_nonfinite"]) == 0
        np.testing.assert_allclose(float(tinfo["loss"]), float(jinfo["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        want = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jstate.params))
        got = jax.tree.leaves(params_to_numpy(tstate.params))
        assert len(got) == len(want)
        for a, (path, b) in zip(got, want):
            name = jax.tree_util.keystr(path)
            tol = KEY_BIAS_TOL if "['k']['b']" in name else PARAM_TOL
            np.testing.assert_allclose(a, b, **tol, err_msg=name)
