"""MWER sequence training in the port (`train/mwer.py`,
`make_train_step(loss_kind="mwer")`, the training CLI's --mwer-steps) on
the CPU, after tests/test_mwer.py.

The edit distance on the device against the host's dynamic programme
(exact integers); the risk over a fixed list against a hand computation;
`mwer_loss_fn` against JAX's: the same N-best tokens from the two beam
searches and the risk within 1e-5 relative, with and without the NLL
term; a 2-step trajectory against JAX's at tests/test_torch_train.py's
tolerances; the risk falls on a toy task; the guards; the CLI's MWER
phase. All f32.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import beam as jbeam
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu.train import mwer as jmwer
from rnn_transducer_tpu_torch.decode.beam import beam_search
from rnn_transducer_tpu_torch.decode.metrics import edit_distance
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train import mwer
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

SMALL = dict(enc_layers=1, enc_hidden=16, pred_layers=1, pred_hidden=16,
             embed_dim=8, joint_dim=16, vocab_size=6, input_dim=4,
             compute_dtype="float32")
CFG = port_config.TransducerConfig(**SMALL)
JCFG = jax_config.TransducerConfig(**SMALL)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_train.py's
PARAM_TOL = dict(rtol=0, atol=2e-6)


def _params_np(jcfg, seed):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))


def _batch(seed, B=4, T=7, U=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, 4)).astype(np.float32),
            np.maximum(T - rng.integers(0, 3, size=B), 1).astype(np.int32),
            rng.integers(1, 6, size=(B, U)).astype(np.int32),
            rng.integers(0, U + 1, size=B).astype(np.int32))


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def test_device_edit_distance_matches_host():
    """40 random pairs in one batched call, zero lengths among them."""
    rng = np.random.default_rng(0)
    N, Ur, Uh = 40, 8, 9
    ref = rng.integers(0, 4, size=(N, Ur)).astype(np.int32)
    hyp = rng.integers(0, 4, size=(N, Uh)).astype(np.int32)
    rl = rng.integers(0, Ur + 1, size=N).astype(np.int32)
    hl = rng.integers(0, Uh + 1, size=N).astype(np.int32)
    rl[:2], hl[1:3] = 0, 0
    got = mwer.edit_distance_device(*_t((ref, rl, hyp, hl)))
    assert got.dtype == torch.int32
    want = [edit_distance(ref[i, :rl[i]].tolist(), hyp[i, :hl[i]].tolist())
            for i in range(N)]
    assert got.tolist() == want


def test_risk_value_matches_hand_computation():
    """The risk over two valid hypotheses and a dead one, by hand: each
    hypothesis's -rnnt_loss, renormalized, times its edit count; the
    gradient finite and nonzero."""
    params = params_from_numpy(_params_np(JCFG, 0))
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(1, 5, 4)).astype(np.float32))
    feat_lens = torch.tensor([5], dtype=torch.int32)
    enc_out, enc_lens = tm.encode(params, CFG, feats, feat_lens)
    labels = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    label_lens = torch.tensor([3], dtype=torch.int32)
    hyps = torch.tensor([[[1, 2, 3, 0], [1, 2, 0, 0], [2, 2, 3, 1]]],
                        dtype=torch.int32)
    hyp_lens = torch.tensor([[3, 2, 4]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False]])
    loss, per_utt = mwer.mwer_loss_from_hyps(
        params, CFG, enc_out, enc_lens, hyps, hyp_lens, valid, labels,
        label_lens)
    logp = []
    for k in range(2):
        hy = hyps[0, k][None]
        pred, _ = tm.predict(params, CFG, hy)
        logp.append(-float(rnnt_loss(tm.joint(params, CFG, enc_out, pred),
                                     hy, enc_lens, hyp_lens[0, k][None])[0]))
    p = np.exp(np.asarray(logp) - np.logaddexp(*logp))
    w = [edit_distance([1, 2, 3], hyps[0, k, :int(hyp_lens[0, k])].tolist())
         for k in range(2)]
    want = float(np.sum(p * np.asarray(w, np.float64)))
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    np.testing.assert_allclose(float(per_utt[0]), want, rtol=1e-5)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [x.requires_grad_(True) for x in leaves]
    p2 = torch.utils._pytree.tree_unflatten(leaves, spec)
    risk, _ = mwer.mwer_loss_from_hyps(
        p2, CFG, tm.encode(p2, CFG, feats, feat_lens)[0], enc_lens, hyps,
        hyp_lens, valid, labels, label_lens)
    grads = torch.autograd.grad(risk, leaves, allow_unused=True)
    gn = float(torch.sqrt(sum((g * g).sum() for g in grads
                              if g is not None)))
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("nll_weight, seed", [(0.0, 1), (0.5, 2)])
def test_mwer_loss_matches_jax(nll_weight, seed):
    """The same N-best from the port's and JAX's beam searches (tokens,
    lengths, live scores within 1e-4), and the risk within 1e-5."""
    p_np = _params_np(JCFG, seed)
    batch = _batch(seed)
    jp = jax.tree.map(jnp.asarray, p_np)
    jb = tuple(jnp.asarray(x) for x in batch)
    kw = dict(beam=3, expansions=2, max_symbols=6)

    @jax.jit
    def jax_side(p, *b):
        enc, enc_lens = jm.encode(p, JCFG, b[0], b[1])
        return (jbeam.beam_search(p, JCFG, enc, enc_lens, **kw)[:3],
                jmwer.mwer_loss_fn(p, JCFG, *b, nll_weight=nll_weight, **kw))
    want_h, (jloss, want) = jax_side(jp, *jb)
    pp = params_from_numpy(p_np)
    with torch.no_grad():
        enc_t, lens_t = tm.encode(pp, CFG, *_t(batch[:2]))
        got_h = beam_search(pp, CFG, enc_t, lens_t, **kw)
    for g, w in zip(got_h[:2], want_h[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = np.asarray(want_h[2]) > mwer.NEG_INF / 2
    np.testing.assert_array_equal(got_h[2].numpy() > mwer.NEG_INF / 2, live)
    np.testing.assert_allclose(got_h[2].numpy()[live],
                               np.asarray(want_h[2])[live], atol=1e-4)
    loss, got = mwer.mwer_loss_fn(pp, CFG, *_t(batch),
                                  nll_weight=nll_weight, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_two_step_trajectory_matches_jax():
    tkw = dict(batch_size=4, learning_rate=1e-3, warmup_steps=1,
               total_steps=10, mwer_beam=3, mwer_max_symbols=6,
               mwer_nll_weight=0.1)
    jtcfg = jax_config.TrainConfig(**tkw)
    jstate = jloop.init_train_state(jax.random.PRNGKey(3), JCFG, jtcfg)
    p0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(JCFG, jtcfg, loss_kind="mwer")
    batches = [_batch(30 + i) for i in range(2)]
    want = []
    for b in batches:
        jstate, info = jstep(jstate, *(jnp.asarray(x) for x in b))
        want.append(float(info["loss"]))
    tcfg = port_config.TrainConfig(**tkw)
    state = tloop.init_train_state(None, CFG, tcfg,
                                   params=params_from_numpy(p0))
    step = tloop.make_train_step(CFG, tcfg, device="cpu", loss_kind="mwer")
    got = []
    for b in batches:
        state, info = step(state, *_t(b))
        assert int(info["skipped_nonfinite"]) == 0
        got.append(float(info["loss"]))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jstate.params))):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_mwer_finetune_reduces_risk_on_toy_task():
    """tests/test_mwer.py's toy task (features that spell their labels),
    from JAX's initial params: 220 NLL steps with noise, then MWER on a
    fixed batch, whose expected edit count collapses (0.39 -> 0.06 in 30
    steps on the CPU; the JAX test's 0.39 -> 0.02 in 80)."""
    T_, U_, V_ = 16, 4, 6
    kw = dict(input_dim=V_, enc_layers=1, enc_hidden=32, pred_layers=1,
              pred_hidden=32, embed_dim=16, joint_dim=32, vocab_size=V_,
              compute_dtype="float32")
    cfg = port_config.TransducerConfig(**kw)
    tcfg = port_config.TrainConfig(batch_size=8, learning_rate=5e-3,
                                   warmup_steps=30, total_steps=700,
                                   loss_impl="xla", mwer_beam=3,
                                   mwer_expansions=2, mwer_max_symbols=8)
    p0 = _params_np(jax_config.TransducerConfig(**kw), 0)
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(p0))
    step = tloop.make_train_step(cfg, tcfg, device="cpu")
    mwer_step = tloop.make_train_step(cfg, tcfg, device="cpu",
                                      loss_kind="mwer")

    def toy(rng, n, noise):
        feats = np.zeros((n, T_, V_), np.float32)
        labels = rng.integers(1, V_, size=(n, U_)).astype(np.int32)
        for i in range(n):
            for u in range(U_):
                feats[i, 4 * u: 4 * u + 4, labels[i, u]] = 1.0
        feats += rng.normal(scale=noise, size=feats.shape).astype(np.float32)
        return torch.from_numpy(feats), torch.from_numpy(labels)

    rng = np.random.default_rng(7)
    fl = torch.full((8,), T_, dtype=torch.int32)
    ll = torch.full((8,), U_, dtype=torch.int32)
    for _ in range(220):
        feats, labels = toy(rng, 8, noise=0.5)
        state, info = step(state, feats, fl, labels, ll)
    assert np.isfinite(float(info["loss"]))
    feats, labels = toy(rng, 8, noise=0.5)
    risks = []
    for _ in range(30):
        state, info = mwer_step(state, feats, fl, labels, ll)
        risks.append(float(info["loss"]))
    assert np.isfinite(risks).all()
    assert risks[0] > 0.05, f"toy task too easy for MWER ({risks[0]})"
    assert np.mean(risks[-5:]) < 0.3 * risks[0], (risks[0], risks[-5:])


@pytest.mark.parametrize("kind, cfg_kw, err, match", [  # stable ids
    pytest.param("sequence", {}, ValueError, "unknown loss_kind",
                 id="sequence-cfg_kw1-ValueError-unknown loss_kind"),
])
def test_mwer_guards(kind, cfg_kw, err, match):
    cfg = port_config.TransducerConfig(**{**SMALL, **cfg_kw})
    with pytest.raises(err, match=match):
        tloop.make_train_step(cfg, port_config.TrainConfig(), device="cpu",
                              loss_kind=kind)


def test_train_cli_mwer_phase(tmp_path, capsys):
    """--mwer-steps 2 of --steps 4: the last two steps are MWER's, with
    the optimizer state of the first two."""
    log = tmp_path / "log.jsonl"
    res = train_main(["--config", "smoke", "--steps", "4", "--batch-size",
                      "2", "--mwer-steps", "2", "--mwer-beam", "2",
                      "--mwer-nll-weight", "0.1", "--log-every", "1",
                      "--eval-every", "0", "--max-frames", "24",
                      "--max-labels", "4", "--log-file", str(log),
                      "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["steps"] == 4 and np.isfinite(last["final_loss"])
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["phase"] for r in recs] == ["rnnt", "rnnt", "mwer", "mwer"]
    assert res.step == 4 and res.opt_state["count"] == 4
