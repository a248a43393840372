"""The port's multi-blank transducer (`ops/rnnt_multiblank.py`, the
consumed-frames walk of `ops/duration_lattice.py`, its training step,
MWER, greedy decode and two data-parallel ranks) against the JAX
package's on the CPU, after tests/test_multiblank.py and
tests/test_ctc_multitask.py:32-54.

Inputs are seeded numpy draws. The loss within 1e-5 relative and its
gradients within 1e-5 of the largest (ragged lengths, a zero-frame row);
with no big blank it is the standard RNN-T loss; `loss_fn` (with and
without ctc_weight) and one `make_train_step` step against JAX's; the
routes and options the family refuses; greedy decode on a model made to
emit and jump (`family_params`): tokens, lengths, frames and t_over
equal, confidences within 1e-5, and a jump carried across chunk
boundaries. The helpers here serve tests/test_torch_tdt.py and
tests/test_torch_beam_duration.py too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import greedy as jgreedy
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import rnnt_multiblank as jmb
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu.train import mwer as jmwer
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.decode import greedy as tgreedy
from rnn_transducer_tpu_torch.decode import greedy_fused
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import rnnt_multiblank as tmb
from rnn_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train import mwer as tmwer
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

NEG_INF = -1.0e30
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)
SMALL = dict(input_dim=4, enc_layers=1, enc_hidden=16, time_reduction=1,
             pred_layers=1, pred_hidden=16, embed_dim=8, joint_dim=16,
             vocab_size=6, compute_dtype="float32")
# The families of the decode and training tests, and the recipe that
# makes a random model of each emit and jump on a random encoder output:
# (family fields, JAX init seed, blank bias, encoder output scale).
FAMILIES = {
    "multiblank": (dict(big_blank_durations=(2, 4)), 7, 2.0, 2.0),
    "tdt": (dict(tdt_durations=(0, 1, 2, 4)), 4, 2.0, 2.0),
    "tdt_no_zero": (dict(tdt_durations=(1, 2)), 6, 0.0, 2.0),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def configs(family, **kw):
    fields = {**SMALL, **FAMILIES[family][0], **kw}
    return (jax_config.TransducerConfig(**fields),
            port_config.TransducerConfig(**fields))


def family_params(family, **kw):
    """JAX's init with a decisive joint: the output layers (and the TDT
    duration head) N(0, 1) with zero bias but the blank's, the
    predictor's input weights x8 and its projection x10, so that labels
    change the predictor's side and a frame's argmax moves between
    blank, jumps and labels."""
    jcfg, _ = configs(family, **kw)
    _, seed, blank, _ = FAMILIES[family]
    p = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(seed),
                                              jcfg))
    rng = np.random.default_rng(seed)
    for k in ("out", "dur"):
        if k in p["joint"]:
            p["joint"][k]["w"] = rng.normal(
                size=p["joint"][k]["w"].shape).astype(np.float32)
            p["joint"][k]["b"] = np.zeros_like(p["joint"][k]["b"])
    p["joint"]["out"]["b"][jcfg.blank] += blank
    p["predictor"][0]["w_ih"] *= 8
    p["joint"]["pred_proj"]["w"] *= 10
    return p


def encoder_output(family, B=4, T=16):
    """(enc_out (B, T, De), enc_lens (B,)) of the family's recipe: a
    full row, two shorter ones and a zero-length row."""
    rng = np.random.default_rng(FAMILIES[family][1])
    scale = FAMILIES[family][3]
    enc = (scale * rng.normal(size=(B, T, SMALL["enc_hidden"]))).astype(
        np.float32)
    return enc, np.array([T, T - 3, 0, T // 2 - 1], np.int32)[:B]


def train_batch(seed, B=4, T=12, U=4):
    """random_batch's features and labels with ragged lengths, a
    zero-frame row among them."""
    feats, fl, labels, ll = random_batch(np.random.default_rng(seed), B, T,
                                         U, SMALL["input_dim"],
                                         SMALL["vocab_size"])
    fl = np.array([T, T - 3, 0, T - 5], np.int32)[:B]
    ll = np.array([U, U - 2, 1, U - 1], np.int32)[:B]
    return feats, fl, labels, ll


def port_loss_and_grads(fn, p_np, *args, **kw):
    """(loss, per-utterance losses, the gradient of every params leaf)."""
    params = params_from_numpy(p_np)
    leaves, _ = torch.utils._pytree.tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, per_utt = fn(params, *args, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (float(loss.detach()), per_utt.detach().numpy(),
            [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)])


def assert_grads_close(got, want):
    """Every gradient leaf within 1e-5 of the largest gradient value."""
    want = [np.asarray(w) for w in want]
    top = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-5 * top)


def loss_fn_matches_jax(family, ctc_weight, seed=3):
    """loss_fn of the port against JAX's: the loss, the per-utterance
    losses and every gradient leaf."""
    jcfg, cfg = configs(family, ctc_head=bool(ctc_weight))
    p_np = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))
    batch = train_batch(seed)

    def jfn(p):
        return jloop.loss_fn(p, jcfg, *(_j(a) for a in batch),
                             ctc_weight=ctc_weight)

    (want, want_pu), want_g = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, p_np))
    got, got_pu, grads = port_loss_and_grads(
        tloop.loss_fn, p_np, cfg, *(_t(a) for a in batch),
        ctc_weight=ctc_weight)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(got_pu, np.asarray(want_pu), **LOSS_TOL)
    if not ctc_weight:
        assert got_pu[2] == 0.0  # the zero-frame row
    assert_grads_close(grads, jax.tree.leaves(want_g))


def train_step_matches_jax(family, ctc_weight, seed=5):
    """One make_train_step step against JAX's (its auto route is xla on
    the CPU): the loss and every param after the clip and AdamW."""
    jcfg, cfg = configs(family, ctc_head=bool(ctc_weight))
    kw = dict(batch_size=4, learning_rate=1e-3, warmup_steps=1,
              total_steps=10, ctc_weight=ctc_weight)
    jstate = jloop.init_train_state(jax.random.PRNGKey(seed), jcfg,
                                    jax_config.TrainConfig(**kw))
    p0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(jcfg, jax_config.TrainConfig(**kw))
    tcfg = port_config.TrainConfig(**kw)
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(p0))
    step = tloop.make_train_step(cfg, tcfg, device="cpu")
    batch = train_batch(seed + 1)
    jstate, jinfo = jstep(jstate, *(_j(a) for a in batch))
    state, info = step(state, *(_t(a) for a in batch))
    assert int(info["skipped_nonfinite"]) == 0
    np.testing.assert_allclose(float(info["loss"]), float(jinfo["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(info["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=1e-4)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(state.params)),
            jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, b, err_msg=str(path), **PARAM_TOL)


def mwer_matches_jax(family, seed=1):
    """mwer_loss_fn over the family's live N-best against JAX's: the
    per-utterance risks within 1e-5 and the loss."""
    jcfg, cfg = configs(family)
    p_np = family_params(family)
    batch = train_batch(seed)
    kw = dict(beam=3, expansions=2, max_symbols=6)
    jloss, want = jax.jit(lambda p, *b: jmwer.mwer_loss_fn(
        p, jcfg, *b, nll_weight=0.5, **kw))(
        jax.tree.map(jnp.asarray, p_np), *(_j(a) for a in batch))
    loss, got = tmwer.mwer_loss_fn(params_from_numpy(p_np), cfg,
                                   *(_t(a) for a in batch), nll_weight=0.5,
                                   **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def greedy_matches_jax(family, max_symbols=10):
    """greedy_decode on the family's recipe against JAX's: tokens,
    lengths, frames and t_over equal, confidences within 1e-5. Returns
    the port's (tokens, lengths, state)."""
    jcfg, cfg = configs(family)
    p_np = family_params(family)
    enc, lens = encoder_output(family)
    want = jgreedy.greedy_decode(jax.tree.map(jnp.asarray, p_np), jcfg,
                                 _j(enc), _j(lens), max_symbols=max_symbols)
    got = tgreedy.greedy_decode(params_from_numpy(p_np), cfg, _t(enc),
                                _t(lens), max_symbols=max_symbols)
    (tok, n, st), (tok_w, n_w, st_w) = got, want
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_w))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_w))
    np.testing.assert_array_equal(st[3].numpy(), np.asarray(st_w[3]))
    np.testing.assert_array_equal(st[7].numpy(), np.asarray(st_w[7]))
    np.testing.assert_allclose(st[2].numpy(), np.asarray(st_w[2]),
                               atol=1e-5, rtol=0)
    return got


def chunked_greedy(family, chunk=2, max_symbols=10):
    """greedy_decode over `chunk`-frame pieces of the recipe's encoder
    output with the carried state, in the port and in JAX: both final
    results equal to the port's offline decode, and the t_over carried
    at each boundary equal. Returns the carried t_over a chunk."""
    jcfg, cfg = configs(family)
    p_np = family_params(family)
    enc, lens = encoder_output(family)
    params, jp = params_from_numpy(p_np), jax.tree.map(jnp.asarray, p_np)
    tok_o, n_o, st_o = tgreedy.greedy_decode(params, cfg, _t(enc), _t(lens),
                                             max_symbols=max_symbols)
    state = jstate = None
    overs = []
    for c0 in range(0, enc.shape[1], chunk):
        cl = np.clip(lens - c0, 0, chunk).astype(np.int32)
        piece = enc[:, c0:c0 + chunk]
        tok, n, state = tgreedy.greedy_decode(params, cfg, _t(piece), _t(cl),
                                              max_symbols, state)
        jtok, jn, jstate = jgreedy.greedy_decode(jp, jcfg, _j(piece), _j(cl),
                                                 max_symbols, jstate)
        np.testing.assert_array_equal(state[7].numpy(),
                                      np.asarray(jstate[7]))
        overs.append(state[7].numpy())
    np.testing.assert_array_equal(tok.numpy(), tok_o.numpy())
    np.testing.assert_array_equal(n.numpy(), n_o.numpy())
    np.testing.assert_array_equal(state[3].numpy(), st_o[3].numpy())
    np.testing.assert_array_equal(np.asarray(jtok), tok_o.numpy())
    return np.stack(overs)


# --------------------------------- the loss ---------------------------------

def _mb_case(durs, seed):
    rng = np.random.default_rng(seed)
    B, T, U, V = 5, 14, 5, 9
    logits = (2 * rng.normal(size=(B, T, U + 1, V + len(durs)))).astype(
        np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    fl = np.array([14, 11, 0, 3, 9], np.int32)
    ll = np.array([5, 3, 2, 5, 0], np.int32)
    return logits, labels, fl, ll


@pytest.mark.parametrize("durs", [(2,), (2, 4, 8)],
                         ids=["durs_2", "durs_2_4_8"])
@pytest.mark.parametrize("form", ["logits", "from_lp"])
def test_loss_and_gradients_match_jax(durs, form):
    """Ragged lengths, a zero-frame row (loss 0, no gradient), a row with
    more labels than frames at duration 1 (still feasible: a label a
    frame), a label-less row; weights on the rows so every row's gradient
    counts."""
    logits, labels, fl, ll = _mb_case(durs, len(durs))
    weights = np.arange(1, 6, dtype=np.float32)
    if form == "logits":
        inputs = (logits,)

        def jfn(x):
            return jmb.rnnt_loss_multiblank(x, labels, fl, ll, durs)

        def tfn(x):
            return tmb.rnnt_loss_multiblank(x, _t(labels), _t(fl), _t(ll),
                                            durs)
    else:
        V = logits.shape[-1] - len(durs)
        lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
        lp_blanks = np.stack([lp[..., c] for c in
                              (0,) + tuple(range(V, V + len(durs)))], -1)
        lp_y = np.take_along_axis(lp[:, :, :-1], labels[:, None, :, None],
                                  axis=-1)[..., 0]
        lp_y = np.concatenate([lp_y, np.full(lp_y.shape[:2] + (1,), NEG_INF,
                                             np.float32)], -1)
        inputs = (lp_blanks, lp_y)

        def jfn(a, b):
            return jmb.rnnt_loss_multiblank_from_lp(a, b, fl, ll, durs)

        def tfn(a, b):
            return tmb.rnnt_loss_multiblank_from_lp(a, b, _t(fl), _t(ll),
                                                    durs)
    want = np.asarray(jfn(*inputs))
    want_g = jax.grad(lambda *x: jnp.sum(jfn(*x) * weights),
                      argnums=tuple(range(len(inputs))))(*inputs)
    xs = [_t(x).clone().requires_grad_(True) for x in inputs]
    got = tfn(*xs)
    (got * _t(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert float(got[2].detach()) == 0.0
    assert_grads_close([x.grad for x in xs], want_g)
    assert all(float(x.grad[2].abs().max()) == 0.0 for x in xs)


def test_without_big_blanks_it_is_the_rnnt_loss():
    """No big blank: the consumed-frames walk is the standard lattice,
    loss and gradient (tests/test_multiblank.py:72)."""
    logits, labels, fl, ll = _mb_case((), 7)
    xs = [_t(logits).clone().requires_grad_(True) for _ in range(2)]
    got = tmb.rnnt_loss_multiblank(xs[0], _t(labels), _t(fl), _t(ll), ())
    want = rnnt_loss(xs[1], _t(labels), _t(fl), _t(ll))
    got.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5)
    assert_grads_close([xs[0].grad], [xs[1].grad.numpy()])


@pytest.mark.parametrize("durs, n", [((2, 4, 8), 0), ((3,), 9)])
def test_duration_table_matches_jax(durs, n):
    want = np.asarray(jmb.duration_table(6, durs, n))
    got = tmb.duration_table(6, durs, n, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("durs", [(1,), (2, 0), (4, -2)])
def test_big_blank_durations_must_exceed_one(durs):
    logits, labels, fl, ll = _mb_case(durs, 0)
    with pytest.raises(ValueError, match="must be > 1"):
        jmb.rnnt_loss_multiblank(logits, labels, fl, ll, durs)
    with pytest.raises(ValueError, match="must be > 1"):
        tmb.rnnt_loss_multiblank(_t(logits), _t(labels), _t(fl), _t(ll),
                                 durs)
    with pytest.raises(ValueError, match="must be > 1"):
        tmb.rnnt_loss_multiblank_from_lp(
            _t(logits[..., :len(durs) + 1]), _t(logits[..., 0]), _t(fl),
            _t(ll), durs)


# --------------------------------- training ---------------------------------

@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_loss_fn_matches_jax(ctc_weight):
    loss_fn_matches_jax("multiblank", ctc_weight)


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_train_step_matches_jax(ctc_weight):
    train_step_matches_jax("multiblank", ctc_weight)


@pytest.mark.parametrize("family", ["multiblank", "tdt"])
@pytest.mark.parametrize("loss_impl", ["fused", "pallas", "pruned", "ar"])
def test_other_routes_raise(family, loss_impl):
    """The family trains at the xla tier alone: loss_fn and
    make_train_step refuse any other route (auto is xla, on the card
    too)."""
    _, cfg = configs(family)
    with pytest.raises(ValueError, match="loss_impl='auto'\\|'xla'"):
        tloop.loss_fn({}, cfg, *(_t(a) for a in train_batch(0)),
                      loss_impl=loss_impl)
    tkw = (dict(ar_range=3) if loss_impl == "ar"
           else dict(loss_impl=loss_impl))
    with pytest.raises(ValueError, match="loss_impl='auto'\\|'xla'"):
        tloop.make_train_step(cfg, port_config.TrainConfig(**tkw),
                              device="cpu")


@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_fastemit_raises(family):
    _, cfg = configs(family)
    with pytest.raises(ValueError, match="fastemit_lambda is not supported"):
        tloop.loss_fn({}, cfg, *(_t(a) for a in train_batch(0)),
                      fastemit=0.01)
    with pytest.raises(ValueError, match="fastemit_lambda is not supported"):
        tloop.make_train_step(
            cfg, port_config.TrainConfig(fastemit_lambda=0.01), device="cpu")


def test_mwer_loss_fn_matches_jax():
    mwer_matches_jax("multiblank")


# ---------------------------------- decode ----------------------------------

def test_greedy_matches_jax():
    tok, n, st = greedy_matches_jax("multiblank")
    assert int(n.sum()) > 0  # the recipe emits


def test_streaming_jumps_across_chunk_boundaries():
    """Two-frame chunks: a big blank of duration 4 jumps past a chunk's
    end, and the overshoot (t_over) rides into the next chunk."""
    overs = chunked_greedy("multiblank")
    assert overs.max() > 0


@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_fused_greedy_refuses_duration_families(family):
    """K9 advances one frame a blank and has no duration head: its
    predicate refuses both families at widths it takes otherwise."""
    wide = dict(embed_dim=128, pred_hidden=128, joint_dim=128)
    _, cfg = configs(family, **wide)
    assert not greedy_fused.supported(cfg)
    assert greedy_fused.supported(dataclasses.replace(
        cfg, big_blank_durations=(), tdt_durations=()))
    with pytest.raises(ValueError):
        greedy_fused.recognize_greedy_fused(
            tm.init_params(cfg, np.random.default_rng(0), device="cpu"), cfg,
            torch.zeros(1, 4, SMALL["input_dim"]),
            torch.ones(1, dtype=torch.int32))


# ----------------------------- data parallelism -----------------------------

def _dp_train(mesh, family, params_np, batches):
    """Two steps of make_train_step on `mesh` (None: one process)."""
    _, cfg = configs(family)
    tcfg = port_config.TrainConfig(batch_size=8, learning_rate=1e-3,
                                   warmup_steps=1, total_steps=100)
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params_np))
    if mesh is not None:
        state = dataclasses.replace(
            state, params=meshlib.replicate(mesh, state.params),
            opt_state=meshlib.replicate(mesh, state.opt_state))
    step = tloop.make_train_step(cfg, tcfg, mesh=mesh, device="cpu")
    losses = []
    for batch in batches:
        batch = (tuple(torch.from_numpy(a) for a in batch) if mesh is None
                 else meshlib.shard_batch(mesh, batch))
        state, info = step(state, *batch)
        assert int(info["skipped_nonfinite"]) == 0
        losses.append(float(info["loss"]))
    return losses, params_to_numpy(state.params)


@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_two_ranks_match_one_process(family, tmp_path):
    """Two gloo ranks (this process and a spawned worker) on halves of
    the batch: one process's losses within 1e-5 relative and its params
    within 2e-5 relative / 2e-6 absolute after two steps."""
    _, cfg = configs(family)
    params_np = params_to_numpy(tm.init_params(cfg, np.random.default_rng(3),
                                               device="cpu"))
    rng = np.random.default_rng(7)
    batches = [random_batch(rng, 8, 12, 4, SMALL["input_dim"],
                            SMALL["vocab_size"]) for _ in range(2)]
    want = _dp_train(None, family, params_np, batches)
    losses, params = meshlib.spawn(
        _dp_train, 2, ["cpu", "cpu"], args=(family, params_np, batches),
        init_method=f"file://{tmp_path}/rendezvous")
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(params), leaves(want[1])):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
