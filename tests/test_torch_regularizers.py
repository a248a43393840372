"""The port's training regularizers against the JAX package's, on the CPU.

Each JAX draw comes from a threefry key the port does not reproduce, so
the draws cross over: JAX's SpecAugment, time-warp and speed-perturb
draws go into the port's apply functions (within 1e-6 of JAX's
transforms), JAX's dropout masks into the port's dropout sites (loss and
gradients of `loss_fn` equal JAX's), JAX's weight noise, leaf by leaf
path, into the port's step (a 2-step trajectory equal to JAX's). The EMA
follows JAX's `make_train_step` over 3 f32 steps (also under grad_accum=2
and across a skipped step), the trainer's dev loss and PER equal JAX's
run_eval on the same params, one process equals two gloo ranks with every
regularizer on, checkpoints carry the EMA (and load without one), and the
decode CLI and the server decode it under --use-ema.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.data import augment as jaug
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch import recognize as rec
from rnn_transducer_tpu_torch import serve as srv
from rnn_transducer_tpu_torch.data import augment as aug
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train import regularizers as reg
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

TINY = dict(input_dim=8, enc_layers=3, enc_hidden=16, time_reduction=2,
            pred_layers=2, pred_hidden=12, embed_dim=8, joint_dim=16,
            vocab_size=21, compute_dtype="float32")
AUG_TOL = dict(rtol=0, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)


def _feats(B=4, T=60, F=10, lens=(60, 45, 20, 3), seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, T, F)) + 5.0).astype(np.float32)
    return x, np.asarray(lens, np.int32)


# ------------------------------ augmentation ------------------------------

@pytest.mark.parametrize("warp", [0, 10])
def test_spec_augment_with_jax_draws_equals_jax(warp):
    x, lens = _feats()
    B, _, F = x.shape
    key = jax.random.PRNGKey(7)
    want = np.asarray(jaug.spec_augment(key, jnp.asarray(x),
                                        jnp.asarray(lens),
                                        time_warp_frames=warp))
    k = jax.random.split(key, 5)  # jaug.spec_augment's draws, in order
    draws = {"tw": jax.random.randint(k[0], (B, 2), 0, 21),
             "u": jax.random.uniform(k[1], (B, 2)),
             "fw": jax.random.randint(k[2], (B, 2), 0, 16),
             "fs": jax.random.randint(k[3], (B, 2), 0, max(F - 15, 1))}
    if warp:
        k1, k2 = jax.random.split(k[4])
        draws["warp_u"] = jax.random.uniform(k1, (B,))
        draws["warp_d"] = jax.random.uniform(k2, (B,), minval=-float(warp),
                                             maxval=float(warp))
    draws = {n: torch.tensor(np.asarray(v)) for n, v in draws.items()}
    got = aug.apply_spec_augment(torch.from_numpy(x), torch.from_numpy(lens),
                                 draws, time_warp_frames=warp)
    np.testing.assert_allclose(got.numpy(), want, **AUG_TOL)
    assert (want == 0.0).any()


def test_time_warp_with_jax_draws_equals_jax_and_keeps_the_ends():
    x, lens = _feats()
    key = jax.random.PRNGKey(3)
    want = np.asarray(jaug._time_warp(key, jnp.asarray(x), jnp.asarray(lens),
                                      10))
    k1, k2 = jax.random.split(key)
    u = torch.from_numpy(np.asarray(jax.random.uniform(k1, (4,))))
    d = torch.from_numpy(np.asarray(jax.random.uniform(
        k2, (4,), minval=-10.0, maxval=10.0)))
    got = aug.apply_time_warp(torch.from_numpy(x), torch.from_numpy(lens),
                              u, d, 10).numpy()
    np.testing.assert_allclose(got, want, **AUG_TOL)
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, 0], x[b, 0], rtol=1e-6)
        np.testing.assert_allclose(got[b, L - 1], x[b, L - 1], rtol=1e-6)
        np.testing.assert_array_equal(got[b, L:], x[b, L:])
    np.testing.assert_array_equal(got[2:], x[2:])  # len <= 2W: untouched
    # the port's own draws: a row long enough moves, and stays finite
    own = aug.spec_augment(torch.Generator().manual_seed(0),
                           torch.from_numpy(x), torch.from_numpy(lens),
                           time_warp_frames=10, n_time_masks=0,
                           n_freq_masks=0).numpy()
    assert np.isfinite(own).all() and not np.allclose(own[0], x[0])


def test_time_warp_degenerate_lengths_are_left_alone():
    x = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    lens = torch.tensor([1, 2], dtype=torch.int32)
    out = aug.apply_time_warp(torch.from_numpy(x), lens,
                              torch.tensor([0.3, 0.9]),
                              torch.tensor([-3.0, 2.5]), 4).numpy()
    np.testing.assert_array_equal(out, x)


def test_speed_perturb_with_jax_draws_equals_jax():
    x, lens = _feats(B=6, lens=(60, 45, 20, 3, 1, 0))
    factors = (0.9, 1.0, 1.1)
    key = jax.random.PRNGKey(11)
    wf, wl = jaug.speed_perturb(key, jnp.asarray(x), jnp.asarray(lens),
                                factors)
    idx = torch.from_numpy(np.asarray(jax.random.randint(key, (6,), 0, 3)))
    gf, gl = aug.apply_speed_perturb(torch.from_numpy(x),
                                     torch.from_numpy(lens), idx, factors)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), **AUG_TOL)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert gl.dtype == torch.int32


def test_speed_perturb_at_one_is_the_identity():
    x, lens = _feats(B=4, lens=(60, 45, 20, 0))
    xt = torch.from_numpy(x)
    xt[:, :, :] = torch.where(
        torch.arange(60)[None, :, None] < torch.from_numpy(lens)[:, None,
                                                                None],
        xt, 0.0)
    out, nl = aug.speed_perturb(torch.Generator().manual_seed(1), xt,
                                torch.from_numpy(lens), factors=(1.0,))
    assert torch.equal(out, xt) and torch.equal(nl, torch.from_numpy(lens))


# -------------------------------- dropout ---------------------------------

def _jax_masks(key, B, rate):
    """A mask source giving JAX's `_dropout` masks: per row keys
    fold_in(key, row), per site fold_in(row key, site)."""
    rngs = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.arange(B))

    def drop(site, x, keep):
        mask = jax.vmap(lambda k: jax.random.bernoulli(
            jax.random.fold_in(k, site), keep, tuple(x.shape[1:])))(rngs)
        return torch.from_numpy(np.asarray(mask))
    return drop


def _loss_and_grads_port(cfg, p, batch, **kw):
    params = params_from_numpy(p)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    loss, grads = tloop.loss_and_grads(leaves, spec, cfg, *batch,
                                       loss_impl="xla", **kw)
    return float(loss), params_to_numpy(
        torch.utils._pytree.tree_unflatten(grads, spec))


@pytest.mark.parametrize("bidirectional", [False, True])
def test_dropout_with_jax_masks_equals_jax(bidirectional):
    cfg_kw = {**TINY, "bidirectional": bidirectional}
    jcfg = jax_config.TransducerConfig(**cfg_kw)
    cfg = port_config.TransducerConfig(**cfg_kw)
    from rnn_transducer_tpu.models import transducer as jm
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1), jcfg))
    batch = random_batch(np.random.default_rng(4), 3, 14, 4, 8, 21)
    key = jax.random.PRNGKey(5)
    (wl, _), wg = jax.value_and_grad(
        lambda q: jloop.loss_fn(q, jcfg, *(jnp.asarray(a) for a in batch),
                                loss_impl="xla", dropout=0.3,
                                embed_dropout=0.2, dropout_rng=key),
        has_aux=True)(jax.tree.map(jnp.asarray, p))
    tb = tuple(torch.from_numpy(a) for a in batch)
    gl, gg = _loss_and_grads_port(cfg, p, tb, dropout=0.3,
                                  embed_dropout=0.2,
                                  drop=_jax_masks(key, 3, 0.3))
    np.testing.assert_allclose(gl, float(wl), **LOSS_TOL)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(gg),
                            jax.tree.leaves(jax.tree.map(np.asarray, wg))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))
    # without dropout the loss differs: the masks took effect
    clean, _ = _loss_and_grads_port(cfg, p, tb)
    assert abs(clean - gl) > 1e-3


def test_dropout_rate_zero_and_no_mask_source_are_no_ops():
    cfg = port_config.TransducerConfig(**TINY)
    from rnn_transducer_tpu_torch.models import transducer as tm
    p = params_to_numpy(tm.init_params(cfg, np.random.default_rng(0), "cpu"))
    tb = tuple(torch.from_numpy(a) for a in random_batch(
        np.random.default_rng(4), 3, 14, 4, 8, 21))
    clean = _loss_and_grads_port(cfg, p, tb)
    masks = reg.DropoutMasks(seed=0, step=0)
    for kw in (dict(dropout=0.0, embed_dropout=0.0, drop=masks),
               dict(dropout=0.5, embed_dropout=0.5, drop=None)):
        got = _loss_and_grads_port(cfg, p, tb, **kw)
        assert got[0] == clean[0]
        for a, b in zip(jax.tree.leaves(got[1]), jax.tree.leaves(clean[1])):
            np.testing.assert_array_equal(a, b)
    dropped = _loss_and_grads_port(cfg, p, tb, dropout=0.5,
                                   embed_dropout=0.5, drop=masks)
    assert dropped[0] != clean[0]


def test_dropout_masks_are_per_global_row():
    """Rows 2..3 of a global batch of 4 draw the masks that one process
    draws for them: a rank's mask depends on the row, not on the rank."""
    x = torch.zeros(4, 7, 5)
    whole = reg.DropoutMasks(3, 9, 0, 4)(1001, x, 0.7)
    part = reg.DropoutMasks(3, 9, 2, 4)(1001, x[2:], 0.7)
    assert torch.equal(whole[2:], part)
    assert not torch.equal(whole, reg.DropoutMasks(3, 10, 0, 4)(1001, x,
                                                                0.7))
    assert not torch.equal(whole, reg.DropoutMasks(3, 9, 0, 4)(0, x, 0.7))


# ---------------------- weight noise, EMA: trajectories ----------------------

def _jax_path(path) -> str:
    return "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                   for k in path)


def _jax_noise(seed, step, params):
    """JAX's Graves noise of a step (train/loop.py :486-497), by path."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5EED), step)
    with_paths = jax.tree_util.tree_flatten_with_path(params)[0]
    keys = jax.random.split(key, len(with_paths))
    return {_jax_path(path): np.asarray(jax.random.normal(k, leaf.shape,
                                                          leaf.dtype))
            for (path, leaf), k in zip(with_paths, keys)}


def _batches(n, seed=0, nan_at=None):
    rng = np.random.default_rng(seed)
    out = [random_batch(rng, 3, 12, 4, 8, 21) for _ in range(n)]
    if nan_at is not None:
        out[nan_at][0][0, 0, 0] = np.nan
    return out


def _trajectories(tcfg_kw, n, nan_at=None):
    """n steps of JAX's make_train_step (xla loss) and of the port's, from
    the same params; with weight noise the port's step takes JAX's."""
    jcfg = jax_config.TransducerConfig(**TINY)
    jtcfg = jax_config.TrainConfig(**tcfg_kw, loss_impl="xla")
    js = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    p0 = jax.tree.map(np.asarray, js.params)
    jstep = jloop.make_train_step(jcfg, jtcfg)
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(**tcfg_kw, loss_impl="xla")
    ps = tloop.init_train_state(None, cfg, tcfg, params=params_from_numpy(p0))

    def noise_fn(step, paths, leaves):
        z = _jax_noise(tcfg.seed, step, p0)
        return [torch.from_numpy(z[path]) for path in paths]

    pstep = tloop.make_train_step(cfg, tcfg, noise_fn=noise_fn)
    jl, pl, skipped = [], [], []
    for batch in _batches(n, nan_at=nan_at):
        js, jinfo = jstep(js, *(jnp.asarray(a) for a in batch))
        ps, pinfo = pstep(ps, *(torch.from_numpy(a) for a in batch))
        jl.append(float(jinfo["loss"]))
        pl.append(float(pinfo["loss"]))
        skipped.append((int(jinfo["skipped_nonfinite"]),
                        int(pinfo["skipped_nonfinite"])))
    return js, ps, jl, pl, skipped, p0


def _assert_tree_close(got, want, **tol):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path),
                                   **tol)


def test_weight_noise_with_jax_noise_equals_jax():
    js, ps, jl, pl, _, p0 = _trajectories(
        dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
             weight_noise_std=0.05), 2)
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    _assert_tree_close(params_to_numpy(ps.params),
                       jax.tree.map(np.asarray, js.params), **PARAM_TOL)
    clean = _trajectories(dict(learning_rate=1e-3, warmup_steps=1,
                               total_steps=10), 2)[3]
    assert abs(clean[1] - pl[1]) > 1e-4  # the noise took effect


EMA_RUNS = {
    "plain": (dict(), None),
    "grad_accum2": (dict(grad_accum=2, lr_schedule="noam"), None),
    "skipped_step": (dict(), 1),
}


@pytest.mark.parametrize("run", sorted(EMA_RUNS))
def test_ema_follows_jax_make_train_step(run):
    kw, nan_at = EMA_RUNS[run]
    js, ps, jl, pl, skipped, p0 = _trajectories(
        dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
             ema_decay=0.9, **kw), 3, nan_at)
    assert [s[0] for s in skipped] == [s[1] for s in skipped]
    assert sum(s[1] for s in skipped) == (nan_at is not None)
    finite = [i for i in range(3) if i != nan_at]
    np.testing.assert_allclose([pl[i] for i in finite],
                               [jl[i] for i in finite], **LOSS_TOL)
    assert ps.ema is not None and js.ema is not None
    _assert_tree_close(params_to_numpy(ps.ema),
                       jax.tree.map(np.asarray, js.ema), rtol=0, atol=1e-6)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(params_to_numpy(ps.ema)), jax.tree.leaves(p0)))
    assert moved > 5e-5


def test_ema_starts_as_a_copy():
    cfg = port_config.TransducerConfig(**TINY)
    st = tloop.init_train_state(0, cfg, port_config.TrainConfig(
        ema_decay=0.9), device="cpu")
    for a, b in zip(*(torch.utils._pytree.tree_leaves(t)
                      for t in (st.ema, st.params))):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert tloop.init_train_state(0, cfg, port_config.TrainConfig(),
                                  device="cpu").ema is None


# ------------------------------ dev evaluation -----------------------------

def test_dev_eval_equals_jax_run_eval():
    """The trainer's run_eval (dev loss over the real rows, greedy PER) on
    a dev batch with 3 real rows of 4, against train.py's run_eval body on
    the same params."""
    from rnn_transducer_tpu.decode.greedy import recognize_greedy as jg
    from rnn_transducer_tpu.decode.metrics import (error_rate,
                                                   tokens_to_lists)
    from rnn_transducer_tpu.models import transducer as jm

    from rnn_transducer_tpu_torch.train import __main__ as cli

    jcfg = jax_config.TransducerConfig(**TINY)
    cfg = port_config.TransducerConfig(**TINY)
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(2), jcfg))
    dev = random_batch(np.random.default_rng(9), 4, 16, 4, 8, 21) + (3,)
    args = cli.parse_args(["--max-labels", "6"])
    got = cli._evaluator(args, cfg, port_config.TrainConfig(), dev,
                         "cpu")(params_from_numpy(p))
    jp = jax.tree.map(jnp.asarray, p)
    f, fl, lab, ll = (jnp.asarray(x) for x in dev[:4])
    _, per_utt = jloop.make_eval_step(jcfg)(jp, f, fl, lab, ll)
    toks, lens = jg(jp, jcfg, f, fl, max_symbols=12)
    want_per = error_rate(tokens_to_lists(lab[:3], ll[:3]),
                          tokens_to_lists(toks[:3], lens[:3]))
    np.testing.assert_allclose(got[0], float(jnp.mean(per_utt[:3])),
                               **LOSS_TOL)
    assert got[1] == want_per


# ------------------------------ two ranks ----------------------------------

def _corpus(tmp_path, n=12):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        t = int(rng.integers(20, 60))
        path = tmp_path / f"u{i}.npy"
        np.save(path, rng.normal(size=(t, 80)).astype(np.float32))
        recs.append({"feats": str(path), "labels": rng.integers(
            1, 32, size=int(rng.integers(2, 6))).tolist()})
    man = tmp_path / "m.jsonl"
    man.write_text("\n".join(json.dumps(r) for r in recs))
    return str(man)


def test_two_ranks_equal_one_process_with_every_regularizer(tmp_path,
                                                            capsys):
    """B=4 with speed perturbation, SpecAugment (warped), dropout, embed
    dropout, weight noise and EMA: the CLI on two gloo ranks against one
    process, 3 steps; the loss, params and EMA agree."""
    cfg = tmp_path / "smoke_f32.json"
    cfg.write_text(json.dumps(dict(
        enc_layers=2, enc_hidden=32, pred_layers=2, pred_hidden=32,
        embed_dim=16, joint_dim=32, vocab_size=32, input_dim=80,
        compute_dtype="float32")))
    man = _corpus(tmp_path)
    runs = {}
    for n in (1, 2):
        d = str(tmp_path / f"dp{n}")
        train_main(["--device", "cpu", "--config", str(cfg), "--data",
                    f"manifest:{man}", "--batch-size", "4", "--steps", "3",
                    "--warmup-steps", "1", "--log-every", "1",
                    "--eval-every", "0", "--ckpt-dir", d, "--seed", "3",
                    "--data-parallel", str(n), "--speed-perturb",
                    "0.9,1.0,1.1", "--spec-augment", "--spec-augment-warp",
                    "4", "--dropout", "0.2", "--embed-dropout", "0.1",
                    "--weight-noise", "0.01", "--ema-decay", "0.9"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[n] = out, ckpt.restore_checkpoint(d)[0]
    (o1, s1), (o2, s2) = runs[1], runs[2]
    assert o1["steps"] == o2["steps"] == 3
    np.testing.assert_allclose(o2["final_loss"], o1["final_loss"],
                               rtol=1e-4, atol=1e-4)  # printed to 4 places
    for t2, t1 in ((s2.params, s1.params), (s2.ema, s1.ema)):
        for a, b in zip(*(torch.utils._pytree.tree_leaves(t)
                          for t in (t2, t1))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=2e-6)


# --------------------------- checkpoints, --use-ema -------------------------

def _state(ema: bool):
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(ema_decay=0.9 if ema else 0.0)
    st = tloop.init_train_state(0, cfg, tcfg, device="cpu")
    if ema:
        st = dataclasses.replace(st, ema=torch.utils._pytree.tree_map(
            lambda t: t * 0.5, st.ema))
    return cfg, st


@pytest.mark.parametrize("ema", [False, True])
def test_checkpoint_round_trip_with_and_without_ema(ema, tmp_path):
    cfg, st = _state(ema)
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 5, st, model_cfg=cfg)
    got, step = ckpt.restore_checkpoint(d)
    assert step == 5 and (got.ema is None) == (not ema)
    for a, b in zip(torch.utils._pytree.tree_leaves(got.params),
                    torch.utils._pytree.tree_leaves(st.params)):
        assert torch.equal(a, b)
    params, cfg2, step2, _ = ckpt.load_plain_params(d, prefer_ema=ema)
    assert cfg2 == cfg and step2 == 5
    want = st.ema if ema else st.params
    for a, b in zip(torch.utils._pytree.tree_leaves(params),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    if not ema:
        with pytest.raises(ValueError, match="carries no EMA"):
            ckpt.load_plain_params(d, prefer_ema=True)


def test_a_checkpoint_from_before_ema_loads(tmp_path):
    """A step file written without the "ema" key (the format before EMA
    was ported) restores with ema None and refuses prefer_ema."""
    cfg, st = _state(False)
    d = tmp_path / "old"
    ckpt.save_meta(str(d), cfg)
    torch.save({"params": st.params, "opt_state": st.opt_state,
                "step": 7}, ckpt.step_path(str(d), 7))
    got, step = ckpt.restore_checkpoint(str(d))
    assert step == 7 and got.ema is None and got.step == 7
    params, _, _, _ = ckpt.load_plain_params(str(d))
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(params),
        torch.utils._pytree.tree_leaves(st.params)))
    with pytest.raises(ValueError, match="carries no EMA"):
        ckpt.load_plain_params(str(d), prefer_ema=True)


def test_use_ema_in_the_decode_cli_and_the_server(tmp_path, capsys):
    """Two CPU steps of the trainer with --ema-decay: the decode CLI with
    --use-ema writes the hypotheses of a checkpoint whose params are the
    EMA, and serve.py's load_params under --use-ema gives the EMA tree;
    both refuse a checkpoint without one."""
    d = str(tmp_path / "ck")
    train_main(["--device", "cpu", "--config", "smoke", "--steps", "2",
                "--batch-size", "2", "--max-frames", "40", "--max-labels",
                "5", "--warmup-steps", "1", "--lr", "0.05", "--ema-decay",
                "0.5", "--ckpt-dir", d, "--eval-every", "0"])
    state, _ = ckpt.restore_checkpoint(d)
    cfg = ckpt.load_model_config(d)
    e = str(tmp_path / "as_params")
    ckpt.save_checkpoint(e, 2, dataclasses.replace(state, params=state.ema,
                                                   ema=None), model_cfg=cfg)
    hyps = {}
    for name, argv in (("ema", ["--ckpt-dir", d, "--use-ema"]),
                       ("as_params", ["--ckpt-dir", e]),
                       ("live", ["--ckpt-dir", d])):
        h = tmp_path / f"{name}.jsonl"
        rec.main(argv + ["--device", "cpu", "--batches", "1",
                         "--batch-size", "2", "--max-symbols", "10",
                         "--hyps-file", str(h)])
        hyps[name] = h.read_text()
    capsys.readouterr()
    assert hyps["ema"] == hyps["as_params"]
    args = srv.parse_args(["--ckpt-dir", d, "--use-ema"])
    served = srv.load_params(args, cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(served),
        torch.utils._pytree.tree_leaves(state.ema)))
    assert not all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(served),
        torch.utils._pytree.tree_leaves(state.params)))
    with pytest.raises(SystemExit, match="carries no EMA"):
        srv.load_params(srv.parse_args(["--ckpt-dir", e, "--use-ema"]), cfg,
                        "cpu")
    with pytest.raises(SystemExit, match="carries no EMA"):
        rec.main(["--ckpt-dir", e, "--use-ema", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --ckpt-dir"):
        srv.load_params(srv.parse_args(["--use-ema"]), cfg, "cpu")
