"""PyTorch port model, config and weight bridge vs the JAX package.

Config: the libri100 structure at narrow widths (the UNI shape of
test_torch_parity.py), compute_dtype float32 on both sides. Params come
from the JAX `init_params` and cross through `params_from_numpy`.
"""

import ast
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.weights import (load_state_dict,
                                              params_from_numpy,
                                              params_to_numpy)

pytestmark = pytest.mark.quick

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
             pred_layers=1, pred_hidden=12, embed_dim=10, joint_dim=14,
             vocab_size=11, compute_dtype="float32")
JCFG = jax_config.TransducerConfig(**SMALL)
TCFG = port_config.TransducerConfig(**SMALL)


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   JCFG))


def _feats(seed=0, B=4, T=20):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, SMALL["input_dim"])).astype(np.float32)
    lens = np.array([T, T - 5, 0, 3], np.int32)[:B]  # one zero-length row
    return feats, lens


# ------------------------------- config --------------------------------

def test_named_configs_mirror_jax():
    assert port_config.NAMED_CONFIGS.keys() == jax_config.NAMED_CONFIGS.keys()
    for name, make in port_config.NAMED_CONFIGS.items():
        assert (dataclasses.asdict(make())
                == dataclasses.asdict(jax_config.NAMED_CONFIGS[name]())), name


@pytest.mark.parametrize("cls", ["TransducerConfig", "TrainConfig"])
def test_config_fields_and_defaults_mirror_jax(cls):
    assert (dataclasses.asdict(getattr(port_config, cls)())
            == dataclasses.asdict(getattr(jax_config, cls)()))


@pytest.mark.parametrize("name, want", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_cdtype_is_a_torch_dtype(name, want):
    assert port_config.TransducerConfig(compute_dtype=name).cdtype is want


# ------------------------------- model ---------------------------------

def test_encode_matches_jax(params_np):
    feats, lens = _feats()
    want, want_lens = jm.encode(jax.tree.map(jnp.asarray, params_np), JCFG,
                                jnp.asarray(feats), jnp.asarray(lens))
    got, got_lens = tm.encode(params_from_numpy(params_np), TCFG,
                              torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_predict_step_matches_jax(params_np):
    rng = np.random.default_rng(1)
    B, H = 4, SMALL["pred_hidden"]
    label = np.array([0, 3, 10, 5], np.int32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = rng.normal(size=(B, H)).astype(np.float32)
    want, ((hw, cw),) = jm.predict_step(
        jax.tree.map(jnp.asarray, params_np), JCFG, jnp.asarray(label),
        [(jnp.asarray(h), jnp.asarray(c))])
    got, ((hg, cg),) = tm.predict_step(
        params_from_numpy(params_np), TCFG, torch.from_numpy(label).long(),
        [(torch.from_numpy(h), torch.from_numpy(c))])
    for a, b in ((got, want), (hg, hw), (cg, cw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def test_joint_step_matches_jax(params_np):
    rng = np.random.default_rng(2)
    enc_t = rng.normal(size=(5, SMALL["enc_hidden"])).astype(np.float32)
    pred_u = rng.normal(size=(5, SMALL["pred_hidden"])).astype(np.float32)
    want = jm.joint_step(jax.tree.map(jnp.asarray, params_np), JCFG,
                         jnp.asarray(enc_t), jnp.asarray(pred_u))
    got = tm.joint_step(params_from_numpy(params_np), TCFG,
                        torch.from_numpy(enc_t), torch.from_numpy(pred_u))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_init_params_has_the_jax_tree_shapes(params_np):
    cfg = dataclasses.replace(TCFG, ctc_head=True, pruned_range=3)
    jcfg = dataclasses.replace(JCFG, ctc_head=True, pruned_range=3)
    want = jax.tree.map(np.shape, jax.tree.map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg)))
    got = jax.tree.map(np.shape, params_to_numpy(
        tm.init_params(cfg, np.random.default_rng(0))))
    assert got == want


@pytest.mark.parametrize("field, value", [
    ("enc_type", "conformer"), ("bidirectional", True),
    ("pred_type", "stateless"), ("big_blank_durations", (2, 4)),
    ("tdt_durations", (0, 1, 2)), ("joint_experts", 2),
])
def test_unported_configs_raise(field, value):
    cfg = dataclasses.replace(TCFG, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_params(cfg, np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.encode({}, cfg, torch.zeros(1, 4, 8), torch.ones(1))


# ---------------------------- weight bridge -----------------------------

def test_numpy_round_trip_is_exact(params_np):
    back = params_to_numpy(params_from_numpy(params_np))
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_int8_params_raise():
    from rnn_transducer_tpu.ops.quant import quantize_params

    q = jax.tree.map(np.asarray, quantize_params(
        jm.init_params(jax.random.PRNGKey(0), JCFG)))
    with pytest.raises(NotImplementedError, match="int8"):
        params_from_numpy(q)


def _logits(params, cfg, feats, lens):
    """Joint logits at every encoder frame for the start-symbol predictor."""
    enc, _ = tm.encode(params, cfg, feats, lens)
    B, T, _ = enc.shape
    pred, _ = tm.predict_step(params, cfg,
                              torch.zeros(B, dtype=torch.long),
                              tm.init_pred_state(cfg, B))
    return torch.stack([tm.joint_step(params, cfg, enc[:, t], pred)
                        for t in range(T)], dim=1)


def test_load_state_dict_of_exported_checkpoint(params_np, tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from export_torch_ckpt import params_to_torch_state_dict
    finally:
        sys.path.remove(str(REPO / "tools"))
    path = tmp_path / "model.pt"
    torch.save(params_to_torch_state_dict(params_np, JCFG), path)
    feats, lens = _feats(seed=3)
    feats, lens = torch.from_numpy(feats), torch.from_numpy(lens)
    want = _logits(params_from_numpy(params_np), TCFG, feats, lens)
    got = _logits(load_state_dict(str(path), TCFG), TCFG, feats, lens)
    # the export splits b into bias_ih = b, bias_hh = 0: exact sum back
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        load_state_dict(str(path), dataclasses.replace(TCFG, enc_hidden=8))


# ------------------------------- no jax --------------------------------

def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (REPO / "rnn_transducer_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "rnn_transducer_tpu"), (
            f"{path.name} imports {mod}")
