"""The port's model layer against the JAX package: param mapping, logits,
the decode projections, rope scaling, and checkpoint loading.

Logits tolerances: f32 TINY_TEST 1e-4 (f32 matmuls and transcendentals
summed in another order over two layers); bf16 tiny-byte-llama 0.125 on
logits of magnitude up to 16, i.e. two bf16 ulps there (both sides round
the logits to bf16 before the f32 cast, and bf16 activations re-round at
every layer; measured gap one ulp, 0.0625), with every argmax equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.checkpoint.convert import load_hf_dir as j_load_hf_dir
from tpu_flash.checkpoint.convert import model_config_from_hf as j_cfg_hf
from tpu_flash.models import TINY_TEST as J_TINY
from tpu_flash.models import FlashTransformer as JModel
from tpu_flash.models.transformer import (
    scaled_rope_frequencies as j_scaled_rope,
)
from tpu_flash_torch.checkpoint import (
    load_hf_dir,
    model_config_from_hf,
    params_from_jax,
    read_safetensors,
)
from tpu_flash_torch.models import TINY_TEST, FlashTransformer
from tpu_flash_torch.models.transformer import scaled_rope_frequencies

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "tiny-byte-llama")


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny():
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = FlashTransformer(TINY_TEST, device="cpu")
    return jm, jp, tm, params_from_jax(_np_tree(jp), device="cpu")


def test_params_from_jax_is_exact(tiny):
    _, jp, _, tp = tiny
    jnp_tree = _np_tree(jp)
    assert set(tp) == set(jnp_tree)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(tp[name].numpy(), jnp_tree[name])
    for jl, tl in zip(jnp_tree["layers"], tp["layers"]):
        assert set(jl) == set(tl)
        for name in jl:
            np.testing.assert_array_equal(tl[name].numpy(), jl[name])


def test_init_shapes_and_scale():
    tm = FlashTransformer(TINY_TEST, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    jp = JModel(J_TINY).init(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda x: tuple(x.shape), _np_tree(jp)) == {
        k: ([{n: tuple(w.shape) for n, w in layer.items()}
             for layer in v] if k == "layers" else tuple(v.shape))
        for k, v in params.items()
    }
    std = float(params["layers"][0]["wq"].std())
    assert abs(std - TINY_TEST.hidden_size ** -0.5) < 0.02


@pytest.mark.parametrize("q_offset", [0, 5])
def test_tiny_f32_logits_match_jax(tiny, q_offset):
    jm, jp, tm, tp = tiny
    toks = np.random.default_rng(0).integers(0, 256, (2, 24)).astype(np.int32)
    j = jm.forward(jp, jnp.asarray(toks), q_offset=q_offset)
    t = tm.forward(tp, torch.from_numpy(toks).long(), q_offset=q_offset)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                               rtol=1e-4)


def test_decode_qkv_matches_jax(tiny):
    jm, jp, tm, tp = tiny
    x = np.random.default_rng(1).standard_normal(
        (3, TINY_TEST.hidden_size)).astype(np.float32)
    pos = np.array([0, 7, 30], np.int32)
    j = jm.decode_qkv(jp, 1, jnp.asarray(x), jnp.asarray(pos))
    t = tm.decode_qkv(tp, 1, torch.from_numpy(x), torch.from_numpy(pos))
    for jx, tx in zip(j, t):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(rope_scaling="linear", rope_scaling_factor=4.0),
        dict(rope_scaling="ntk", rope_scaling_factor=2.0),
        dict(rope_scaling="yarn", rope_scaling_factor=8.0,
             rope_orig_context=64),
        dict(rope_scaling="llama3", rope_scaling_factor=8.0,
             rope_orig_context=64, rope_high_freq_factor=4.0),
        dict(query_pre_attn_scalar=8.0),
    ],
    ids=["none", "linear", "ntk", "yarn", "llama3", "qpas"],
)
def test_rope_scaling_matches_jax(kw):
    cfg = dataclasses.replace(TINY_TEST, **kw)
    jcfg = dataclasses.replace(J_TINY, **kw)
    tf, tmult = scaled_rope_frequencies(cfg)
    jf, jmult = j_scaled_rope(jcfg)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    assert tmult == pytest.approx(jmult, rel=1e-12)


def test_model_config_from_hf_matches_jax():
    hf = {
        "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "intermediate_size": 14336,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
        "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                         "original_max_position_embeddings": 8192,
                         "low_freq_factor": 1.0, "high_freq_factor": 4.0},
    }
    assert dataclasses.asdict(model_config_from_hf(hf)) == \
        dataclasses.asdict(j_cfg_hf(hf))


@pytest.fixture(scope="module")
def trained():
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    jm, jp = j_load_hf_dir(CKPT, dtype="bfloat16")
    tm, tp = load_hf_dir(CKPT, dtype="bfloat16", device="cpu")
    return jm, jp, tm, tp


def test_safetensors_reader_is_byte_identical():
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    from safetensors.numpy import load_file

    path = os.path.join(CKPT, "model.safetensors")
    ours, theirs = read_safetensors(path), load_file(path)
    assert set(ours) == set(theirs)
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype
        assert ours[name].tobytes() == theirs[name].tobytes()


def test_trained_checkpoint_loads_like_jax(trained):
    jm, jp, tm, tp = trained
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    np.testing.assert_array_equal(
        tp["layers"][2]["w_down"].float().numpy(),
        np.asarray(jp["layers"][2]["w_down"], np.float32),
    )


def test_trained_bf16_logits_match_jax(trained):
    jm, jp, tm, tp = trained
    toks = np.array(
        [list(b"def quantize(x, scale):\n    return clip(round(x / sc")],
        np.int32,
    )
    j = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    t = tm.forward(tp, torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(t, j, atol=0.125, rtol=0)
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))
