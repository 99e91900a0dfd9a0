"""Head width 256 (Gemma-2) through the port's serving and training
kernels' plain versions, on CPU, against the JAX package (Pallas in
interpret mode), and the head widths each CUDA source builds.

Inputs are made from a seed with numpy and given to both sides. Bars, as
in the d 128 files: f32 outputs 2e-5 (summation order and tile
boundaries only); int8 decode 5e-3 (the int8 bar of
test_torch_decode_tiers.py: exp and summation order can move one
quantized P element); bf16 outputs 2e-2 (one bf16 ulp at these
magnitudes); the tiny Gemma-2-shaped model's f32 logits 1e-4 (the bar of
test_torch_model.py). The backward runs at d 256 and d 64 (the widths
its kernel gained). Nine JAX interpret calls in all.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.models import TINY_TEST as J_TINY
from tpu_flash.models import FlashTransformer as JModel
from tpu_flash.ops.decode import paged_attention as j_paged
from tpu_flash.ops.flash import flash_attention as j_flash
from tpu_flash.ops.flash import flash_attention_ragged as j_ragged
from tpu_flash.ops.flash import paged_prefill_attention as j_paged_prefill
from tpu_flash_torch.checkpoint import params_from_jax
from tpu_flash_torch.models import TINY_TEST, FlashTransformer
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.decode import paged_attention as t_paged
from tpu_flash_torch.ops.flash import (
    flash_attention,
    flash_attention_ragged,
    paged_prefill_attention,
)
from tpu_flash_torch.ops.quant import quantize_pages

from test_torch_decode_tiers import to_jax
from test_torch_engine_tiers import JAX_THREADS, torch_threads

D = 256
F32 = dict(atol=2e-5, rtol=2e-5)
INT8 = dict(atol=5e-3, rtol=5e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors (see
    test_torch_engine_tiers.JAX_THREADS)."""
    with torch_threads(1):
        yield


def _rn(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# -- the widths each source builds ---------------------------------------


def _source_widths(source):
    """Head widths a CUDA source serves: every number it compares
    ``head_dim`` with (its entry check and width dispatch), or its fixed
    ``D`` where it checks ``head_dim != D``."""
    text = (build.CSRC_DIR / f"{source}.cu").read_text()
    widths = {int(n) for n in re.findall(r"head_dim [!=]= (\d+)", text)}
    if "head_dim != D" in text:
        widths.add(int(re.search(r"constexpr int D = (\d+);", text)[1]))
    return widths


def _module_widths(module, name):
    import importlib

    value = getattr(importlib.import_module(module), name)
    return set(value) if isinstance(value, tuple) else {value}


@pytest.mark.parametrize("source,module,name", [
    ("flash_fwd", "tpu_flash_torch.ops.flash.forward", "KERNEL_HEAD_DIMS"),
    ("flash_bwd", "tpu_flash_torch.ops.flash.backward", "KERNEL_HEAD_DIMS"),
    ("paged_decode", "tpu_flash_torch.ops.decode.paged", "KERNEL_HEAD_DIMS"),
    ("paged_prefill", "tpu_flash_torch.ops.flash.paged_prefill",
     "KERNEL_HEAD_DIMS"),
    ("ragged_prefill", "tpu_flash_torch.ops.flash.ragged",
     "KERNEL_HEAD_DIMS"),
    ("attn_weights", "tpu_flash_torch.ops.flash.debug", "KERNEL_HEAD_DIMS"),
    ("variant_fwd", "tpu_flash_torch.ops.flash.variant", "KERNEL_HEAD_DIM"),
    ("quant_fwd", "tpu_flash_torch.ops.flash.quantized", "KERNEL_HEAD_DIMS"),
])
def test_wrapper_widths_are_what_the_source_builds(source, module, name):
    assert _module_widths(module, name) == _source_widths(source)


def _bwd_tiles():
    """{(dtype, kernel, d): tile tuple} of csrc/flash_bwd.cu's Tiles<D>
    specialisations: the bf16 ones first, then the three-pass TF32 ones
    (namespace tf32), as the sweep's variants spell them."""
    text = (build.CSRC_DIR / "flash_bwd.cu").read_text()
    found = re.findall(r"using (Dkv|Dq) = D(?:kv|q)Tiles<([\d, ]+)>;", text)
    assert len(found) == 12
    tiles = {}
    for i, (kind, args) in enumerate(found):
        dims = tuple(int(x) for x in args.split(","))
        dtype = "bfloat16" if i < 6 else "float32"
        tiles[(dtype, kind.lower(), dims[0])] = dims[1:]
    return tiles


def test_backward_tiles_fit_and_are_the_sweeps_built_shapes():
    """The sweep tool's first variant of each (dtype, kernel, width) is
    the shape the source builds. That the tiles fit a block's 227 KB of
    shared memory (two f32 blocks an SM at d 128) and that the f32 row
    stride is 4 mod 32, the source asserts itself (static_assert)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_bwd_sweep", build.PACKAGE_DIR.parent / "tools" /
        "torch_bwd_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    for (dtype, kind, d), dims in _bwd_tiles().items():
        variants = (sweep.VARIANTS if dtype == "bfloat16"
                    else sweep.F32_VARIANTS)
        first = next(v for v in variants if v[:2] == (kind, d))
        assert first[2:] == dims, (dtype, kind, d)


def test_serving_and_training_kernels_take_d256_and_the_backward_d64():
    assert 256 in _source_widths("flash_fwd")
    for source in ("paged_decode", "paged_prefill", "ragged_prefill"):
        assert _source_widths(source) == {128, 256}
    assert _source_widths("flash_bwd") == {64, 128, 256}
    # The weights kernel and the quantized-input forward serve the
    # forward's widths.
    assert _source_widths("attn_weights") == {64, 128, 256}
    assert _source_widths("quant_fwd") == {64, 128, 256}


# -- K1: the forward ------------------------------------------------------


def test_forward_d256_gemma_layer_matches_jax():
    """A sliding Gemma-2 layer's attention at d 256: causal GQA 4:2,
    softcap 50, a 100-token window over 256 positions, f32."""
    rng = np.random.default_rng(0)
    q, k, v = _rn(rng, 1, 4, 256, D), _rn(rng, 1, 2, 256, D), \
        _rn(rng, 1, 2, 256, D)
    kw = dict(causal=True, softcap=50.0, window=100, sm_scale=D ** -0.5)
    with torch_threads(JAX_THREADS):
        want = np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                  **kw))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **F32)


# -- K4: paged decode -----------------------------------------------------

B, HQ, HKV, PS, PPS, NP = 2, 4, 2, 16, 4, 10


@pytest.mark.parametrize("tier,kw,tol", [
    ("bfloat16", dict(softcap=50.0), F32),
    ("int8", dict(window=30, pages_per_compute_block=2), INT8),
])
def test_paged_decode_d256_matches_jax(tier, kw, tol):
    rng = np.random.default_rng(1)
    q = _rn(rng, B, HQ, D)
    kp, vp = _rn(rng, HKV, NP, PS, D), _rn(rng, HKV, NP, PS, D)
    table = rng.permutation(NP)[: B * PPS].reshape(B, PPS).astype(np.int32)
    lens = np.asarray([61, 9], np.int32)
    if tier == "int8":
        tk, tv = (quantize_pages(torch.from_numpy(p), "int8")
                  for p in (kp, vp))
        jk, jv = to_jax(tk), to_jax(tv)
    else:
        tk, tv = (torch.from_numpy(p).bfloat16() for p in (kp, vp))
        jk, jv = (jnp.asarray(p, jnp.bfloat16) for p in (kp, vp))
    with torch_threads(JAX_THREADS):
        want = np.asarray(j_paged(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                  jnp.asarray(table), interpret=True, **kw))
    got = t_paged(torch.from_numpy(q), tk, tv, torch.from_numpy(lens),
                  torch.from_numpy(table), **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **tol)


# -- K5 and K6: chunk prefill ---------------------------------------------


def test_paged_prefill_d256_matches_jax():
    """A 16-row bf16 chunk over bf16 pages (offsets 40 and 0), softcap
    50 and a 24-token window, two history blocks."""
    rng = np.random.default_rng(2)
    q_len, hist_cap = 16, 64
    q = _rn(rng, B, HQ, q_len, D)
    ck, cv = _rn(rng, B, HKV, q_len, D), _rn(rng, B, HKV, q_len, D)
    kp, vp = _rn(rng, HKV, NP, PS, D), _rn(rng, HKV, NP, PS, D)
    table = rng.permutation(NP)[: B * PPS].reshape(B, PPS).astype(np.int32)
    offs = np.asarray([40, 0], np.int32)
    kw = dict(hist_cap=hist_cap, block_q=8, pages_per_compute_block=2,
              softcap=50.0, window=24)
    with torch_threads(JAX_THREADS):
        want = np.asarray(j_paged_prefill(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, ck, cv, kp, vp)),
            jnp.asarray(offs), jnp.asarray(table), interpret=True, **kw),
            np.float32)
    got = paged_prefill_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, ck, cv, kp, vp)),
        torch.from_numpy(offs), torch.from_numpy(table), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_ragged_prefill_d256_matches_jax():
    """Mixed-stage rows (offsets 0, 17, 40) over a 40-token history cap,
    softcap 50, bf16."""
    rng = np.random.default_rng(3)
    q_len, hist_cap = 12, 40
    q = _rn(rng, 3, HQ, q_len, D)
    k, v = _rn(rng, 3, HKV, hist_cap + q_len, D), \
        _rn(rng, 3, HKV, hist_cap + q_len, D)
    offs = np.asarray([0, 17, 40], np.int32)
    with torch_threads(JAX_THREADS):
        want = np.asarray(j_ragged(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            jnp.asarray(offs), hist_cap=hist_cap, softcap=50.0,
            interpret=True), np.float32)
    got = flash_attention_ragged(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(offs), hist_cap=hist_cap, softcap=50.0)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


# -- K8: the backward -----------------------------------------------------


@pytest.mark.parametrize("d,kw", [
    (256, dict(causal=True, softcap=50.0, window=40)),
    (64, dict(causal=True)),
])
def test_backward_matches_jax_vjp(d, kw):
    """Output and dQ, dK, dV through the port's autograd function (the
    backward's plain version on CPU) against ``jax.vjp`` of the JAX
    ``flash_attention``, GQA 4:2 at 128 positions, f32."""
    rng = np.random.default_rng(4)
    q, do = _rn(rng, 1, 4, 128, d), _rn(rng, 1, 4, 128, d)
    k, v = _rn(rng, 1, 2, 128, d), _rn(rng, 1, 2, 128, d)
    with torch_threads(JAX_THREADS):
        out, vjp = jax.vjp(lambda *a: j_flash(*a, **kw),
                           *(jnp.asarray(a) for a in (q, k, v)))
        grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    t_out = flash_attention(tq, tk, tv, **kw)
    t_out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out),
                               **F32)
    for t, j in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=1e-4)


# -- a Gemma-2-shaped model -----------------------------------------------

GEMMA_SHAPE = dict(head_dim=D, num_layers=2, num_q_heads=2, num_kv_heads=1,
                   vocab_size=256, attn_softcap=50.0, sliding_window=8,
                   sliding_window_pattern=2, query_pre_attn_scalar=256.0)


def test_gemma2_shaped_model_logits_match_jax():
    """2 layers (one sliding, one global), d 256, 2 q / 1 kv heads,
    softcap 50, an 8-token window over 24 tokens, vocab 256: the JAX
    model's weights carried across with the converter, f32 logits."""
    jm = JModel(dataclasses.replace(J_TINY, **GEMMA_SHAPE))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = FlashTransformer(dataclasses.replace(TINY_TEST, **GEMMA_SHAPE),
                          device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, 24)).astype(
        np.int32)
    with torch_threads(JAX_THREADS):
        want = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    got = tm.forward(tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
