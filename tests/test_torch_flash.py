"""The port's flash_attention (its plain version, on CPU) against the JAX
package's flash_attention (Pallas in interpret mode) on the same inputs.

One CUDA kernel replaces four Pallas grid geometries, so each JAX route
-- rectangular, single-pass, triangular, paired triangular -- gets a case
on the same inputs, forced through ``BlockSizes``. Tolerances: f32 2e-5
(the JAX package's own f32 parity bar; only summation order and tile
boundaries differ), bf16 2e-2 (bf16 rounding of q and P at different
tile maxima).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.core.config import BlockSizes
from tpu_flash.ops.flash import flash_attention as j_flash
from tpu_flash_torch.core.reference import reference_gqa_attention
from tpu_flash_torch.ops.flash import flash_attention as t_flash

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _inputs(seed, b, hq, hkv, sq, skv, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    return rng, jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


ROUTES = {
    "rect": BlockSizes(block_q=64, block_kv_major=128, block_kv=128),
    "onepass": BlockSizes(block_q=128, block_kv_major=128, block_kv=128,
                          onepass=True),
    "triangular": BlockSizes(block_q=64, block_kv_major=128, block_kv=128,
                             triangular=True),
    "tri_pair": BlockSizes(block_q=128, block_kv_major=128, block_kv=128,
                           triangular=True, tri_pair=True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_jax_route_matches(route):
    """Causal GQA 4:2 self-attention at s = 256 (two 128-row blocks, so
    the paired triangular route engages), f32."""
    _, (jq, jk, jv), (tq, tk, tv) = _inputs(0, 1, 4, 2, 256, 256, 64)
    j = j_flash(jq, jk, jv, causal=True, block_sizes=ROUTES[route])
    t = t_flash(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_f32(t), _f32(j), **F32_TOL)


CASES = {
    "noncausal-kvtail": dict(sq=40, skv=100, causal=False),
    "offset-longer-kv": dict(sq=32, skv=96, causal=True, q_offset=64),
    "window": dict(sq=96, skv=96, causal=True, window=17),
    "softcap": dict(sq=48, skv=48, causal=True, softcap=5.0),
    "sinks": dict(sq=48, skv=48, causal=True, sinks=True),
    "alibi": dict(sq=48, skv=80, causal=True, q_offset=32, alibi=True),
    "lse": dict(sq=72, skv=72, causal=True, save_residuals=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_variants_match(case):
    opts = dict(CASES[case])
    sq, skv = opts.pop("sq"), opts.pop("skv")
    rng, (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2, 4, 2, sq, skv, 64)
    extra_j, extra_t = {}, {}
    if opts.pop("sinks", False):
        s = rng.standard_normal(4).astype(np.float32)
        extra_j["sinks"], extra_t["sinks"] = jnp.asarray(s), torch.from_numpy(s)
    if opts.pop("alibi", False):
        a = np.array([0.5, 0.25, 0.125, 0.0625], np.float32)
        extra_j["alibi"], extra_t["alibi"] = jnp.asarray(a), torch.from_numpy(a)
    j = j_flash(jq, jk, jv, **opts, **extra_j)
    t = t_flash(tq, tk, tv, **opts, **extra_t)
    if opts.get("save_residuals"):
        np.testing.assert_allclose(_f32(t[1]), _f32(j[1]), **F32_TOL)
        j, t = j[0], t[0]
    np.testing.assert_allclose(_f32(t), _f32(j), **F32_TOL)


def test_kv_tail_masks_padded_rows():
    """``kv_len`` attends only the first kv rows of a padded bucket."""
    _, _, (tq, tk, tv) = _inputs(2, 1, 4, 2, 16, 64, 32)
    t = t_flash(tq, tk, tv, causal=False, kv_len=37)
    ref = reference_gqa_attention(tq, tk[:, :, :37], tv[:, :, :37])
    np.testing.assert_allclose(_f32(t), _f32(ref), **F32_TOL)


def test_bf16_causal_gqa_chunk():
    """bf16 chunk with q_offset (the engine's gathered-history route)."""
    _, (jq, jk, jv), (tq, tk, tv) = _inputs(3, 2, 4, 2, 32, 96, 128,
                                            dtype="bfloat16")
    j = j_flash(jq, jk, jv, causal=True, q_offset=64)
    t = t_flash(tq, tk, tv, causal=True, q_offset=64)
    np.testing.assert_allclose(_f32(t), _f32(j), **BF16_TOL)


def test_validation_errors():
    _, _, (tq, tk, tv) = _inputs(4, 1, 4, 2, 8, 8, 16)
    with pytest.raises(ValueError, match="window requires causal"):
        t_flash(tq, tk, tv, window=4)
    with pytest.raises(ValueError, match="multiple"):
        t_flash(tq, tk[:, :1].expand(1, 3, 8, 16), tv[:, :1].expand(
            1, 3, 8, 16))
    with pytest.raises(ValueError, match="alibi requires causal"):
        t_flash(tq, tk, tv, alibi=torch.ones(4))
    with pytest.raises(ValueError, match="q segment ids must be"):
        t_flash(tq, tk, tv, segment_ids=(torch.zeros(1, 7), torch.zeros(1, 8)))
    with pytest.raises(ValueError, match="kv segment ids must be"):
        t_flash(tq, tk, tv, segment_ids=(torch.zeros(1, 8), torch.zeros(2, 8)))


def test_kernel_softmax_step_is_block_kv():
    """csrc/flash_fwd.cu compiles its online-softmax step as
    ``TileSizes.block_kv`` kv rows in both kernels (``BK``: the kv block
    the order-exact kernel walks the prefill tile over, and the step the
    bf16 tensor-core tiles stage and take their running max over): the
    step fixes which running max each P element is rounded after, which
    the plain version and the JAX walk round it after."""
    import re

    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash.forward import KERNEL_TILES

    src = build.FLASH_FWD.source.read_text()
    step = re.findall(r"constexpr int BK = (\d+);", src)
    assert [int(n) for n in step] == [KERNEL_TILES.block_kv]
    tiles = re.search(r"using TcTiles = tc::FwdTiles<([^;]*)>;", src)
    assert tiles is not None
    assert [a.strip() for a in tiles[1].split(",")][-1] == "BK"


def test_order_exact_reaches_the_exact_entry(monkeypatch):
    """``flash_attention(order_exact=True)`` and the model's
    ``order_exact`` route through ``flash_fwd_exact`` (the CUDA-core
    entry the serving engine takes; on CPU both entries are the plain
    version)."""
    from tpu_flash_torch.models import TINY_TEST, FlashTransformer
    from tpu_flash_torch.ops.flash import api

    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("causal"))
        return api.flash_fwd(*args, **kw)

    monkeypatch.setattr(api, "flash_fwd_exact", spy)
    _, _, (tq, tk, tv) = _inputs(5, 1, 4, 2, 16, 16, 32)
    want = t_flash(tq, tk, tv, causal=True)
    got = t_flash(tq, tk, tv, causal=True, order_exact=True)
    assert calls == [True] and torch.equal(got, want)
    model = FlashTransformer(TINY_TEST, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.arange(8)[None] % TINY_TEST.vocab_size
    with torch.no_grad():
        plain = model.forward(params, tokens)
        exact = model.forward(params, tokens, order_exact=True)
    assert len(calls) == 1 + TINY_TEST.num_layers
    assert torch.equal(plain, exact)
    # The serving engine's prefill takes the order-exact entry.
    from tpu_flash_torch.core.config import EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    eng = InferenceEngine(model, params, EngineConfig(max_seq_len=64))
    eng.submit([1, 2, 3, 4, 5], 1)
    eng.run()
    assert len(calls) == 1 + 2 * TINY_TEST.num_layers
