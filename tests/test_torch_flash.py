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
    # Rows past position skv + window - 2 = 190 start their window at or
    # past the last key: every key takes the mask value (o the mean of
    # V, lse MASK_VALUE + log(skv)). One 128-key tile, so the JAX
    # kernel's walk covers every key for them too.
    "window-past-kv": dict(sq=256, skv=128, causal=True, window=64,
                           save_residuals=True),
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


def test_rows_that_see_no_key_average_v():
    """A window that ends past ``kv_len``: rows whose window starts at or
    past kv_len (positions past kv_len + window - 2) give the mean of
    V[:kv_len] and lse MASK_VALUE + log(kv_len), as the JAX kernel's
    rows whose every key is masked do; the other rows are unchanged by
    the keys past kv_len."""
    from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
    from tpu_flash_torch.ops.flash.forward import flash_fwd

    _, _, (tq, tk, tv) = _inputs(5, 1, 4, 2, 160, 160, 32)
    kw = dict(causal=True, sm_scale=32 ** -0.5, window=16, save_lse=True)
    out, lse = flash_fwd(tq, tk, tv, kv_len=100, **kw)
    first = 100 + 16 - 1
    mean = tv[:, :, :100].mean(2).repeat_interleave(2, 1)
    np.testing.assert_allclose(
        _f32(out[:, :, first:]),
        _f32(mean[:, :, None].expand(-1, -1, 160 - first, -1)), **F32_TOL)
    want = np.float32(DEFAULT_MASK_VALUE) + np.float32(np.log(100))
    np.testing.assert_array_equal(_f32(lse[:, :, first:]), want)
    cut, cut_lse = flash_fwd(tq[:, :, :first], tk[:, :, :100],
                             tv[:, :, :100], **kw)
    np.testing.assert_array_equal(_f32(out[:, :, :first]), _f32(cut))
    np.testing.assert_array_equal(_f32(lse[:, :, :first]), _f32(cut_lse))


def _orphan_case(causal, sinks=False):
    """Causal or not, s 256 (two 128-key blocks): q rows 10-19 and
    140-149 carry a segment id (2) that no key has. Returns the JAX
    kernel's and the port's (o, lse) and V as numpy."""
    from tpu_flash.ops.flash import SegmentIds

    rng, (jq, jk, jv), (tq, tk, tv) = _inputs(6, 1, 4, 2, 256, 256, 64)
    kv_seg = np.zeros((1, 256), np.int32)
    kv_seg[:, 128:] = 1
    q_seg = kv_seg.copy()
    q_seg[:, 10:20] = q_seg[:, 140:150] = 2
    extra_j, extra_t = {}, {}
    if sinks:
        s = rng.standard_normal(4).astype(np.float32)
        extra_j["sinks"], extra_t["sinks"] = jnp.asarray(s), torch.from_numpy(s)
    j = j_flash(jq, jk, jv, causal=causal, block_sizes=ROUTES["rect"],
                segment_ids=SegmentIds(jnp.asarray(q_seg),
                                       jnp.asarray(kv_seg)),
                save_residuals=True, **extra_j)
    t = t_flash(tq, tk, tv, causal=causal, save_residuals=True,
                segment_ids=(torch.from_numpy(q_seg),
                             torch.from_numpy(kv_seg)), **extra_t)
    return [_f32(x) for x in (*j, *t)] + [np.repeat(_f32(tv), 2, axis=1)]


def test_rows_whose_segment_no_key_carries():
    """A q segment that no key carries: every column of those rows takes
    the mask value. The port's plain version gives them the mean of
    V[:kv_len] and lse MASK_VALUE + log(kv_len) (MASK_VALUE in f32), as
    it gives a row that sees no key. The JAX kernel gives the mean of the
    columns its block walk visits: all of them without causality, and
    with it only the kv blocks up to the row's q block's diagonal (a
    reference quirk, ROADMAP: rows 10-19 of the first q block average the
    first 128 keys). With sinks the sink takes the whole weight on both
    sides (o 0, lse the sink), whatever the walk."""
    from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE

    mask = np.float32(DEFAULT_MASK_VALUE)
    for causal in (False, True):
        jo, jl, to, tl, v = _orphan_case(causal)
        if not causal:  # the JAX walk visits every key for every row
            np.testing.assert_allclose(to, jo, **F32_TOL)
        for rows in (slice(10, 20), slice(140, 150)):
            np.testing.assert_allclose(
                to[:, :, rows],
                np.broadcast_to(v.mean(2)[:, :, None], to[:, :, rows].shape),
                **F32_TOL)
            np.testing.assert_array_equal(tl[:, :, rows], mask)
            np.testing.assert_array_equal(jl[:, :, rows], mask)
        live = np.r_[0:10, 20:140, 150:256]
        np.testing.assert_allclose(to[:, :, live], jo[:, :, live], **F32_TOL)
        np.testing.assert_allclose(tl[:, :, live], jl[:, :, live], **F32_TOL)
        if causal:  # the JAX walk: rows 140-149 see both blocks
            np.testing.assert_allclose(to[:, :, 140:150], jo[:, :, 140:150],
                                       **F32_TOL)
            np.testing.assert_allclose(
                jo[:, :, 10:20],
                np.broadcast_to(v[:, :, :128].mean(2)[:, :, None],
                                jo[:, :, 10:20].shape), **F32_TOL)
    jo, jl, to, tl, _ = _orphan_case(True, sinks=True)
    np.testing.assert_allclose(to, jo, **F32_TOL)
    np.testing.assert_allclose(tl, jl, **F32_TOL)
    assert not to[:, :, 10:20].any()


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
