"""The port's int4, int4g32, k8v4 and fp8 cache tiers against the JAX
package, byte for byte: quantization and dequantization, the paged
cache's pages and scales after the same appends, and the auto cache
layout (``resolve_cache_config``) over a grid of regimes.

Everything here is exact: both packages round half to even (and e4m3 to
nearest even) on the same f32 values, so payloads, scales and
dequantized values must be identical bytes.
"""

import importlib
import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.engine import cache as jcache
from tpu_flash.utils.tuning import resolve_cache_config as j_resolve
from tpu_flash.utils.tuning import select_cache_policy as j_policy
from tpu_flash_torch.core.config import CacheConfig
from tpu_flash_torch.engine import cache as tcache
from tpu_flash_torch.ops import quant as tq
from tpu_flash_torch.utils.tuning import (
    resolve_cache_config,
    select_cache_policy,
)

# The module (the package re-exports a function of the same name).
jq = importlib.import_module("tpu_flash.ops.quant.quantize")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors (the suite
    runs several workers on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def raw(x) -> bytes:
    """The bytes of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.asarray(x)
    return a.view(np.uint8).tobytes()


def assert_same(t, j, what):
    assert tuple(t.shape) == tuple(np.asarray(j).shape), what
    assert raw(t) == raw(j), what


def _rows(rng):
    """[2, 3, 8, 64] f32 values with an all-zero row, a row whose int4
    scaled values tie at .5, a constant 32-channel group, and values past
    e4m3's subnormal range after scaling."""
    x = rng.standard_normal((2, 3, 8, 64)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[0, 1, 1, :4] = [3.5, -0.5, 1.5, 7.0]  # absmax 7: scale 1, ties
    x[1, 0, 2, :32] = 0.25  # one group of zero span
    x[1, 2, 3] *= 1e-3
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_every_tier_byte_identical(dtype):
    """quantize (lane and token packing), quantize_pages per tier, the
    group-affine pair, the unpackers and dequantize."""
    x = _rows(np.random.default_rng(0))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for name, packing in [("int4", "lanes"), ("int4", "tokens"),
                          ("fp8", "lanes"), ("int8", "lanes")]:
        j, t = jq.quantize(jx, name, packing), tq.quantize(tx, name, packing)
        what = f"{name}/{packing}"
        assert_same(t.values, j.values, what)
        assert_same(t.scales, j.scales, what)
        assert t.logical_shape == tuple(j.logical_shape), what
        assert_same(tq.dequantize(t), jq.dequantize(j), what)
    for name in ("int8", "int4", "int4g32", "fp8"):
        j, t = jq.quantize_pages(jx, name), tq.quantize_pages(tx, name)
        assert (t.dtype_name, t.packing) == (j.dtype_name, j.packing), name
        assert_same(t.values, j.values, name)
        assert_same(t.scales, j.scales, name)
        assert t.logical_shape == tuple(j.logical_shape), name
        for out in (torch.float32, torch.bfloat16):
            jout = jnp.float32 if out == torch.float32 else jnp.bfloat16
            assert_same(tq.dequantize(t, out), jq.dequantize(j, jout), name)
    jqv, jsc = jq.quantize_group_asym(jx)
    tqv, tsc = tq.quantize_group_asym(tx)
    assert_same(tqv, jqv, "group q")
    assert_same(tsc, jsc, "group scales")
    assert_same(tq.dequantize_group_asym(tqv, tsc),
                jq.dequantize_group_asym(jqv, jsc), "group dequant")
    packed = tq.pack_int4_tokens(tqv - 8)
    assert_same(tq.unpack_int4_tokens(packed),
                jq._unpack_int4_tokens(jq._pack_int4_tokens(jqv - 8)),
                "signed token nibbles")
    assert_same(tq.unpack_uint4_tokens(tq.pack_int4_tokens(tqv)),
                jq._unpack_uint4_tokens(jq._pack_int4_tokens(jqv)),
                "unsigned token nibbles")
    assert_same(tq.unpack_int4(tq.pack_int4(tqv - 8)),
                jq._unpack_int4(jq._pack_int4(jqv - 8)), "lane nibbles")
    assert tq.int4g32_num_groups(16) == jq.int4g32_num_groups(16) == 1
    assert tq.int4g32_num_groups(128) == jq.int4g32_num_groups(128) == 4
    with pytest.raises(ValueError, match="unsupported"):
        tq.quantize(tx, "int2")


def test_fp8_cast_matches_jax_through_the_subnormals():
    """e4m3 rounding of absmax-scaled rows whose top reads 448.00003 and
    a sweep of magnitudes down through e4m3's subnormals."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    sweep = np.geomspace(1e-6, 1.0, 128, dtype=np.float32)
    x[:8] = sweep * np.where(np.arange(128) % 2, -1.0, 1.0)[None]
    j = jq.quantize(jnp.asarray(x), "fp8")
    t = tq.quantize(torch.from_numpy(x), "fp8")
    assert_same(t.values, j.values.view(jnp.uint8).view(
        ml_dtypes.float8_e4m3fn), "fp8 payload")
    assert_same(t.scales, j.scales, "fp8 scales")


TIERS = ["int4", "int4g32", "k8v4", "fp8"]


@pytest.mark.parametrize("kv_dtype", TIERS)
def test_cache_pages_and_scales_match_jax_after_same_appends(kv_dtype):
    """Three appends into one layer of a ringed cache (page size 8):

    1. a 20-token chunk over pages 3, 0, 4 -- it spans half-page
       boundaries, so each int4 byte of pages 3 and 0 gets both its
       nibbles from one call (the collision case) and page 4 keeps high
       nibbles unwritten;
    2. two tokens: page 4's offset 4 (the high half of a byte whose low
       nibble the first call wrote) and page 1's offset 0;
    3. two tokens at page 1's offsets 1 and 2.

    Each append pads to 20 tokens on the trash page (page 5) and the
    trash slot, which the comparison leaves out. The appends run JAX's
    eager ops: under ``jax.jit`` XLA multiplies by the reciprocal of 7
    instead of dividing, and 3 of layer 1's 3072 int4 K bytes then round
    one level apart after the first append.
    """
    rng = np.random.default_rng(2)
    L, hkv, d, slots = 2, 2, 64, 3
    kw = dict(page_size=8, num_pages=6, max_pages_per_seq=3,
              kv_dtype=kv_dtype, recent_window=4)
    jc = jcache.PagedKVCache.create(L, hkv, d, JCacheConfig(**kw),
                                    num_slots=slots)
    tc = tcache.PagedKVCache.create(L, hkv, d, CacheConfig(**kw),
                                    num_slots=slots, device="cpu")
    pos = np.arange(20)
    trash_page, trash_slot = 5, 2
    appends = [
        (np.array([3, 0, 4])[pos // 8], pos % 8, np.zeros(20, int), pos),
        (np.array([4, 1]), np.array([4, 0]), np.array([0, 1]),
         np.array([20, 0])),
        (np.array([1, 1]), np.array([1, 2]), np.array([1, 1]),
         np.array([1, 2])),
    ]
    for pages, offs, slot_ids, positions in appends:
        # Every append carries 20 tokens, the rest pads on the trash page
        # and slot: one shape, so JAX's eager ops compile once.
        pad = 20 - len(pages)
        pages, offs, slot_ids, positions = (
            np.concatenate([a, np.full(pad, fill)])
            for a, fill in ((pages, trash_page), (offs, 0),
                            (slot_ids, trash_slot), (positions, 0)))
        k, v = rng.standard_normal((2, 20, hkv, d)).astype(np.float32)
        jc = jc.append(
            1, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
            *(jnp.asarray(a, jnp.int32) for a in (pages, offs)),
            slots=jnp.asarray(slot_ids, jnp.int32),
            positions=jnp.asarray(positions, jnp.int32))
        tc.append(
            1, torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
            *(torch.from_numpy(np.asarray(a, np.int64))
              for a in (pages, offs)),
            slots=torch.from_numpy(np.asarray(slot_ids, np.int64)),
            positions=torch.from_numpy(np.asarray(positions, np.int64)))
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        assert_same(getattr(tc, name)[:, :, :trash_page],
                    getattr(jc, name)[:, :, :trash_page], name)
    for name in ("k_recent", "v_recent"):
        assert_same(getattr(tc, name)[:, :trash_slot],
                    getattr(jc, name)[:, :trash_slot], name)
    for t_side, j_side in zip(tc.layer_view(1), jc.layer_view(1)):
        assert (t_side.dtype_name, t_side.packing) == (j_side.dtype_name,
                                                       j_side.packing)
        assert tuple(t_side.scales.shape) == j_side.scales.shape
    if kv_dtype == "k8v4":  # per-side layouts: int8 K rows, int4 V rows
        assert tc.k_pages.shape[3] == 8 and tc.v_pages.shape[3] == 4
    # The collision bytes hold both tokens' nibbles.
    if kv_dtype in ("int4", "int4g32"):
        both = tc.k_pages[1, :, 3].view(torch.uint8)
        assert ((both >> 4) != 0).any() and ((both & 0xF) != 0).any()


REGIMES = list(itertools.product(
    ["bfloat16", "float32", "int8", "int4", "int4g32", "k8v4", "fp8"],
    [64, 100, 128, 1000, 2048, 2049, 8192, 32768],
    [1, 8, 32],
))


def test_auto_cache_layout_matches_jax_over_a_grid():
    """select_cache_policy and resolve_cache_config of an all-auto
    CacheConfig over every tier x max_seq_len x batch of the grid."""
    for kv_dtype, seq, batch in REGIMES:
        assert select_cache_policy(kv_dtype, seq, batch) == \
            j_policy(kv_dtype, seq, batch), (kv_dtype, seq, batch)
        t = resolve_cache_config(CacheConfig(kv_dtype=kv_dtype),
                                 max_seq_len=seq, max_batch_size=batch)
        j = j_resolve(JCacheConfig(kv_dtype=kv_dtype), max_seq_len=seq,
                      max_batch_size=batch)
        assert t.resolved
        assert (t.page_size, t.num_pages, t.max_pages_per_seq,
                t.recent_window) == (j.page_size, j.num_pages,
                                     j.max_pages_per_seq, j.recent_window)


@pytest.mark.parametrize(
    "fields,seq,batch",
    [(dict(page_size=128, kv_dtype="int8", recent_window=64), 2048, 8),
     (dict(page_size=8, num_pages=32, max_pages_per_seq=8, kv_dtype="int4",
           recent_window=16), 64, 2),
     (dict(page_size=8, kv_dtype="int4"), 64, 2),
     (dict(page_size=7, kv_dtype="fp8"), 100, 4),
     (dict(max_pages_per_seq=3, kv_dtype="k8v4"), 1000, 4),
     (dict(num_pages=50, kv_dtype="int4g32"), 4096, 2)],
    ids=["explicit-page-and-ring", "resolved-passthrough", "ring-clamped",
         "odd-explicit-page", "explicit-pages-per-seq", "explicit-capacity"],
)
def test_explicit_fields_resolve_as_jax(fields, seq, batch):
    """The explicit-field cases of tests/test_auto_cache.py, and more:
    explicit fields win, the rest follow them as in JAX."""
    t_in = CacheConfig(**fields)
    t = resolve_cache_config(t_in, max_seq_len=seq, max_batch_size=batch)
    j = j_resolve(JCacheConfig(**fields), max_seq_len=seq,
                  max_batch_size=batch)
    assert (t.page_size, t.num_pages, t.max_pages_per_seq,
            t.recent_window) == (j.page_size, j.num_pages,
                                 j.max_pages_per_seq, j.recent_window)
    if t_in.resolved:
        assert t is t_in
    with pytest.raises(ValueError, match="unresolved"):
        _ = CacheConfig(kv_dtype=fields["kv_dtype"]).max_context
