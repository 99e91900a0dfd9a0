"""The port's decode (K4) and paged prefill (K5) over the int4, int4g32,
k8v4 and fp8 page tiers -- their plain versions, on CPU -- against the
JAX package's ``paged_attention`` and ``paged_prefill_attention`` (Pallas
in interpret mode) on the same page bytes.

Both sides take the same payloads and scales (quantized here by the
port; ``test_torch_quant_tiers.py`` holds those bytes to JAX's). The port
reproduces each tier's roundings, so the bars are summation order:

  * exact tiers (int4, fp8 dequant; f32 q and output): 2e-5, the f32 bar
    of ``test_torch_decode.py``;
  * int8-"mxu" P (int4, k8v4) and int4g32's bf16 ``p * scale``: 5e-3, the
    int8 bar there -- exp and summation order can move one P element
    across an int8 (or bf16) rounding boundary;
  * fp8_native: 2e-2 -- a P element that crosses an e4m3 rounding
    boundary moves by 2^-4 of itself, up to ~0.02 of an output here;
  * K5 (bf16 q and outputs): 2e-2, one bf16 ulp at these magnitudes (the
    bar of ``test_torch_paged_prefill.py``).

Each JAX interpret call costs seconds here, so the file makes nine.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_flash.ops.decode import paged_attention as j_paged
from tpu_flash.ops.flash import paged_prefill_attention as j_paged_prefill
from tpu_flash.ops.quant import QuantizedTensor as JQT
from tpu_flash_torch.ops.decode import paged_attention as t_paged
from tpu_flash_torch.ops.flash import paged_prefill_attention
from tpu_flash_torch.ops.quant import quantize_pages

from test_torch_engine_tiers import JAX_THREADS, torch_threads

B, HQ, HKV, D, PS, PPS, NP = 3, 8, 2, 128, 16, 4, 16
EXACT = dict(atol=2e-5, rtol=2e-5)
MXU = dict(atol=5e-3, rtol=5e-3)
FP8_NATIVE = dict(atol=2e-2, rtol=2e-2)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors (the suite
    runs several workers on a few cores); the JAX calls get torch's
    default back (see test_torch_engine_tiers.JAX_THREADS)."""
    with torch_threads(1):
        yield


def to_jax(qt):
    """The same page bytes as a JAX QuantizedTensor."""
    vals = qt.values
    if vals.dtype == torch.float8_e4m3fn:
        v = vals.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    else:
        v = vals.numpy()
    return JQT(jnp.asarray(v), jnp.asarray(qt.scales.numpy()),
               qt.dtype_name, qt.packing)


def _pages(rng, tier):
    """K and V pages of a tier ("k8v4": int8 K, int4 V) for both."""
    k_t, v_t = ("int8", "int4") if tier == "k8v4" else (tier, tier)
    kp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    vp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    tk = quantize_pages(torch.from_numpy(kp), k_t)
    tv = quantize_pages(torch.from_numpy(vp), v_t)
    return tk, tv, to_jax(tk), to_jax(tv)


def _decode_both(seed, tier, jax_kw=None, lengths=(64, 23, 1), ring=0,
                 **kw):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, D), dtype=np.float32)
    table = rng.permutation(NP)[: B * PPS].reshape(B, PPS).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    tk, tv, jk, jv = _pages(rng, tier)
    tkw, jkw = dict(kw), dict(kw, **(jax_kw or {}))
    if ring:
        r = rng.standard_normal((2, B, HKV, ring, D), dtype=np.float32)
        tkw.update(recent_k=torch.from_numpy(r[0]).bfloat16(),
                   recent_v=torch.from_numpy(r[1]).bfloat16())
        jkw.update(recent_k=jnp.asarray(r[0], jnp.bfloat16),
                   recent_v=jnp.asarray(r[1], jnp.bfloat16))
    with torch_threads(JAX_THREADS):
        want = np.asarray(j_paged(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                  jnp.asarray(table), interpret=True, **jkw))
    got = t_paged(torch.from_numpy(q), tk, tv, torch.from_numpy(lens),
                  torch.from_numpy(table), **tkw)
    return got, want, (q, tk, tv, lens, table, tkw)


@pytest.mark.parametrize(
    "tier,kw,ring,tol",
    [
        ("int4", dict(int8_mxu=True), 16, MXU),
        ("int4", dict(int8_mxu=False, window=20, pages_per_compute_block=2),
         0, EXACT),
        ("int4g32", dict(softcap=8.0, pages_per_compute_block=2), 16, MXU),
        ("k8v4", dict(int8_mxu=True), 16, MXU),
        ("fp8", dict(fp8_native=False), 16, EXACT),
        ("fp8", dict(fp8_native=True, pages_per_compute_block=2), 0,
         FP8_NATIVE),
    ],
    ids=["int4-mxu-ring", "int4-exact-window-2blk", "int4g32-softcap-ring",
         "k8v4-mxu-ring", "fp8-exact-ring", "fp8-native-2blk"],
)
def test_paged_decode_tier_matches_jax(tier, kw, ring, tol):
    got, want, _ = _decode_both(7, tier, ring=ring, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_int4_bitwise_unpack_flag():
    """``int4_bitwise_unpack=True`` computes the unpack path in the port
    (bit for bit), within the JAX test's 3e-2 bar of the JAX kernel's
    nibble-plane output (tests/test_paged_decode.py:119: scores equal,
    P quantized per token half)."""
    got, want_bitwise, (q, tk, tv, lens, table, _) = _decode_both(
        11, "int4", jax_kw=dict(int4_bitwise_unpack=True),
        pages_per_compute_block=2,
    )
    unpack = t_paged(torch.from_numpy(q), tk, tv, torch.from_numpy(lens),
                     torch.from_numpy(table), pages_per_compute_block=2,
                     int4_bitwise_unpack=True)
    assert torch.equal(got, unpack)
    np.testing.assert_allclose(got.numpy(), want_bitwise, atol=3e-2,
                               rtol=3e-2)


def test_fp8_native_defaults_off_on_cpu():
    """``fp8_native=None`` resolves off for CPU tensors (the exact tier),
    as the JAX kernel's device probe does on the CPU."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((B, HQ, D), dtype=np.float32))
    tk, tv, _, _ = _pages(rng, "fp8")
    lens = torch.tensor([40, 5, 64], dtype=torch.int32)
    table = torch.arange(B * PPS, dtype=torch.int32).reshape(B, PPS) % NP
    auto = t_paged(q, tk, tv, lens, table)
    assert torch.equal(auto, t_paged(q, tk, tv, lens, table,
                                     fp8_native=False))
    assert not torch.equal(auto, t_paged(q, tk, tv, lens, table,
                                         fp8_native=True))


@pytest.mark.parametrize("tier", ["int4", "fp8"])
def test_paged_prefill_tier_matches_jax(tier):
    """A 16-row bf16 chunk over mixed history offsets (one a pad row at
    offset 0) read from int4 / fp8 pages, two history blocks."""
    rng = np.random.default_rng(5)
    q_len, pps, hist_cap = 16, 4, 64
    q = rng.standard_normal((B, HQ, q_len, D), dtype=np.float32)
    ck, cv = rng.standard_normal((2, B, HKV, q_len, D), dtype=np.float32)
    tk, tv, jk, jv = _pages(rng, tier)
    table = rng.permutation(NP - 1)[: B * pps].reshape(B, pps).astype(
        np.int32)
    offs = np.asarray([40, 0, 64], np.int32)
    table[1] = NP - 1
    kw = dict(hist_cap=hist_cap, block_q=8, pages_per_compute_block=2)
    with torch_threads(JAX_THREADS):
        want = np.asarray(j_paged_prefill(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, ck, cv)), jk, jv,
            jnp.asarray(offs), jnp.asarray(table), interpret=True, **kw),
            np.float32)
    got = paged_prefill_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, ck, cv)), tk, tv,
        torch.from_numpy(offs), torch.from_numpy(table), **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
