"""What the split paged decode kernel (K4, ``csrc/paged_decode.cu``)
rests on, held on the CPU through its plain version.

The kernel reads only a row's live tokens -- those before the page limit
and inside the window -- and cuts them over a cluster of thread blocks
(``paged.decode_slices``). Two JAX cases hold the plain version against
the JAX ``paged_attention`` (Pallas in interpret mode) at ragged lengths
where the kernel's two special cases arise: a ring at L <= W, whose one
kv block holds no live token, and a window starting inside a page of the
second of two kv blocks (bars as ``test_torch_decode.py``: int8 5e-3,
bf16 2e-2). The torch-only cases show, bit for bit, that the plain
version's output does not depend on any dead token's bytes (so the
kernel may skip them), and how the wrapper plans the split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops.decode import paged_attention as j_paged
from tpu_flash.ops.quant import QuantizedTensor as JQT
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.decode import paged
from tpu_flash_torch.ops.quant import quantize_pages

from test_torch_engine_tiers import JAX_THREADS, torch_threads

B, HQ, HKV, D, PS, PPS = 8, 8, 2, 128, 16, 4
NP = B * PPS + 4
LENGTHS = (1, 7, 15, 16, 17, 40, 63, 64)  # ring 16: the first four L <= W
TOL = {"int8": dict(atol=5e-3, rtol=5e-3),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors (the suite
    runs several workers on a few cores)."""
    with torch_threads(1):
        yield


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, D), dtype=np.float32)
    kp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    vp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    table = rng.permutation(NP)[: B * PPS].reshape(B, PPS).astype(np.int32)
    ring = rng.standard_normal((2, B, HKV, 16, D), dtype=np.float32)
    return rng, q, kp, vp, table, ring


@pytest.mark.parametrize(
    "tier,kw",
    [("int8", dict(int8_mxu=True, ring=16)),
     ("bfloat16", dict(window=21, pages_per_compute_block=2))],
    ids=["int8-mxu-ring16-short-rows", "bf16-window-in-page-2blk"],
)
def test_ragged_rows_match_jax(tier, kw):
    _, q, kp, vp, table, ring = _inputs(30)
    lens = np.asarray(LENGTHS, np.int32)
    kw = dict(kw)
    tkw, jkw = dict(kw), dict(kw)
    if kw.pop("ring", 0):
        del tkw["ring"], jkw["ring"]
        tkw.update(recent_k=torch.from_numpy(ring[0]).bfloat16(),
                   recent_v=torch.from_numpy(ring[1]).bfloat16())
        jkw.update(recent_k=jnp.asarray(ring[0], jnp.bfloat16),
                   recent_v=jnp.asarray(ring[1], jnp.bfloat16))
    if tier == "int8":
        tk = quantize_pages(torch.from_numpy(kp), "int8")
        tv = quantize_pages(torch.from_numpy(vp), "int8")
        jk, jv = (JQT(jnp.asarray(x.values.numpy()),
                      jnp.asarray(x.scales.numpy()), "int8")
                  for x in (tk, tv))
    else:
        tk = torch.from_numpy(kp).bfloat16()
        tv = torch.from_numpy(vp).bfloat16()
        jk, jv = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    with torch_threads(JAX_THREADS):
        want = np.asarray(j_paged(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                  jnp.asarray(table), interpret=True, **jkw))
    got = paged.paged_attention(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(lens),
                                torch.from_numpy(table), **tkw)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[tier])


def _dead_slots(table, lens, ring, window):
    """[NP, PS] True where a page slot holds no live token of any row:
    past the page limit (L - W with a ring), before the window, or on a
    page no row's table names."""
    dead = np.ones((NP, PS), bool)
    for b, n in enumerate(lens):
        eff = max(n - ring, 1) if ring else n
        limit = max(n - ring, 0) if ring else n
        lo = max(eff - window, 0) if window else 0
        for pos in range(lo, limit):
            dead[table[b, pos // PS], pos % PS] = False
    return dead


SIDES = {"k8v4": ("int8", "int4")}


@pytest.mark.parametrize(
    "tier,kw",
    [("bfloat16", dict(ring=16)),
     ("float32", dict(window=21, pages_per_compute_block=2)),
     ("int8", dict(int8_mxu=True, ring=16)),
     ("int8", dict(int8_mxu=False, window=30, pages_per_compute_block=1)),
     ("int4", dict(int8_mxu=True, ring=16)),
     ("int4g32", dict(window=21, pages_per_compute_block=2)),
     ("k8v4", dict(int8_mxu=True, ring=16)),
     ("fp8", dict(fp8_native=True, window=21, pages_per_compute_block=2)),
     ("fp8", dict(fp8_native=False, ring=16))],
    ids=["bf16-ring", "f32-window-2blk", "int8-mxu-ring",
         "int8-exact-window-4blk", "int4-mxu-ring", "int4g32-window-2blk",
         "k8v4-mxu-ring", "fp8-native-window-2blk", "fp8-exact-ring"],
)
def test_dead_tokens_never_reach_the_output(tier, kw):
    """Pages whose dead slots hold other values give the plain version's
    output bit for bit, for every row, the rows whose one kv block is
    all dead (ring, L <= 16) included: the kernel never reads them."""
    rng, q, kp, vp, table, ring = _inputs(31)
    lens = np.asarray(LENGTHS, np.int32)
    kw = dict(kw)
    w = kw.pop("ring", 0)
    if w:
        kw.update(recent_k=torch.from_numpy(ring[0]).bfloat16(),
                  recent_v=torch.from_numpy(ring[1]).bfloat16())
    dead = _dead_slots(table, lens, w, kw.get("window"))
    assert dead.sum() > B * PS  # whole pages and parts of pages
    k_t, v_t = SIDES.get(tier, (tier, tier))

    def pages(x, t, other):
        y = torch.from_numpy(np.where(dead[None, :, :, None], other, x))
        return y.to(getattr(torch, t)) if t in ("float32", "bfloat16") \
            else quantize_pages(y, t)

    outs = []
    for k_other, v_other in ((kp, vp), (
            5 * rng.standard_normal(kp.shape, dtype=np.float32),
            5 * rng.standard_normal(vp.shape, dtype=np.float32))):
        outs.append(paged.paged_attention(
            torch.from_numpy(q), pages(kp, k_t, k_other),
            pages(vp, v_t, v_other), torch.from_numpy(lens),
            torch.from_numpy(table), **kw))
    assert torch.equal(outs[0], outs[1])


def test_slices_follow_the_table_and_the_wave():
    """One slice for each 256 tokens a page table holds, from 1 up to
    the portable cluster size of 8; then fewer until every (batch row,
    kv head)'s cluster runs in one wave of what the card holds."""
    assert paged.decode_slices(1) == 1
    assert paged.decode_slices(256) == 1
    assert paged.decode_slices(257) == 2
    assert paged.decode_slices(2048) == 8
    assert paged.decode_slices(32768) == paged.KERNEL_MAX_SLICES == 8
    # The kernel refuses a wider cluster than the wrapper plans.
    assert (f"constexpr int MAX_SLICES = {paged.KERNEL_MAX_SLICES};"
            in build.PAGED_DECODE.source.read_text())
    held = {8: 30, 7: 34, 6: 40, 5: 48, 4: 62, 3: 84, 2: 132, 1: 264}
    assert paged.decode_slices(2048, 64, held.get) == 3
    assert paged.decode_slices(2048, 8, held.get) == 8
    assert paged.decode_slices(512, 8, held.get) == 2
    assert paged.decode_slices(2048, 1000, held.get) == 1
    # An 8192-token kv block whose share at 2 slices or fewer is over a
    # block's shared memory: 3 slices, two waves.
    wide = {**held, 2: 0, 1: 0}
    assert paged.decode_slices(8192, 1000, wide.get) == 3


def _launch_args(monkeypatch, slices=None):
    """The arguments the wrapper hands the C entry for a 4 x 16-token
    table, captured instead of launched."""
    seen = []
    monkeypatch.setattr(build.PAGED_DECODE, "launch",
                        lambda *a, tag=None: seen.append(a))
    monkeypatch.setattr(build, "stream_handle", lambda t: 0)
    monkeypatch.setattr(paged, "_clusters_held", lambda dev, args: 1000)
    paged._plan.cache_clear()
    monkeypatch.setattr(paged, "SLICES", slices)
    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    pages = torch.zeros(2, 8, 16, 128, dtype=torch.bfloat16)
    paged._paged_decode_cuda(
        q, pages, pages, None, None, torch.tensor([20, 5]),
        torch.arange(8).reshape(2, 4), k_tier="bfloat16", v_tier="bfloat16",
        sm_scale=0.1, pages_per_compute_block=2, window=None, softcap=None,
        sinks=None, alibi=None, recent_k=None, recent_v=None,
        return_state=False)
    (args,) = seen
    return args


def test_wrapper_passes_the_split(monkeypatch):
    """The wrapper hands the kernel its slices (decode_slices of the
    table, or SLICES) just before the stream, and bk as
    pages_per_compute_block * page size."""
    args = _launch_args(monkeypatch)
    assert args[-2:] == (paged.decode_slices(64), 0)
    assert args[23] == 32  # block_tokens: 2 pages of 16
    args = _launch_args(monkeypatch, slices=5)
    assert args[-2:] == (5, 0)
