"""The port's paged_attention (its plain version, on CPU) against the JAX
package's paged_attention (Pallas in interpret mode) on the same pages.

Page tiers bf16 / f32 / int8 with ``int8_mxu`` on and off, the exact
recent ring, window, softcap, sinks, ALiBi, return_state, and a partial
last block. Both sides take the same int8 payloads and scales. The port
reproduces the TPU kernel's block walk, q/P quantization and bf16
roundings, so the bars are: f32 2e-5 (summation order only), bf16 2e-2
and int8 5e-3 (the JAX package's own bars, tests/test_paged_decode.py;
exp and summation order can move a P element across an int8 rounding
boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops.decode import paged_attention as j_paged
from tpu_flash.ops.quant import QuantizedTensor as JQT
from tpu_flash_torch.core.reference import (
    gather_pages_to_dense,
    reference_decode_attention,
)
from tpu_flash_torch.ops.decode import (
    merge_attention_states,
    paged_attention as t_paged,
    recent_tail_state,
)
from tpu_flash_torch.ops.quant import QuantizedTensor as TQT
from tpu_flash_torch.ops.quant import quantize

TOL = {
    "float32": dict(atol=2e-5, rtol=2e-5),
    "bfloat16": dict(atol=2e-2, rtol=2e-2),
    "int8": dict(atol=5e-3, rtol=5e-3),
}
B, HQ, HKV, D, PS, PPS, NP = 3, 4, 2, 128, 16, 4, 16


def _setup(seed, tier, lengths=(64, 23, 1)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, D), dtype=np.float32)
    kp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    vp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    table = rng.permutation(NP)[: B * PPS].reshape(B, PPS).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    if tier == "int8":
        kq, vq = quantize(torch.from_numpy(kp)), quantize(torch.from_numpy(vp))
        tk, tv = kq, vq
        jk = JQT(jnp.asarray(kq.values.numpy()),
                 jnp.asarray(kq.scales.numpy()), "int8")
        jv = JQT(jnp.asarray(vq.values.numpy()),
                 jnp.asarray(vq.scales.numpy()), "int8")
    else:
        tk = torch.from_numpy(kp).to(getattr(torch, tier))
        tv = torch.from_numpy(vp).to(getattr(torch, tier))
        jk = jnp.asarray(kp, getattr(jnp, tier))
        jv = jnp.asarray(vp, getattr(jnp, tier))
    return dict(
        rng=rng, q=q, table=table, lens=lens, tk=tk, tv=tv, jk=jk, jv=jv,
    )


def _both(s, **kw):
    """Run both packages; extra per-head arrays are numpy in ``kw``."""
    jkw, tkw = {}, {}
    for name, val in kw.items():
        if isinstance(val, np.ndarray):
            jkw[name] = jnp.asarray(
                val, jnp.bfloat16 if name.startswith("recent") else None
            )
            tkw[name] = torch.from_numpy(val)
            if name.startswith("recent"):
                tkw[name] = tkw[name].bfloat16()
        else:
            jkw[name] = tkw[name] = val
    j = j_paged(jnp.asarray(s["q"]), s["jk"], s["jv"], jnp.asarray(s["lens"]),
                jnp.asarray(s["table"]), interpret=True, **jkw)
    t = t_paged(torch.from_numpy(s["q"]), s["tk"], s["tv"],
                torch.from_numpy(s["lens"]), torch.from_numpy(s["table"]),
                **tkw)
    return j, t


CASES = [
    ("float32", dict()),
    ("bfloat16", dict()),
    ("int8", dict(int8_mxu=True)),
    ("int8", dict(int8_mxu=False)),
    ("bfloat16", dict(pages_per_compute_block=2, window=20)),
    ("int8", dict(pages_per_compute_block=2, softcap=4.0, sinks=True)),
    ("float32", dict(pages_per_compute_block=2, alibi=True)),
    ("int8", dict(ring=16)),
    ("int8", dict(ring=32, int8_mxu=False, alibi=True)),
]


@pytest.mark.parametrize(
    "tier,opts", CASES,
    ids=["f32", "bf16", "int8-mxu", "int8-exact", "bf16-window-2blk",
         "int8-softcap-sinks-2blk", "f32-alibi-2blk", "int8-ring16",
         "int8-exact-ring32-alibi"],
)
def test_paged_attention_matches_jax(tier, opts):
    s = _setup(10, tier)
    kw = dict(opts)
    if kw.pop("sinks", False):
        kw["sinks"] = s["rng"].standard_normal(HQ).astype(np.float32)
    if kw.pop("alibi", False):
        kw["alibi"] = np.array([0.5, 0.25, 0.125, 0.0625], np.float32)
    w = kw.pop("ring", 0)
    if w:
        ring = s["rng"].standard_normal((2, B, HKV, w, D)).astype(np.float32)
        kw["recent_k"], kw["recent_v"] = ring[0], ring[1]
    j, t = _both(s, **kw)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j),
                               **TOL[tier])


def test_return_state_matches_jax():
    s = _setup(11, "int8", lengths=(40, 64, 7))
    j, t = _both(s, return_state=True)
    for jx, tx in zip(j, t):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                   **TOL["int8"])


def test_exact_tiers_match_dense_oracle():
    """f32 pages against the dense oracle of the gathered cache."""
    s = _setup(12, "float32")
    t = t_paged(torch.from_numpy(s["q"]), s["tk"], s["tv"],
                torch.from_numpy(s["lens"]), torch.from_numpy(s["table"]))
    table = torch.from_numpy(s["table"])
    ref = reference_decode_attention(
        torch.from_numpy(s["q"]), gather_pages_to_dense(s["tk"], table),
        gather_pages_to_dense(s["tv"], table), torch.from_numpy(s["lens"]),
    )
    np.testing.assert_allclose(t.numpy(), ref.numpy(), **TOL["float32"])


def test_fused_ring_matches_external_merge():
    """The ring as a final block equals pages-with-state merged with the
    ring-tail oracle (the construction the fused form replaced), exact
    dequant path, bf16-class tolerance."""
    w = 16
    s = _setup(13, "int8", lengths=(64, 23, 9))
    ring = s["rng"].standard_normal((2, B, HKV, w, D)).astype(np.float32)
    rk = torch.from_numpy(ring[0]).bfloat16()
    rv = torch.from_numpy(ring[1]).bfloat16()
    q = torch.from_numpy(s["q"])
    lens = torch.from_numpy(s["lens"])
    table = torch.from_numpy(s["table"])
    fused = t_paged(q, s["tk"], s["tv"], lens, table, int8_mxu=False,
                    recent_k=rk, recent_v=rv)
    quant_len = (lens - w).clamp(min=0)
    o1, m1, l1 = t_paged(q, s["tk"], s["tv"], quant_len.clamp(min=1), table,
                         int8_mxu=False, return_state=True)
    o2, m2, l2 = recent_tail_state(q, rk, rv, lens, quant_len,
                                   sm_scale=D ** -0.5)
    merged = merge_attention_states(o1, m1, l1, o2, m2, l2,
                                    part1_valid=quant_len > 0)
    np.testing.assert_allclose(fused.numpy(), merged.numpy(),
                               **TOL["bfloat16"])


def test_validation_errors():
    s = _setup(14, "bfloat16")
    q, lens, table = (torch.from_numpy(s["q"]), torch.from_numpy(s["lens"]),
                      torch.from_numpy(s["table"]))
    ring = torch.zeros((B, HKV, 8, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        t_paged(q, s["tk"], s["tv"], lens, table, window=4, recent_k=ring,
                recent_v=ring)
    with pytest.raises(ValueError, match="sinks=None"):
        t_paged(q, s["tk"], s["tv"], lens, table, return_state=True,
                sinks=torch.zeros(HQ))
    int4 = TQT(torch.zeros((HKV, NP, PS // 2, D), dtype=torch.int8),
               torch.ones((HKV, NP, PS, 1)), "int4", "tokens")
    with pytest.raises(ValueError, match="tokens/page"):
        t_paged(q, int4, quantize(torch.zeros(HKV, NP, PS // 2, D)), lens,
                table)
    with pytest.raises(ValueError, match="token-packed"):
        t_paged(q, int4._replace(packing="lanes"), int4, lens, table)


def test_wide_group_in_kernel_chunks_matches_jax(monkeypatch):
    """16 q heads a kv head, twice what one decode kernel launch holds:
    the route that splits the group into chunks (``in_q_head_chunks``,
    run here on the plain version as the card runs it on the kernel)
    against the JAX kernel, which pads the group instead. Sinks and ALiBi
    are per q head and travel with their chunk."""
    from tpu_flash_torch.ops.decode import paged

    hq = 16 * HKV
    s = _setup(15, "bfloat16")
    s["q"] = s["rng"].standard_normal((B, hq, D), dtype=np.float32)
    plain, calls = paged.paged_decode_plain, []

    def counted(*args, **kw):
        calls.append(args[0].shape[1])
        return plain(*args, **kw)

    monkeypatch.setattr(paged, "paged_decode_plain",
                        lambda *a, **kw: paged.in_q_head_chunks(counted, *a,
                                                                **kw))
    j, t = _both(s, sinks=s["rng"].standard_normal(hq).astype(np.float32),
                 alibi=np.linspace(0.5, 0.01, hq).astype(np.float32))
    assert calls == [paged.KERNEL_MAX_Q_PER_KV * HKV] * 2
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j),
                               **TOL["bfloat16"])


@pytest.mark.parametrize("tier", ["bfloat16", "int8"])
def test_wide_group_chunks_give_the_whole_calls_values(tier, monkeypatch):
    """At 16 q heads a kv head, the chunked route's o, m and l equal the
    one-call plain version's bit for bit: each q row's arithmetic is its
    own (exact products summed in f64 on both sides)."""
    from tpu_flash_torch.ops.decode import paged

    hq = 16 * HKV
    s = _setup(16, tier)
    q = torch.from_numpy(
        s["rng"].standard_normal((B, hq, D), dtype=np.float32)).bfloat16()
    args = (q, s["tk"], s["tv"], torch.from_numpy(s["lens"]),
            torch.from_numpy(s["table"]))
    whole = t_paged(*args, return_state=True)
    plain = paged.paged_decode_plain
    monkeypatch.setattr(paged, "paged_decode_plain",
                        lambda *a, **kw: paged.in_q_head_chunks(plain, *a,
                                                                **kw))
    chunked = t_paged(*args, return_state=True)
    for a, b in zip(chunked, whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
