"""The port's attention backward (``flash_bwd_plain`` through the
``FlashAttentionFn`` autograd wiring, on CPU) against ``jax.vjp`` of the
JAX package's ``flash_attention`` (Pallas in interpret mode), and against
torch autograd of the port's own plain reference.

Tolerances, from the reference's own magnitude (max |ref| per tensor):
f32 1e-5 of it (the same arithmetic in another summation order); bf16
4 bf16 ulps of it (both sides round o, dS and each dK/dV partial to
bf16 at the same points; f32 sums in another order can flip each of
those roundings by one ulp, and a GQA group sums two rounded partials).
The JAX cases are few (each compiles the interpret-mode kernels, ~2 s);
the cheap cases hold the port against autograd of
``reference_gqa_attention``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.core.config import BlockSizes
from tpu_flash.ops.flash import backward as j_backward
from tpu_flash.ops.flash import flash_attention as j_flash
from tpu_flash_torch.core.reference import (
    DEFAULT_MASK_VALUE,
    reference_gqa_attention,
)
from tpu_flash_torch.ops.flash import (
    FlashAttentionFn,
    SegmentIds,
    flash_attention,
    flash_bwd,
)
from tpu_flash_torch.ops.flash.backward import recompute_p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Six test workers share the machine: torch's default thread pool
    # would make these small CPU ops many times slower.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, bf16=False):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    top = float(np.abs(ref).max())
    bar = (4 * 2.0 ** (math.floor(math.log2(top)) - 7) if bf16
           else 1e-5 * top)
    err = float(np.abs(got - ref).max())
    assert err <= bar, (err, bar, top)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _segments(b, n, docs, seed):
    """[b, n] int32 ids of ``docs`` contiguous documents per row, cut at
    seeded places."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(b):
        cuts = np.sort(rng.choice(np.arange(1, n), docs - 1, replace=False))
        rows.append(np.searchsorted(cuts, np.arange(n), side="right"))
    return np.asarray(rows, np.int32)


# (name, b, hq, hkv, sq, skv, d, dtype, options). Options: flash_attention
# arguments, plus "sinks"/"alibi"/"segments" (made from the case's seed),
# "dlse" (save_residuals with an lse cotangent) and "blocks" (JAX
# BlockSizes: the triangular K8 grid, or the single-pass K9 pair).
JAX_CASES = [
    ("causal-gqa-softcap-sinks", 2, 4, 2, 64, 64, 32, "float32",
     dict(causal=True, softcap=5.0, sinks=True)),
    ("noncausal-kv-tail", 1, 4, 2, 40, 100, 32, "float32",
     dict(causal=False)),
    ("offset-alibi", 2, 4, 2, 32, 96, 32, "float32",
     dict(causal=True, q_offset=64, alibi=True)),
    ("window", 1, 4, 4, 96, 96, 32, "float32",
     dict(causal=True, window=17)),
    ("segments-gqa", 2, 4, 2, 90, 90, 32, "float32",
     dict(causal=True, segments=3)),
    ("triangular-dlse-sinks", 1, 4, 2, 128, 128, 32, "float32",
     dict(causal=True, sinks=True, dlse=True,
          blocks=BlockSizes(block_q=64, block_kv_major=64, block_kv=64,
                            block_q_dkv=64, block_kv_dkv=64, block_q_dq=64,
                            block_kv_dq=64, triangular=True))),
    ("bf16-segments-gqa", 1, 4, 2, 96, 96, 128, "bfloat16",
     dict(causal=True, segments=2)),
    ("onepass-dlse", 1, 4, 2, 128, 128, 32, "float32",
     dict(causal=True, dlse=True,
          blocks=BlockSizes(block_q=128, block_kv_major=128, block_kv=128,
                            block_q_dkv=128, block_kv_dkv=128,
                            block_q_dq=128, block_kv_dq=128, onepass=True))),
]


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_backward_matches_jax(case, monkeypatch):
    name, b, hq, hkv, sq, skv, d, dtype, opts = case
    opts = dict(opts)
    rng = np.random.default_rng([c[0] for c in JAX_CASES].index(name))
    arrays = [rng.standard_normal(s, dtype=np.float32) for s in
              ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
               (b, hq, sq, d))]
    q, k, v, do = arrays
    j_kw, t_kw = {}, {}
    for key in ("causal", "q_offset", "window", "softcap"):
        if key in opts:
            j_kw[key] = t_kw[key] = opts[key]
    sinks = None
    if opts.get("sinks"):
        sinks = (rng.standard_normal(hq) + 2.0).astype(np.float32)
    if opts.get("alibi"):
        a = np.array([0.5, 0.25, 0.125, 0.0625], np.float32)[:hq]
        j_kw["alibi"], t_kw["alibi"] = jnp.asarray(a), torch.from_numpy(a)
    if opts.get("segments"):
        seg = _segments(b, sq, opts["segments"], 7)
        j_kw["segment_ids"] = (jnp.asarray(seg), jnp.asarray(seg))
        t_kw["segment_ids"] = SegmentIds(torch.from_numpy(seg),
                                         torch.from_numpy(seg))
    if "blocks" in opts:
        j_kw["block_sizes"] = opts["blocks"]
    dlse = None
    if opts.get("dlse"):
        dlse = rng.standard_normal((b, hq, sq), dtype=np.float32)
        j_kw["save_residuals"] = t_kw["save_residuals"] = True
    bf16 = dtype == "bfloat16"

    onepass_calls = []
    real_onepass = j_backward._backward_onepass

    def spy(*a, **kw):
        onepass_calls.append(1)
        return real_onepass(*a, **kw)

    monkeypatch.setattr(j_backward, "_backward_onepass", spy)

    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jargs = [jq, jk, jv] + ([jnp.asarray(sinks)] if sinks is not None
                            else [])

    def jf(q_, k_, v_, *s_):
        return j_flash(q_, k_, v_, sinks=s_[0] if s_ else None, **j_kw)

    j_out, j_vjp = jax.vjp(jf, *jargs)
    j_cot = jnp.asarray(do, jdt)
    if dlse is not None:
        j_cot = (j_cot, jnp.asarray(dlse))
    j_grads = j_vjp(j_cot)

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    targs = [tq, tk, tv]
    if sinks is not None:
        targs.append(torch.from_numpy(sinks).requires_grad_())
    t_out = flash_attention(tq, tk, tv, sinks=targs[3] if sinks is not None
                            else None, **t_kw)
    t_cot = torch.from_numpy(do).to(tdt)
    if dlse is not None:
        torch.autograd.backward(t_out, (t_cot, torch.from_numpy(dlse)))
        _close(_np(t_out[1]), _np(j_out[1]), bf16=False)
        _close(_np(t_out[0]), _np(j_out[0]), bf16=bf16)
    else:
        t_out.backward(t_cot)
        _close(_np(t_out), _np(j_out), bf16=bf16)
    for name_, tg, jg in zip("q k v sinks".split(), targs, j_grads):
        assert torch.isfinite(tg.grad).all(), name_
        _close(_np(tg.grad), _np(jg), bf16=bf16 and name_ != "sinks")
    if opts.get("blocks") is not None and opts["blocks"].onepass:
        assert onepass_calls, "the JAX side did not take the K9 route"


def _torch_inputs(seed, b, hq, hkv, sq, skv, d):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g) for s in
            ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
             (b, hq, sq, d))]


OPTION_SETS = {
    "noncausal": dict(causal=False),
    "causal": dict(causal=True),
    "offset": dict(causal=True, q_offset=24),
    "window": dict(causal=True, window=9),
    "softcap": dict(causal=True, softcap=3.0),
    "sinks": dict(causal=True, sinks=True),
    "alibi": dict(causal=True, q_offset=8, alibi=True),
    "segments": dict(causal=True, segments=3),
    "segments-noncausal": dict(causal=False, segments=2),
    "everything": dict(causal=True, window=20, softcap=4.0, sinks=True,
                       alibi=True, segments=2),
}


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_backward_matches_reference_autograd(name, groups):
    """f32 gradients of q, k, v (and sinks) against torch autograd of the
    plain reference, over every option and GQA ratio, at 1e-5 of max
    |ref|. kv runs 24 past q with ``q_offset``, so the kv tiles are ragged
    (sq 40, 64-row tiles)."""
    opts = dict(OPTION_SETS[name])
    hq = 4
    sq = 40
    skv = sq + opts.get("q_offset", 0)
    q, k, v, do = _torch_inputs(sorted(OPTION_SETS).index(name), 2, hq,
                                hq // groups, sq, skv, 16)
    kw = {key: opts[key] for key in ("causal", "q_offset", "window",
                                     "softcap") if key in opts}
    ref_kw = dict(kw)
    g = torch.Generator().manual_seed(groups)
    leaves = [q, k, v]
    if opts.get("sinks"):
        leaves.append(torch.randn(hq, generator=g) + 1.0)
        kw["sinks"] = ref_kw["sinks"] = leaves[-1]
    if opts.get("alibi"):
        kw["alibi"] = ref_kw["alibi"] = torch.tensor([0.5, 0.3, 0.2, 0.1])
    if opts.get("segments"):
        seg = torch.from_numpy(_segments(2, sq, opts["segments"], groups))
        kw["segment_ids"] = SegmentIds(seg, seg)
        ref_kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    for t in leaves:
        t.requires_grad_()
    got = torch.autograd.grad(flash_attention(q, k, v, **kw), leaves, do)
    want = torch.autograd.grad(
        reference_gqa_attention(q, k, v, **ref_kw), leaves, do)
    for a, r in zip(got, want):
        _close(_np(a), _np(r))


@pytest.mark.parametrize("name", ["causal", "offset", "sinks", "everything"])
def test_bf16_backward_tracks_f32(name):
    """bf16 inputs through the port against the same values in f32: dS
    and every output round to bf16, so the bar is 1e-2 of max |f32 ref|
    (each rounding is 2^-9 relative, and they average over the sums)."""
    opts = dict(OPTION_SETS[name])
    sq = 64
    skv = sq + opts.get("q_offset", 0)
    q, k, v, do = (t.bfloat16().float() for t in
                   _torch_inputs(11, 1, 4, 2, sq, skv, 32))
    kw = {key: opts[key] for key in ("causal", "q_offset", "window",
                                     "softcap") if key in opts}
    if opts.get("sinks"):
        kw["sinks"] = torch.full((4,), 2.0)
    if opts.get("alibi"):
        kw["alibi"] = torch.tensor([0.5, 0.3, 0.2, 0.1])
    if opts.get("segments"):
        seg = torch.from_numpy(_segments(1, sq, opts["segments"], 3))
        kw["segment_ids"] = (seg, seg)
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        leaves = [t.to(dt).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, **kw)
        grads[dt] = torch.autograd.grad(out, leaves, do.to(dt))
    for a, r in zip(grads[torch.bfloat16], grads[torch.float32]):
        top = float(r.abs().max())
        assert float((a.float() - r).abs().max()) <= 1e-2 * top


def test_lse_cotangent_matches_autograd_of_logsumexp():
    """save_residuals=True is differentiable through lse (di_eff = di -
    dlse), and the sink gradient takes dlse too: against autograd of an
    explicit masked logsumexp with a sink column."""
    q, k, v, do = _torch_inputs(5, 2, 4, 2, 48, 48, 16)
    g = torch.Generator().manual_seed(5)
    sinks = torch.randn(4, generator=g)
    dlse = torch.randn(2, 4, 48, generator=g)
    leaves = [t.requires_grad_() for t in (q, k, v, sinks)]
    o, lse = flash_attention(q, k, v, causal=True, window=30, sinks=sinks,
                             save_residuals=True)
    got = torch.autograd.grad((o, lse), leaves, (do, dlse))

    kr, vr = (t.repeat_interleave(2, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr) * 16 ** -0.5
    i = torch.arange(48)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 30)
    s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    full = torch.cat([s, sinks[None, :, None, None].expand(2, 4, 48, 1)], -1)
    ref_lse = torch.logsumexp(full, -1)
    ref_o = torch.einsum("bhqk,bhkd->bhqd",
                         torch.softmax(full, -1)[..., :-1], vr)
    want = torch.autograd.grad((ref_o, ref_lse), leaves, (do, dlse))
    _close(_np(lse), _np(ref_lse))
    for a, r in zip(got, want):
        _close(_np(a), _np(r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recomputed_p_sums_to_one_against_forward_lse(dtype):
    """The backward recomputes P with the f32 scale the JAX backward uses,
    against the lse the forward took with the scale rounded to q's dtype
    (and q scaled in it): P's rows (with the sink's share) sum to 1 to
    1e-5 in f32, and to 2e-2 in bf16 (q * scale rounded to bf16 moves
    each score by up to 2^-9 of its terms)."""
    q, k, v, _ = (t.to(dtype) for t in _torch_inputs(6, 1, 4, 2, 96, 96,
                                                      128))
    sinks = torch.full((4,), 1.5)
    o, lse = flash_attention(q, k, v, causal=True, sinks=sinks,
                             save_residuals=True)
    p, _ = recompute_p(q.float().reshape(1, 2, 2, 96, 128), k.float(),
                       lse.reshape(1, 2, 2, 96, 1), 0, causal=True,
                       sm_scale=128 ** -0.5)
    total = p.sum(-1).reshape(1, 4, 96) + torch.exp(
        sinks[None, :, None] - lse)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((total - 1.0).abs().max()) <= tol


def test_masked_rows_give_zero_gradients_not_nan():
    """A q row whose segment has no key, and a kv tail filled with NaN
    (``kv_len`` 50 of 64 rows), give finite gradients: zero for the
    masked rows and the tail, as the JAX kernel's masked P = 0 does."""
    q, k, v, do = _torch_inputs(8, 1, 4, 2, 32, 64, 16)
    k[:, :, 50:] = float("nan")
    v[:, :, 50:] = float("nan")
    q_seg = torch.zeros(1, 32, dtype=torch.int32)
    q_seg[:, 20:] = 9  # no kv row has id 9
    kv_seg = torch.zeros(1, 64, dtype=torch.int32)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o = flash_attention(q, k, v, causal=False, kv_len=50,
                        segment_ids=(q_seg, kv_seg))
    dq, dk, dv = torch.autograd.grad(o, leaves, do)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    assert float(dq[:, :, 20:].abs().max()) == 0.0
    assert float(dk[:, :, 50:].abs().max()) == 0.0
    assert float(dv[:, :, 50:].abs().max()) == 0.0
    assert float(dq[:, :, :20].abs().max()) > 0.0


def test_gqa_group_sum_rounds_each_partial_first():
    """dK/dV are summed over each GQA group from per-q-head partials that
    were each rounded to k's dtype (the JAX backward's order)."""
    q, k, v, do = (t.bfloat16() for t in _torch_inputs(9, 1, 4, 2, 64, 64,
                                                       32))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o, lse = flash_attention(*leaves, causal=True, save_residuals=True)
    _, dk, dv = torch.autograd.grad(o, leaves, do)
    _, dk_h, dv_h = flash_bwd(q.detach(), k.detach(), v.detach(),
                              o.detach(), do, lse.detach(), causal=True,
                              sm_scale=32 ** -0.5)
    assert dk_h.dtype == torch.bfloat16 and dk_h.shape == (1, 4, 64, 32)
    torch.testing.assert_close(dk, dk_h.reshape(1, 2, 2, 64, 32).sum(2),
                               rtol=0, atol=0)
    torch.testing.assert_close(dv, dv_h.reshape(1, 2, 2, 64, 32).sum(2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("part", ["dkv", "dq"])
@pytest.mark.parametrize("name", ["causal", "everything"])
def test_plain_part_gives_one_kernels_outputs(name, part):
    """``part`` runs the plain version of one kernel: its outputs equal
    the whole plain backward's bit for bit, the other kernel's are None."""
    from tpu_flash_torch.ops.flash.backward import flash_bwd_plain

    q, k, v, do = (t.bfloat16() for t in _torch_inputs(11, 2, 4, 2, 40, 40,
                                                       16))
    kw = dict(causal=True, sm_scale=16 ** -0.5)
    if name == "everything":
        seg = torch.from_numpy(_segments(2, 40, 2, 5))
        kw.update(window=20, softcap=4.0, alibi=torch.tensor(
            [0.5, 0.3, 0.2, 0.1]), q_seg=seg, kv_seg=seg,
            dlse=torch.randn(2, 4, 40))
    o = torch.randn_like(q)
    lse = torch.randn(2, 4, 40) + 4.0
    whole = flash_bwd_plain(q, k, v, o, do, lse, **kw)
    got = flash_bwd_plain(q, k, v, o, do, lse, part=part, **kw)
    keep = (0,) if part == "dq" else (1, 2)
    for i, (a, w) in enumerate(zip(got, whole)):
        if i in keep:
            torch.testing.assert_close(a, w, rtol=0, atol=0)
        else:
            assert a is None


def _round_p_case(name, dtype):
    """(args, kw) of the plain backward on a forward's own o and lse:
    b 2, 4 q / 2 kv heads, 40 rows, d 16."""
    q, k, v, do = (t.to(dtype) for t in _torch_inputs(12, 2, 4, 2, 40, 40,
                                                      16))
    fkw, kw = dict(causal=True), {}
    if name == "everything":
        seg = torch.from_numpy(_segments(2, 40, 2, 6))
        fkw.update(window=20, softcap=4.0,
                   alibi=torch.tensor([0.5, 0.3, 0.2, 0.1]),
                   segment_ids=SegmentIds(seg, seg))
        kw.update(q_seg=seg, kv_seg=seg, dlse=torch.randn(2, 4, 40))
    o, lse = flash_attention(q, k, v, save_residuals=True, **fkw)
    fkw.pop("segment_ids", None)
    return (q, k, v, o, do, lse), dict(fkw, **kw, sm_scale=16 ** -0.5)


@pytest.mark.parametrize("name", ["causal", "everything"])
def test_round_p_moves_only_dv_within_p_rounding(name):
    """``round_p=True`` (the bf16 kernels' bf16 P in the dV product)
    leaves dQ and dK bit for bit (dS keeps the f32 P) and moves dV by at
    most the rounding of P: round-to-nearest-even in bf16 moves each p by
    at most 2^-8 p, so the f32 sum moves by at most 2^-8 sum_q p |dO|,
    plus one bf16 ulp of the output where the final rounding flips."""
    from tpu_flash_torch.ops.flash.backward import flash_bwd_plain

    args, kw = _round_p_case(name, torch.bfloat16)
    exact = flash_bwd_plain(*args, **kw)
    rounded = flash_bwd_plain(*args, round_p=True, **kw)
    for a, w in zip(rounded[:2], exact[:2]):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    q, k, _, _, do, lse = args
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    p, _ = recompute_p(
        q.float().reshape(b, hkv, hq // hkv, sq, d), k.float(),
        lse.reshape(b, hkv, hq // hkv, sq, 1), 0, causal=True,
        sm_scale=kw["sm_scale"], window=kw.get("window"),
        softcap=kw.get("softcap"), alibi=kw.get("alibi"),
        q_seg=kw.get("q_seg"), kv_seg=kw.get("kv_seg"))
    moved = 2.0 ** -8 * torch.einsum(
        "bhgqk,bhgqd->bhgkd", p,
        do.float().abs().reshape(b, hkv, hq // hkv, sq, d)).reshape(
            b, hq, -1, d)
    dv_r, dv_e = rounded[2].float(), exact[2].float()
    top = torch.maximum(dv_r.abs(), dv_e.abs())
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
    assert bool(((dv_r - dv_e).abs() <= moved + ulp).all())
    assert not torch.equal(dv_r, dv_e)  # the rounding does reach dV


def test_round_p_changes_nothing_in_f32():
    """P rounds to the input dtype: on f32 inputs round_p is a no-op."""
    from tpu_flash_torch.ops.flash.backward import flash_bwd_plain

    args, kw = _round_p_case("everything", torch.float32)
    for a, w in zip(flash_bwd_plain(*args, round_p=True, **kw),
                    flash_bwd_plain(*args, **kw)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


@pytest.mark.parametrize("part", ["dkv", "dq"])
def test_round_p_keeps_part(part):
    """``part`` with ``round_p``: the one kernel's outputs equal the whole
    rounded backward's bit for bit, the other kernel's are None."""
    from tpu_flash_torch.ops.flash.backward import flash_bwd_plain

    args, kw = _round_p_case("everything", torch.bfloat16)
    whole = flash_bwd_plain(*args, round_p=True, **kw)
    got = flash_bwd_plain(*args, round_p=True, part=part, **kw)
    keep = (0,) if part == "dq" else (1, 2)
    for i, (a, w) in enumerate(zip(got, whole)):
        if i in keep:
            torch.testing.assert_close(a, w, rtol=0, atol=0)
        else:
            assert a is None


def test_forward_without_grad_skips_autograd():
    """With no input requiring grad (or in no_grad), the forward kernel
    runs alone: no graph node, no saved residuals."""
    q, k, v, _ = _torch_inputs(10, 1, 4, 2, 16, 16, 16)
    assert flash_attention(q, k, v, causal=True).grad_fn is None
    q.requires_grad_()
    out = flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert FlashAttentionFn.__name__ in type(out.grad_fn).__name__
    with torch.no_grad():
        assert flash_attention(q, k, v, causal=True).grad_fn is None


def test_segment_forward_matches_jax():
    """The forward with segment ids (f32, GQA, causal and not) against
    the JAX forward, at 1e-5 of max |ref|; on the TPU route segment ids
    reach only the rectangular kernel (K1), here the same kernel as every
    other route."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 4, 72, 32), dtype=np.float32)
    k = rng.standard_normal((2, 2, 72, 32), dtype=np.float32)
    v = rng.standard_normal((2, 2, 72, 32), dtype=np.float32)
    seg = _segments(2, 72, 3, 12)
    for causal in (True, False):
        j = j_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                    segment_ids=(jnp.asarray(seg), jnp.asarray(seg)))
        t = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal,
                            segment_ids=SegmentIds(torch.from_numpy(seg),
                                                   torch.from_numpy(seg)))
        _close(_np(t), _np(j))
