"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips unless a CUDA device is present
(decided inside the test, never at import). Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` because the suite's conftest imports JAX, which a GPU
machine need not have.)

Both sides produce bf16 (or f32) from the same roundings and differ only
in f32 summation order. The flash forward cases hold bars of 2e-2 for
bf16 outputs (one bf16 ulp at magnitude < 2), 1e-4 for f32. Paged decode
has no summation order (exact products summed in f64, rounded once, on
both sides), so its cases hold the plain version's output bit for bit. The paged and ragged prefill cases take each case's bar from its own
reference (``_case_bar``, the bar of chip_smoke.py's phase 3): 2 bf16
ulps of max |ref| for bf16 outputs -- a flipped output rounding is one
ulp, a flipped bf16 P element moves an output by a small part of one --
and 2^-12 of max |ref| for f32 outputs, which keep no bf16 rounding here
(f32 q promotes bf16 and int8 history to f32, and P rounds to f32). Each
of those cases also holds a control: the kernel against the plain
version without the case's offsets or options must miss the bar. Their
tile-edge cases (``TILE_EDGES``) hold each row at its own bar, as
chip_smoke.py's phase 3 does, with a late-row control (V raised 3%). The
bf16 backward kernels take P in bf16 for the dV product (tensor-core
operands, as the TPU kernel's single bf16 MXU pass), so their bf16 cases
hold the plain version with ``round_p=True``; f32 cases the default. The
backward and the variant kernel (K13) are held with a bar per row
(``_row_bars``: the same rule at each row's own max |ref|), so a late
causal row, whose outputs are far under row 0's, is held at its own
scale; a late-row control must miss most late rows' bars. So is the
attention-weights kernel (K12), whose bf16 scores sum on the tensor
cores and f32 scores in three TF32 passes.
"""

import math
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _case_bar(ref):
    top = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return 2.0 ** -12 * top


def _row_bars(ref):
    """_case_bar's rule for each row (last axis) at the row's own max
    |ref|: a late causal row is held at its own scale, not at row 0's.
    A row of zeros gets a bar of 0."""
    top = ref.float().abs().amax(-1)
    if ref.dtype != torch.bfloat16:
        return 2.0 ** -12 * top
    bars = 2 * torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
    return torch.where(top > 0, bars, torch.zeros_like(top))


def _check_with_control(out, ref, control):
    """out within ref's bar, and out off the control by more than it."""
    bar = _case_bar(ref)
    assert (out.float() - ref.float()).abs().max() <= bar
    assert (out.float() - control.float()).abs().max() > bar


def _row_off(out, ref):
    return (out.float() - ref.float()).abs().amax(-1)


def _check_rows_with_control(out, ref, control, grad, late=None):
    """Each row of out within its bar of ref (_row_bars); out off the
    control (None: no control) by more than the bar in some row; and
    ``late``, a pair (shifted reference, first late row), off by more
    than the bar in at least 90% of the rows from that row on that keep
    their own bar (at most half may not). A bf16 dQ or dK (``grad``)
    row's bar is at least 2^-16 of max |ref|: where a q row puts P near 1
    on one key, dS = P (dP - di) cancels to f32 noise (~2^-21 of max |dQ|
    in a row that sees one key) that the tensor-core kernels and the
    plain version sum in different orders. dV = P^T dO subtracts nothing,
    and the f32 kernels take dP in the plain version's order where dP -
    di cancels (csrc/flash_bwd.cu, p_and_ds: P > 1/2; P > 1/64 with
    |dP - di| under 1/8 of max(|dP|, |di|); any P on a masked step with
    it under 1/64): no floor."""
    own = _row_bars(ref)
    floor = grad != "dv" and ref.dtype == torch.bfloat16
    bars = own.clamp_min(2.0 ** -16 * float(ref.float().abs().max())) \
        if floor else own
    assert (_row_off(out, ref) <= bars).all()
    if control is not None:
        assert (_row_off(out, control) > bars).any()
    if late is not None:
        shifted, first = late
        held = (bars == own)[..., first:]
        assert held.float().mean() >= 0.5
        caught = _row_off(out, shifted)[..., first:] > bars[..., first:]
        assert caught[held].float().mean() >= 0.9


def _late_do(do):
    """dO with every q row past s/2 raised by 2^-4 of itself: rows past
    s/2 of dQ, dK and dV of a causal backward with sq = skv grow as much
    (only those q rows reach them), four times the largest bf16 row bar,
    so a row is seen even where the kernel is off by a whole bar."""
    out = do.clone()
    out[..., do.shape[-2] // 2:, :] *= 1.0625
    return out


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


def _rn(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "kw,sq,skv",
    [
        (dict(causal=True), 300, 300),
        (dict(causal=True, q_offset=200), 100, 300),
        (dict(causal=False, kv_len=250), 70, 300),
        (dict(causal=True, window=77, softcap=5.0), 300, 300),
        (dict(causal=True, sinks=True, alibi=True, save_lse=True), 200, 200),
        # Edges inside the bf16 kernel's tiles (128 q rows, 128-column
        # steps): an offset off the step, a kv tail mid-step, a window
        # edge crossing staged tiles.
        (dict(causal=True, q_offset=1000), 500, 1500),
        (dict(causal=False, kv_len=1000), 512, 1024),
        (dict(causal=True, window=200), 512, 512),
    ],
    ids=["causal", "chunk", "noncausal-tail", "window-softcap",
         "sinks-alibi-lse", "offset-unaligned", "kv-tail-mid-step",
         "window-unaligned"],
)
def test_flash_fwd_kernel_matches_plain(dev, dtype, kw, sq, skv):
    from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain

    g = torch.Generator(device=dev).manual_seed(0)
    q = _rn(g, 2, 8, sq, 128, dtype=dtype)
    k, v = _rn(g, 2, 2, skv, 128, dtype=dtype), _rn(g, 2, 2, skv, 128,
                                                    dtype=dtype)
    kw = dict(kw)
    if kw.pop("sinks", False):
        kw["sinks"] = _rn(g, 8)
    if kw.pop("alibi", False):
        kw["alibi"] = torch.linspace(0.3, 0.01, 8, device=dev)
    out = flash_fwd(q, k, v, sm_scale=128 ** -0.5, **kw)
    torch.cuda.synchronize()
    ref = flash_fwd_plain(q, k, v, sm_scale=128 ** -0.5, **kw)
    if kw.get("save_lse"):
        assert (out[1] - ref[1]).abs().max() <= 1e-4
        out, ref = out[0], ref[0]
    assert (out.float() - ref.float()).abs().max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fwd_exact_matches_plain(dev, dtype, d):
    """The order-exact entry (the CUDA-core kernel the serving engine
    takes) against the plain version within the case's bar, the
    non-causal control outside it, at each width."""
    from tpu_flash_torch.ops.flash.forward import (flash_fwd_exact,
                                                   flash_fwd_plain)

    g = torch.Generator(device=dev).manual_seed(9)
    q = _rn(g, 2, 4, 300, d, dtype=dtype)
    k, v = _rn(g, 2, 2, 300, d, dtype=dtype), _rn(g, 2, 2, 300, d,
                                                  dtype=dtype)
    kw = dict(sm_scale=d ** -0.5, causal=True, window=200)
    out = flash_fwd_exact(q, k, v, **kw)
    torch.cuda.synchronize()
    _check_with_control(out, flash_fwd_plain(q, k, v, **kw),
                        flash_fwd_plain(q, k, v, sm_scale=d ** -0.5,
                                        causal=False))


def _smoke():
    """chip_smoke.py, whose kernel routing, controls and card checks these
    tests share with it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("entry", ["flash_fwd", "flash_fwd_exact"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fwd_rows_that_see_no_key_match_plain(dev, d, entry):
    """bf16, both entries: every row within its bar of the plain
    version's (_row_bars), the rows that see no key too; the control
    (those rows averaging only the last step's keys) missed in some row;
    V raised 3% missed in 90% of the rows past s/2; the blind rows' lse
    MASK_VALUE + log(kv_len) within 2^-12 of it, the others' within
    1e-4 of the plain version's."""
    from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
    from tpu_flash_torch.ops.flash import forward

    # causal, a 64-token window, kv_len 300 of 512 keys: rows from
    # BLIND_FIRST (363) on start their window at or past kv_len.
    cs = _smoke()
    g = torch.Generator(device=dev).manual_seed(26)
    hq = 4 if d == 256 else 8
    q = _rn(g, 2, hq, 512, d, dtype=torch.bfloat16)
    k, v = (_rn(g, 2, 2, 512, d, dtype=torch.bfloat16) for _ in range(2))
    kw = dict(cs.BLIND, sm_scale=d ** -0.5)
    out, lse = getattr(forward, entry)(q, k, v, save_lse=True, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = forward.flash_fwd_plain(q, k, v, save_lse=True, **kw)
    late = forward.flash_fwd_plain(q, k, v * 1.03, **kw)
    _check_rows_with_control(
        out, ref, cs.blind_control(ref, v, cs.BLIND["kv_len"],
                                   cs.BLIND_FIRST),
        None, (late, 256))
    want = torch.tensor(DEFAULT_MASK_VALUE) + math.log(cs.BLIND["kv_len"])
    first = cs.BLIND_FIRST
    blind = lse[..., first:]
    assert ((blind - want).abs() <= 2.0 ** -12 * abs(float(want))).all()
    assert (lse[..., :first] - ref_lse[..., :first]).abs().max() <= 1e-4


@pytest.mark.parametrize("entry", ["flash_fwd", "flash_fwd_exact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_orphan_segment_rows_match_plain(dev, dtype, entry):
    """Rows whose q segment no key carries (chip_smoke.py's
    ``orphan_inputs``, d 128), both entries: every row within its bar of
    the plain version's, those rows too (the mean of V[:kv_len]); the
    control (rows 40-59 averaging the first step's V) missed in some row;
    V raised 3% missed in 90% of the rows past s/2; the orphan rows' lse
    MASK_VALUE + log(kv_len) within 2^-12 of it."""
    from tpu_flash_torch.core.reference import DEFAULT_MASK_VALUE
    from tpu_flash_torch.ops.flash import forward

    cs = _smoke()
    q, k, v, kw = cs.orphan_inputs(dev, dtype)
    out, lse = getattr(forward, entry)(q, k, v, save_lse=True, **kw)
    torch.cuda.synchronize()
    ref = forward.flash_fwd_plain(q, k, v, **kw)
    ctl = ref.clone()
    lo, hi = cs.ORPHAN_ROWS[0]
    ctl[:, :, lo:hi] = v[:, :, :128].float().mean(2).repeat_interleave(
        4, 1)[:, :, None].to(dtype)
    late = forward.flash_fwd_plain(q, k, v * 1.03, **kw)
    _check_rows_with_control(out, ref, ctl, None, (late, 256))
    want = torch.tensor(DEFAULT_MASK_VALUE) + math.log(kw["kv_len"])
    for lo, hi in cs.ORPHAN_ROWS:
        rows = lse[..., lo:hi]
        assert ((rows - want).abs() <= 2.0 ** -12 * abs(float(want))).all()


DECODE_TIERS = {  # name: (K tier, V tier, paged_attention options)
    "float32": ("float32", "float32", {}),
    "bfloat16": ("bfloat16", "bfloat16", {}),
    "int8-mxu": ("int8", "int8", dict(int8_mxu=True)),
    "int8-exact": ("int8", "int8", dict(int8_mxu=False)),
    "int4-mxu": ("int4", "int4", dict(int8_mxu=True)),
    "int4-exact": ("int4", "int4", dict(int8_mxu=False)),
    "int4g32": ("int4g32", "int4g32", {}),
    "k8v4-mxu": ("int8", "int4", dict(int8_mxu=True)),
    "k8v4-exact": ("int8", "int4", dict(int8_mxu=False)),
    "fp8-native": ("fp8", "fp8", dict(fp8_native=True)),
    "fp8-exact": ("fp8", "fp8", dict(fp8_native=False)),
}


def _decode_pages(kp, vp, tier):
    from tpu_flash_torch.ops.quant import quantize_pages

    k_t, v_t, opts = DECODE_TIERS[tier]
    pages = []
    for x, t in ((kp, k_t), (vp, v_t)):
        pages.append(x.to(getattr(torch, t)) if t in ("float32", "bfloat16")
                     else quantize_pages(x, t))
    return pages[0], pages[1], opts


@pytest.mark.parametrize("tier", list(DECODE_TIERS))
@pytest.mark.parametrize(
    "opts",
    [dict(), dict(pages_per_compute_block=2, window=20),
     dict(softcap=4.0, sinks=True, alibi=True), dict(ring=32),
     dict(return_state=True)],
    ids=["plain", "2blk-window", "softcap-sinks-alibi", "ring32", "state"],
)
def test_paged_decode_kernel_matches_plain(dev, tier, opts):
    from tpu_flash_torch.ops.decode import paged

    g = torch.Generator(device=dev).manual_seed(1)
    b, hq, hkv, ps, pps, n_pages = 3, 8, 2, 16, 8, 40
    lengths = torch.tensor([128, 57, 1], dtype=torch.int32, device=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    kp, vp = _rn(g, hkv, n_pages, ps, 128), _rn(g, hkv, n_pages, ps, 128)
    kp, vp, tier_opts = _decode_pages(kp, vp, tier)
    q = _rn(g, b, hq, 128, dtype=torch.bfloat16)
    kw = dict(opts, **tier_opts)
    if kw.pop("sinks", False):
        kw["sinks"] = _rn(g, hq)
    if kw.pop("alibi", False):
        kw["alibi"] = torch.linspace(0.3, 0.01, hq, device=dev)
    w = kw.pop("ring", 0)
    if w:
        kw["recent_k"] = _rn(g, b, hkv, w, 128, dtype=torch.bfloat16)
        kw["recent_v"] = _rn(g, b, hkv, w, 128, dtype=torch.bfloat16)
    before = paged.build.PAGED_DECODE.launches
    out = paged.paged_attention(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    assert paged.build.PAGED_DECODE.launches == before + 1
    saved = paged._paged_decode_cuda
    paged._paged_decode_cuda = paged.paged_decode_plain
    try:
        ref = paged.paged_attention(q, kp, vp, lengths, table, **kw)
    finally:
        paged._paged_decode_cuda = saved
    state = kw.get("return_state")
    for a, r in zip(out if state else (out,), ref if state else (ref,)):
        assert torch.equal(a, r)


@pytest.mark.parametrize("tier", ["bfloat16", "int8-mxu"])
def test_paged_decode_wide_group_bit_exact(dev, tier):
    """16 q heads a kv head (hq 64 / hkv 4), twice what one launch holds:
    the wrapper launches once per 8-head chunk, and the output (sinks and
    ALiBi per q head) is the plain version's bit for bit."""
    from tpu_flash_torch.ops.decode import paged

    g = torch.Generator(device=dev).manual_seed(7)
    b, hq, hkv, ps, pps, n_pages = 3, 64, 4, 16, 8, 40
    lengths = torch.tensor([128, 57, 1], dtype=torch.int32, device=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    kp, vp = _rn(g, hkv, n_pages, ps, 128), _rn(g, hkv, n_pages, ps, 128)
    kp, vp, kw = _decode_pages(kp, vp, tier)
    q = _rn(g, b, hq, 128, dtype=torch.bfloat16)
    kw = dict(kw, sinks=_rn(g, hq),
              alibi=torch.linspace(0.3, 0.01, hq, device=dev))
    before = paged.build.PAGED_DECODE.launches
    out = paged.paged_attention(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    assert paged.build.PAGED_DECODE.launches == before + 2
    saved = paged._paged_decode_cuda
    paged._paged_decode_cuda = paged.paged_decode_plain
    try:
        ref = paged.paged_attention(q, kp, vp, lengths, table, **kw)
    finally:
        paged._paged_decode_cuda = saved
    assert torch.equal(out, ref)


def test_cuda_tensor_never_takes_the_plain_path(dev):
    """A CUDA tensor the kernel does not serve raises; it is not routed to
    the plain version."""
    from tpu_flash_torch.ops.flash import flash_attention

    q = torch.zeros(1, 2, 8, 96, device=dev)  # the kernel serves 64 and 128
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    # A tier pair the decode kernel is not built for raises too.
    from tpu_flash_torch.ops.decode import paged_attention
    from tpu_flash_torch.ops.quant import quantize_pages

    pages = torch.randn(2, 4, 16, 128, device=dev)
    qd = torch.zeros(1, 8, 128, device=dev)
    with pytest.raises(ValueError, match="no int4_mxu K / int8_mxu V"):
        paged_attention(qd, quantize_pages(pages, "int4"),
                        quantize_pages(pages, "int8"),
                        torch.ones(1, dtype=torch.int32, device=dev),
                        torch.zeros(1, 4, dtype=torch.int32, device=dev))


def _prefill_inputs(g, dtype, q_len, offsets, pps=16, ps=16, n_pages=80):
    b = len(offsets)
    q = _rn(g, b, 8, q_len, 128, dtype=dtype)
    ck = _rn(g, b, 2, q_len, 128, dtype=dtype)
    cv = _rn(g, b, 2, q_len, 128, dtype=dtype)
    table = torch.randperm(n_pages, generator=g, device=g.device)[
        : b * pps].reshape(b, pps).int()
    offs = torch.tensor(offsets, dtype=torch.int32, device=g.device)
    return q, ck, cv, table, offs


OPTIONS = ("window", "softcap", "sinks", "alibi")


def _control(kw, offs):
    """The case's control: without its options where it has any, else
    with no history (every offset 0)."""
    if any(k in kw for k in OPTIONS):
        return {k: v for k, v in kw.items() if k not in OPTIONS}, offs
    return kw, torch.zeros_like(offs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8", "int4",
                                   "fp8"])
@pytest.mark.parametrize(
    "case",
    [dict(q_len=300, offsets=(0, 64, 250), pages_per_compute_block=4),
     dict(q_len=9, offsets=(100, 255, 1)),
     dict(q_len=200, offsets=(37, 160, 0), window=77, softcap=5.0,
          sinks=True, alibi=True)],
    ids=["chunk-mixed", "verify", "window-softcap-sinks-alibi"],
)
def test_paged_prefill_kernel_matches_plain(dev, dtype, pages, case):
    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.quant import quantize_pages

    g = torch.Generator(device=dev).manual_seed(2)
    kw = dict(case)
    q, ck, cv, table, offs = _prefill_inputs(g, dtype, kw.pop("q_len"),
                                             kw.pop("offsets"))
    kp, vp = _rn(g, 2, 80, 16, 128), _rn(g, 2, 80, 16, 128)
    if pages in ("int8", "int4", "fp8"):
        kp, vp = quantize_pages(kp, pages), quantize_pages(vp, pages)
    else:
        kp, vp = kp.to(getattr(torch, pages)), vp.to(getattr(torch, pages))
    if kw.pop("sinks", False):
        kw["sinks"] = _rn(g, 8)
    if kw.pop("alibi", False):
        kw["alibi"] = torch.linspace(0.3, 0.01, 8, device=dev)
    before = pp.build.PAGED_PREFILL.launches
    out = pp.paged_prefill_attention(q, ck, cv, kp, vp, offs, table,
                                     hist_cap=256, **kw)
    torch.cuda.synchronize()
    assert pp.build.PAGED_PREFILL.launches == before + 1
    saved = pp._paged_prefill_cuda
    pp._paged_prefill_cuda = pp.paged_prefill_plain
    try:
        ref = pp.paged_prefill_attention(q, ck, cv, kp, vp, offs, table,
                                         hist_cap=256, **kw)
        ckw, coffs = _control(kw, offs)
        control = pp.paged_prefill_attention(q, ck, cv, kp, vp, coffs,
                                             table, hist_cap=256, **ckw)
    finally:
        pp._paged_prefill_cuda = saved
    _check_with_control(out, ref, control)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "case",
    [dict(q_len=300, hist_cap=200, offsets=(0, 130, 200)),
     dict(q_len=1, hist_cap=256, offsets=(9, 256, 140)),
     dict(q_len=200, hist_cap=128, offsets=(128, 5, 77), window=50,
          softcap=5.0, sinks=True, alibi=True)],
    ids=["mixed", "decode-rows", "window-softcap-sinks-alibi"],
)
def test_ragged_prefill_kernel_matches_plain(dev, dtype, case):
    from tpu_flash_torch.ops.flash import ragged

    g = torch.Generator(device=dev).manual_seed(3)
    kw = dict(case)
    q_len, hist_cap = kw.pop("q_len"), kw.pop("hist_cap")
    offs = torch.tensor(kw.pop("offsets"), dtype=torch.int32, device=dev)
    b = offs.shape[0]
    q = _rn(g, b, 8, q_len, 128, dtype=dtype)
    k = _rn(g, b, 2, hist_cap + q_len, 128, dtype=dtype)
    v = _rn(g, b, 2, hist_cap + q_len, 128, dtype=dtype)
    for i, o in enumerate(offs.tolist()):  # garbage past each offset
        k[i, :, o:hist_cap] = float("nan")
        v[i, :, o:hist_cap] = float("nan")
    if kw.pop("sinks", False):
        kw["sinks"] = _rn(g, 8)
    if kw.pop("alibi", False):
        kw["alibi"] = torch.linspace(0.3, 0.01, 8, device=dev)
    before = ragged.build.RAGGED_PREFILL.launches
    out = ragged.flash_attention_ragged(q, k, v, offs, hist_cap=hist_cap,
                                        **kw)
    torch.cuda.synchronize()
    assert ragged.build.RAGGED_PREFILL.launches == before + 1
    assert torch.isfinite(out).all()

    def plain(offs, **kw):
        return ragged.ragged_prefill_plain(
            q, k, v, offs, hist_cap=hist_cap, sm_scale=128 ** -0.5,
            block_kv=ragged.TILES.ragged_block_kv, **kw,
        )

    ckw, coffs = _control(kw, offs)
    _check_with_control(out, plain(offs, **kw), plain(coffs, **ckw))


# The order-exact prefill tile's edges (csrc/prefill_tile.cuh: 64-row
# steps, 128-column windows at d 128 and 64 at d 256, score scratch for
# blocks of several windows): name -> (head width, q_len, hist_cap,
# offsets, options, control). The control is other offsets (rounded to a
# window) or, for a case with options, the options it keeps.
TILE_EDGES = {
    "offsets-unaligned": (128, 200, 384, (37, 130, 250, 383), {},
                          (0, 128, 256, 384)),
    "offset-0-and-cap": (128, 200, 384, (0, 384, 0, 384), {},
                         (128, 256, 128, 256)),
    "length-1-rows": (128, 1, 384, (1, 129, 383, 384), {}, (0, 0, 0, 0)),
    "window-in-step": (128, 200, 384, (0, 100, 300, 384), dict(window=70),
                       {}),
    "gemma-d256-softcap": (256, 64, 256, (0, 100, 256, 37),
                           dict(softcap=50.0, window=120),
                           dict(softcap=50.0)),
}


# Each edge in both dtypes; Gemma-2's geometry in bf16, which it serves.
TILE_EDGE_PARAMS = [(c, dt) for c in TILE_EDGES
                    for dt in (torch.float32, torch.bfloat16)
                    if not (c.startswith("gemma") and dt == torch.float32)]


def _tile_edge_case(g, name, dtype):
    d, q_len, hist_cap, offsets, kw, control = TILE_EDGES[name]
    qstd = 4.0 if d == 256 else 1.0
    q = _rn(g, len(offsets), 8, q_len, d, dtype=dtype) * qstd
    offs = torch.tensor(offsets, dtype=torch.int32, device=g.device)
    if isinstance(control, dict):
        ckw, coffs = control, offs
    else:
        ckw, coffs = kw, torch.tensor(control, dtype=torch.int32,
                                      device=g.device)
    return d, q, hist_cap, offs, kw, ckw, coffs


def _raised(v):
    """V raised by 3% (quantized pages through their scales): every
    output row moves by 3% of itself, past its bar."""
    if hasattr(v, "_replace"):
        return v._replace(scales=v.scales * 1.03)
    return (v.float() * 1.03).to(v.dtype)


@pytest.mark.parametrize("case,dtype", TILE_EDGE_PARAMS)
def test_ragged_prefill_tile_edges_match_plain(dev, case, dtype):
    """K6 at the tile's edges, each row within its bar of the plain
    version (_row_bars), the control off some row, the late-row control
    (V raised 3%) off 90% of the rows past q_len / 2."""
    from tpu_flash_torch.ops.flash import ragged

    g = torch.Generator(device=dev).manual_seed(24)
    d, q, hist_cap, offs, kw, ckw, coffs = _tile_edge_case(g, case, dtype)
    b, q_len = q.shape[0], q.shape[2]
    k, v = (_rn(g, b, 2, hist_cap + q_len, d, dtype=dtype)
            for _ in range(2))
    out = ragged.flash_attention_ragged(q, k, v, offs, hist_cap=hist_cap,
                                        **kw)
    torch.cuda.synchronize()

    def plain(offs, v=v, **kw):
        return ragged.ragged_prefill_plain(
            q, k, v, offs, hist_cap=hist_cap, sm_scale=d ** -0.5,
            block_kv=ragged.TILES.ragged_block_kv, **kw)

    _check_rows_with_control(out, plain(offs, **kw), plain(coffs, **ckw),
                             None, late=(plain(offs, v=_raised(v), **kw),
                                         q_len // 2))


@pytest.mark.parametrize("pages", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("case,dtype", TILE_EDGE_PARAMS)
def test_paged_prefill_tile_edges_match_plain(dev, case, dtype, pages):
    """K5 at the tile's edges (32-token pages: a 384-token history block
    spans three windows at d 128, a 200-row chunk block two), held as
    test_ragged_prefill_tile_edges_match_plain holds K6."""
    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.quant import quantize_pages

    g = torch.Generator(device=dev).manual_seed(25)
    d, q, hist_cap, offs, kw, ckw, coffs = _tile_edge_case(g, case, dtype)
    b, q_len = q.shape[0], q.shape[2]
    ps, pps = 32, hist_cap // 32
    n_pages = b * pps + 1
    ck, cv = (_rn(g, b, 2, q_len, d, dtype=dtype) for _ in range(2))
    kp, vp = (_rn(g, 2, n_pages, ps, d) for _ in range(2))
    if pages == "int8":
        kp, vp = quantize_pages(kp, "int8"), quantize_pages(vp, "int8")
    else:
        kp, vp = kp.to(getattr(torch, pages)), vp.to(getattr(torch, pages))
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    before = pp.build.PAGED_PREFILL.launches

    def run(offs, vp=vp, cv=cv, **kw):
        return pp.paged_prefill_attention(q, ck, cv, kp, vp, offs, table,
                                          hist_cap=hist_cap, **kw)

    out = run(offs, **kw)
    torch.cuda.synchronize()
    assert pp.build.PAGED_PREFILL.launches == before + 1
    saved = pp._paged_prefill_cuda
    pp._paged_prefill_cuda = pp.paged_prefill_plain
    try:
        ref, control = run(offs, **kw), run(coffs, **ckw)
        late = run(offs, vp=_raised(vp), cv=_raised(cv), **kw)
    finally:
        pp._paged_prefill_cuda = saved
    _check_rows_with_control(out, ref, control, None, late=(late, q_len // 2))


def test_prefill_kernels_never_take_the_plain_path(dev):
    """A CUDA call the prefill kernels do not serve raises instead of
    falling back to the plain versions."""
    from tpu_flash_torch.ops.flash import (
        flash_attention_ragged,
        paged_prefill_attention,
    )

    q = torch.zeros(1, 2, 8, 64, device=dev)
    offs = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_ragged(q, q, q, offs, hist_cap=0)
    pages = torch.zeros(2, 4, 8, 64, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        paged_prefill_attention(q, q, q, pages, pages, offs,
                                torch.zeros(1, 2, dtype=torch.int32,
                                            device=dev), hist_cap=8)


def _segment_ids(b, n, docs, dev):
    """[b, n] int32 ids: ``docs`` equal documents a row, the cuts
    shifted per row."""
    i = torch.arange(n, device=dev)[None, :] + 7 * torch.arange(
        b, device=dev)[:, None]
    return (i * docs // (n + 7 * b)).int()


BWD_CASES = {
    # name: (sq, skv, options, control options)
    "causal-gqa": (200, 200, dict(causal=True), dict(causal=False)),
    "noncausal-tail": (70, 300, dict(causal=False, kv_len=250),
                       dict(causal=False)),
    "offset": (100, 300, dict(causal=True, q_offset=200),
               dict(causal=True)),
    "window-softcap": (300, 300, dict(causal=True, window=77, softcap=5.0),
                       dict(causal=True)),
    "alibi-segments": (256, 256, dict(causal=True, alibi=True, segments=3),
                       dict(causal=True)),
    "dlse": (200, 200, dict(causal=True, dlse=True), dict(causal=True)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_kernels_match_plain(dev, dtype, case):
    """dq, dk and dv of the two backward kernels against the plain
    version, each row (one q or kv position) within its own bar, off the
    control (the plain version without the case's option) by more than
    the bar in some row, and, in the causal cases with sq = skv and no
    lse cotangent, off the plain version on a dO raised 2^-4 past s/2 in
    90% of the rows past s/2."""
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd

    sq, skv, kw, ckw = BWD_CASES[case]
    kw, ckw = dict(kw), dict(ckw)
    g = torch.Generator(device=dev).manual_seed(4)
    q = _rn(g, 2, 8, sq, 128, dtype=dtype)
    k, v = _rn(g, 2, 2, skv, 128, dtype=dtype), _rn(g, 2, 2, skv, 128,
                                                    dtype=dtype)
    do = _rn(g, 2, 8, sq, 128, dtype=dtype)
    if kw.pop("alibi", False):
        kw["alibi"] = torch.linspace(0.3, 0.01, 8, device=dev)
    if kw.pop("segments", 0):
        kw["q_seg"] = kw["kv_seg"] = _segment_ids(2, sq, 3, dev)
    dlse = _rn(g, 2, 8, sq) if kw.pop("dlse", False) else None
    o, lse = flash_fwd(q, k, v, sm_scale=128 ** -0.5, save_lse=True, **kw)
    args = (q, k, v, o, do, lse)
    before = (bw.build.FLASH_BWD_DKV.launches, bw.build.FLASH_BWD_DQ.launches)
    out = bw.flash_bwd(*args, sm_scale=128 ** -0.5, dlse=dlse, **kw)
    torch.cuda.synchronize()
    assert (bw.build.FLASH_BWD_DKV.launches,
            bw.build.FLASH_BWD_DQ.launches) == (before[0] + 1, before[1] + 1)
    # The bf16 kernels take P in bf16 for the dV product (round_p).
    rp = dtype == torch.bfloat16
    ref = bw.flash_bwd_plain(*args, sm_scale=128 ** -0.5, dlse=dlse,
                             round_p=rp, **kw)
    control = bw.flash_bwd_plain(*args, sm_scale=128 ** -0.5, round_p=rp,
                                 **ckw)
    late = (None,) * 3
    if kw.get("causal") and sq == skv and dlse is None:
        late = bw.flash_bwd_plain(q, k, v, o, _late_do(do), lse,
                                  sm_scale=128 ** -0.5, round_p=rp, **kw)
    for name, a, r, c, sh in zip(("dq", "dk", "dv"), out, ref, control,
                                 late):
        assert a.dtype == r.dtype and a.shape == r.shape
        # dV = P^T dO does not depend on the lse cotangent: no control.
        _check_rows_with_control(
            a, r, None if case == "dlse" and name == "dv" else c, name,
            None if sh is None else (sh, sh.shape[-2] // 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_segments_kernel_matches_plain(dev, dtype):
    from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain

    g = torch.Generator(device=dev).manual_seed(5)
    q = _rn(g, 2, 8, 300, 128, dtype=dtype)
    k, v = _rn(g, 2, 2, 300, 128, dtype=dtype), _rn(g, 2, 2, 300, 128,
                                                    dtype=dtype)
    seg = _segment_ids(2, 300, 3, dev)
    kw = dict(causal=True, sm_scale=128 ** -0.5)
    out = flash_fwd(q, k, v, q_seg=seg, kv_seg=seg, **kw)
    torch.cuda.synchronize()
    _check_with_control(out, flash_fwd_plain(q, k, v, q_seg=seg, kv_seg=seg,
                                             **kw),
                        flash_fwd_plain(q, k, v, **kw))


def test_backward_through_autograd_launches_the_kernels(dev):
    """flash_attention(...).backward() on CUDA tensors runs flash_fwd and
    both backward kernels (their counts rise), and rows that see no key
    (a segment absent from kv, a NaN-filled kv tail) get zero, finite
    gradients."""
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import flash_attention

    g = torch.Generator(device=dev).manual_seed(6)
    q = _rn(g, 1, 8, 96, 128, dtype=torch.bfloat16).requires_grad_()
    k = _rn(g, 1, 2, 160, 128, dtype=torch.bfloat16)
    v = _rn(g, 1, 2, 160, 128, dtype=torch.bfloat16)
    k[:, :, 140:] = float("nan")
    v[:, :, 140:] = float("nan")
    k.requires_grad_()
    v.requires_grad_()
    q_seg = torch.zeros(1, 96, dtype=torch.int32, device=dev)
    q_seg[:, 60:] = 9
    kv_seg = torch.zeros(1, 160, dtype=torch.int32, device=dev)
    before = build.launch_counts()
    out = flash_attention(q, k, v, kv_len=140, segment_ids=(q_seg, kv_seg))
    out.float().sum().backward()
    torch.cuda.synchronize()
    after = build.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert after[name] == before[name] + 1, name
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
    assert float(q.grad[:, :, 60:].abs().max()) == 0.0
    assert float(k.grad[:, :, 140:].abs().max()) == 0.0
    assert float(q.grad[:, :, :60].float().abs().max()) > 0.0


def test_backward_kernels_never_take_the_plain_path(dev):
    from tpu_flash_torch.ops.flash.backward import flash_bwd

    # d 64, 128 and 256 are built; 96 is not.
    q = torch.zeros(1, 2, 8, 96, device=dev)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_bwd(q, q, q, q, q, lse, causal=True, sm_scale=0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw,sq,skv", [
    (dict(causal=False), 200, 200), (dict(causal=True), 200, 200),
    (dict(causal=True, window=50, softcap=5.0), 200, 200),
    (dict(causal=True, q_offset=140), 200, 340),
    (dict(causal=False, kv_len=150), 200, 200),
    (dict(causal=True, window=150), 300, 300),
], ids=["noncausal", "causal", "window-softcap", "offset-unaligned",
        "kv-tail-mid-step", "window-unaligned"])
def test_flash_fwd_kernel_d64_matches_plain(dev, dtype, kw, sq, skv):
    """The d 64 instance (BASELINE config 1's width), against the plain
    version within the case's bar, a control (no options or causal)
    outside it; sq is never a multiple of the bf16 kernel's 128 q rows."""
    from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain

    g = torch.Generator(device=dev).manual_seed(7)
    q = _rn(g, 2, 4, sq, 64, dtype=dtype)
    k, v = _rn(g, 2, 2, skv, 64, dtype=dtype), _rn(g, 2, 2, skv, 64,
                                                   dtype=dtype)
    out = flash_fwd(q, k, v, sm_scale=0.125, **kw)
    torch.cuda.synchronize()
    control = dict(causal=not kw["causal"])
    _check_with_control(out, flash_fwd_plain(q, k, v, sm_scale=0.125, **kw),
                        flash_fwd_plain(q, k, v, sm_scale=0.125, **control))


QUANT_CASES = {  # name: (dtype, seq, options, control options)
    "int8-causal": ("int8", 512, dict(causal=True), dict(causal=False)),
    "int8-noncausal-tail": ("int8", 384, dict(causal=False, kv_len=300),
                            dict(causal=False)),
    "fp8-native": ("fp8", 512, dict(causal=True, fp8_native=True,
                                    out_dtype=torch.float32),
                   dict(causal=True, fp8_native=False,
                        out_dtype=torch.float32)),
    "fp8-software": ("fp8", 512, dict(causal=True, fp8_native=False,
                                      out_dtype=torch.float32),
                     dict(causal=True, fp8_native=True,
                          out_dtype=torch.float32)),
    "int8-window-softcap-sinks-alibi": (
        "int8", 512, dict(causal=True, window=100, softcap=5.0, sinks=True,
                          alibi=True), dict(causal=True)),
    "int8-onepass": ("int8", 1024, dict(causal=True, onepass=True,
                                        out_dtype=torch.float32),
                     dict(causal=True, out_dtype=torch.float32)),
}
# The kernel's other head widths (d 128 unless named here).
QUANT_CASES.update({
    "int8-causal-d64": QUANT_CASES["int8-causal"],
    "fp8-native-d64": QUANT_CASES["fp8-native"],
    "int8-causal-d256": QUANT_CASES["int8-causal"],
    "fp8-native-window-softcap-d256": (
        "fp8", 512, dict(causal=True, fp8_native=True, window=100,
                         softcap=5.0, out_dtype=torch.float32),
        dict(causal=True, fp8_native=True, out_dtype=torch.float32)),
    "fp8-software-d256": QUANT_CASES["fp8-software"],
    "int8-onepass-d256": QUANT_CASES["int8-onepass"],
})
QUANT_WIDTHS = {name: int(name.rsplit("-d", 1)[1]) for name in QUANT_CASES
                if name.rsplit("-d", 1)[-1].isdigit()}
# Batches and head groups past (1, 8, 2): a group of 3 q heads, whose
# blocks of 8 warps straddle heads and positions unevenly, and 4 / 4.
QUANT_CASES.update({
    "int8-window-gqa3-batch2": ("int8", 384, dict(causal=True, window=100),
                                dict(causal=True)),
    "fp8-native-mha-batch3": (
        "fp8", 256, dict(causal=False, fp8_native=True,
                         out_dtype=torch.float32),
        dict(causal=True, fp8_native=True, out_dtype=torch.float32)),
})
QUANT_SHAPES = {"int8-window-gqa3-batch2": (2, 6, 2),
                "fp8-native-mha-batch3": (3, 4, 4)}  # (b, q heads, kv heads)


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quant_fwd_kernel_matches_plain(dev, case):
    """K10 against its plain version: scores are exact and P rounds the
    same way on both sides, so only the f32 order of l and P V differs
    (the bar); the control drops the case's option."""
    from tpu_flash_torch.ops.flash import quantized as qz

    dtype_name, s, kw, control = QUANT_CASES[case]
    d = QUANT_WIDTHS.get(case, 128)
    b, hq, hkv = QUANT_SHAPES.get(case, (1, 8, 2))
    g = torch.Generator(device=dev).manual_seed(8)
    qi = qz.quantize_attention_inputs(
        _rn(g, b, hq, s, d), _rn(g, b, hkv, s, d), _rn(g, b, hkv, s, d),
        dtype_name)
    kw = dict(kw)
    if kw.pop("sinks", False):
        kw["sinks"] = _rn(g, hq) + 4.0
    if kw.pop("alibi", False):
        kw["alibi"] = torch.linspace(0.3, 0.01, hq, device=dev)

    def call(fn, opts):
        return fn(*qi[:6], dtype_name=dtype_name, sm_scale=d ** -0.5,
                  **{"out_dtype": torch.bfloat16, **opts})

    out = call(qz.quant_fwd, kw)
    torch.cuda.synchronize()
    _check_with_control(out, call(qz.quant_fwd_plain, kw),
                        call(qz.quant_fwd_plain, control))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [128, 96])
def test_quantize_rows_kernel_byte_identical(dev, dtype, d):
    """K11 against its plain version byte for byte (a zero row included;
    d 96 takes the kernel's strided loop)."""
    from tpu_flash_torch.ops.quant import quantize_pallas, quantize_rows_plain

    g = torch.Generator(device=dev).manual_seed(9)
    x = (3.0 * _rn(g, 2, 3, 256, d)).to(dtype)
    x[0, 1, 7] = 0
    got = quantize_pallas(x)
    torch.cuda.synchronize()
    vals, scales = quantize_rows_plain(x)
    assert torch.equal(got.values, vals)
    assert torch.equal(got.scales, scales)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize(
    "kw,control",
    [(dict(causal=True), dict(causal=False)),
     (dict(causal=True, window=60, softcap=5.0), dict(causal=True)),
     (dict(causal=True, alibi=True, q_offset=40, kv_len=250),
      dict(causal=True, q_offset=40, kv_len=250)),
     (dict(causal=True, window=8, kv_len=40), dict(causal=True, kv_len=40))],
    ids=["causal", "window-softcap", "alibi-offset-tail",
         "window-past-kv-len"],
)
def test_attn_weights_kernel_matches_plain(dev, dtype, d, kw, control):
    """K12 against its plain version on the forward kernel's lse, each row
    of P within 2^-12 of its own max (bf16 scores on the tensor cores,
    f32 in three TF32 passes), the control off some row's bar, and the
    plain version with the lse of rows past sq/2 raised by 2^-6 (their P
    1.6% lower) off the bars of 90% of those rows. With a window that
    ends past kv_len, rows from 47 on see no key: their lse is
    MASK_VALUE, which 2^-6 does not move (no late-row control), and their
    P is 1 on every column, the tiles the kernel skips included; that
    case takes the plain forward's lse, which gives such rows MASK_VALUE."""
    from tpu_flash_torch.ops.flash import debug, flash_attention
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    g = torch.Generator(device=dev).manual_seed(10)
    q = _rn(g, 1, 8, 210, d, dtype=dtype)
    k, v = _rn(g, 1, 2, 256, d, dtype=dtype), _rn(g, 1, 2, 256, d,
                                                  dtype=dtype)
    kw = dict(kw)
    if kw.pop("alibi", False):
        kw["alibi"] = torch.linspace(0.3, 0.01, 8, device=dev)
    scale = d ** -0.5
    blind = kw.get("window") == 8  # rows from 47 on see no key
    if blind:
        _, lse = flash_fwd_plain(q, k, v, sm_scale=scale, save_lse=True,
                                 **kw)
    else:
        _, lse = flash_attention(q, k, v, save_residuals=True, **kw)
    out = debug.attention_weights_from_lse(q, k, lse, sm_scale=scale, **kw)
    torch.cuda.synchronize()
    ref = debug.weights_plain(q, k, lse, sm_scale=scale, **kw)
    late = None
    if not blind:
        late_lse = lse.clone()
        late_lse[..., 105:] += 2.0 ** -6
        late = (debug.weights_plain(q, k, late_lse, sm_scale=scale, **kw),
                105)
    else:
        assert (ref[..., 47:, :] == 1).all()
    _check_rows_with_control(
        out, ref, debug.weights_plain(q, k, lse, sm_scale=scale, **control),
        None, late)


def test_new_kernels_launch_and_never_take_the_plain_path(dev):
    """flash_attention_quantized, quantize_pallas and attention_weights on
    CUDA tensors launch their kernels (counts rise); what a kernel does
    not serve raises instead of falling back."""
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import (attention_weights,
                                           flash_attention_quantized,
                                           quantize_attention_inputs)
    from tpu_flash_torch.ops.quant import quantize_pallas

    g = torch.Generator(device=dev).manual_seed(11)
    x = _rn(g, 1, 2, 128, 128)
    before = build.launch_counts()
    qi = quantize_attention_inputs(x, x, x, "int8")
    flash_attention_quantized(qi, causal=True)
    attention_weights(x, x, x, causal=True)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after["quantize_rows"] == before["quantize_rows"] + 3
    assert after["quant_fwd"] == before["quant_fwd"] + 1
    assert after["attn_weights"] == before["attn_weights"] + 1
    with pytest.raises(ValueError, match="head_dim"):
        qi96 = quantize_attention_inputs(*(3 * [_rn(g, 1, 2, 128, 96)]))
        flash_attention_quantized(qi96)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        quantize_pallas(x.double())


@pytest.mark.parametrize("d", [64, 128, 256])
def test_quantized_and_weights_launch_at_every_width(dev, d):
    """flash_attention_quantized (int8 and fp8) and attention_weights on
    CUDA tensors at each head width launch their kernels, once each."""
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash import (attention_weights,
                                           flash_attention_quantized,
                                           quantize_attention_inputs)

    g = torch.Generator(device=dev).manual_seed(12)
    x = _rn(g, 1, 4, 256, d)
    kv = _rn(g, 1, 2, 256, d)
    before = build.launch_counts()
    for dtype_name in ("int8", "fp8"):
        out = flash_attention_quantized(
            quantize_attention_inputs(x, kv, kv, dtype_name), causal=True)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
    attention_weights(x, kv, kv, causal=True)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert after["quant_fwd"] == before["quant_fwd"] + 2
    assert after["attn_weights"] == before["attn_weights"] + 1


@pytest.mark.parametrize("tier", ["bfloat16", "int8-mxu"])
def test_paged_decode_wide_block_matches_plain(dev, tier):
    """An 8192-token kv block (8 pages of 1024, as the bench's 8K bf16
    decode row) at 4 and at 8 q heads per kv head: a block's score rows
    take g * bk / slices floats of shared memory, so the block fits; bit
    for bit with the plain version. The same block on one slice at 8 q
    heads per kv head raises."""
    from tpu_flash_torch.ops.decode import paged

    g = torch.Generator(device=dev).manual_seed(12)
    b, hq, hkv, ps, pps = 2, 8, 2, 1024, 8
    lengths = torch.tensor([8192, 5000], dtype=torch.int32, device=dev)
    table = torch.arange(b * pps, dtype=torch.int32,
                         device=dev).reshape(b, pps)
    kp, vp = (_rn(g, hkv, b * pps, ps, 128) for _ in range(2))
    kp, vp, tier_opts = _decode_pages(kp, vp, tier)
    q = _rn(g, b, hq, 128)
    kw = dict(tier_opts, pages_per_compute_block=8)
    out = paged.paged_attention(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    saved = paged._paged_decode_cuda
    paged._paged_decode_cuda = paged.paged_decode_plain
    try:
        ref = paged.paged_attention(q, kp, vp, lengths, table, **kw)
    finally:
        paged._paged_decode_cuda = saved
    assert torch.equal(out, ref)
    q8 = _rn(g, b, 2 * hq, 128)
    out = paged.paged_attention(q8, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    paged._paged_decode_cuda = paged.paged_decode_plain
    try:
        ref = paged.paged_attention(q8, kp, vp, lengths, table, **kw)
    finally:
        paged._paged_decode_cuda = saved
    assert torch.equal(out, ref)
    saved = paged.SLICES
    paged.SLICES = 1
    try:
        with pytest.raises(ValueError, match="shared memory"):
            paged.paged_attention(q8, kp, vp, lengths, table, **kw)
    finally:
        paged.SLICES = saved


@pytest.mark.parametrize("slices", [1, 3, 8])
@pytest.mark.parametrize("tier", list(DECODE_TIERS))
def test_paged_decode_split_bit_exact(dev, tier, slices):
    """Ragged rows (a token, both sides of a page edge and of a 32-token
    ring, the whole table) cut over 1 to 8 thread blocks a (batch row,
    kv head): with the ring (rows at L <= 32 leave the pages no live
    token), and with a window starting inside a page over four kv blocks
    with (m, l) returned. Bit for bit the plain version's outputs."""
    from tpu_flash_torch.ops.decode import paged

    g = torch.Generator(device=dev).manual_seed(40)
    b, hq, hkv, ps, pps = 8, 8, 2, 16, 16
    n_pages = b * pps + 3
    lengths = torch.tensor([1, 15, 16, 17, 100, 200, 255, 256],
                           dtype=torch.int32, device=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    kp, vp = (_rn(g, hkv, n_pages, ps, 128) for _ in range(2))
    kp, vp, opts = _decode_pages(kp, vp, tier)
    q = _rn(g, b, hq, 128, dtype=torch.bfloat16)
    ring = [_rn(g, b, hkv, 32, 128, dtype=torch.bfloat16) for _ in range(2)]
    saved = paged.SLICES
    for kw in (dict(opts, recent_k=ring[0], recent_v=ring[1]),
               dict(opts, window=70, pages_per_compute_block=4,
                    return_state=True, alibi=torch.linspace(
                        0.3, 0.01, hq, device=dev))):
        paged.SLICES = slices
        try:
            out = paged.paged_attention(q, kp, vp, lengths, table, **kw)
            torch.cuda.synchronize()
        finally:
            paged.SLICES = saved
        plain = paged._paged_decode_cuda
        paged._paged_decode_cuda = paged.paged_decode_plain
        try:
            ref = paged.paged_attention(q, kp, vp, lengths, table, **kw)
        finally:
            paged._paged_decode_cuda = plain
        for a, r in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(a, r)


# -- head width 256 (Gemma-2) and the backward at 64 ---------------------


@pytest.mark.parametrize("kw", [
    dict(causal=True, softcap=50.0, window=300),
    dict(causal=True, q_offset=256, softcap=50.0),
    dict(causal=True, q_offset=100, softcap=50.0),
    dict(causal=False, kv_len=450, softcap=50.0),
    dict(causal=True, window=200),
], ids=["sliding", "global-offset", "offset-unaligned", "kv-tail-mid-step",
        "window-unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_d256_matches_plain(dev, dtype, kw):
    from tpu_flash_torch.ops.flash.forward import flash_fwd, flash_fwd_plain

    g = torch.Generator(device=dev).manual_seed(20)
    sq = 512 - kw.get("q_offset", 0)
    q = _rn(g, 2, 4, sq, 256, dtype=dtype) * 4
    k, v = (_rn(g, 2, 2, 512, 256, dtype=dtype) for _ in range(2))
    args = dict(kw, sm_scale=256 ** -0.5)
    out, lse = flash_fwd(q, k, v, save_lse=True, **args)
    torch.cuda.synchronize()
    ref, ref_lse = flash_fwd_plain(q, k, v, save_lse=True, **args)
    control = flash_fwd_plain(q, k, v, sm_scale=256 ** -0.5, causal=True,
                              q_offset=kw.get("q_offset", 0))
    _check_with_control(out, ref, control)
    assert (lse - ref_lse).abs().max() <= 1e-4


@pytest.mark.parametrize("tier", list(DECODE_TIERS))
def test_paged_decode_kernel_d256_bit_exact(dev, tier):
    """Every tier at d 256 (softcap with a window, and softcap with a
    ring; JAX takes no ring with a window): bit for bit the plain
    version's output."""
    from tpu_flash_torch.ops.decode import paged

    g = torch.Generator(device=dev).manual_seed(21)
    b, hq, hkv, ps, pps, n_pages = 3, 4, 2, 16, 8, 40
    lengths = torch.tensor([128, 57, 20], dtype=torch.int32, device=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    kp, vp = (_rn(g, hkv, n_pages, ps, 256) for _ in range(2))
    kp, vp, opts = _decode_pages(kp, vp, tier)
    ring = [_rn(g, b, hkv, 16, 256, dtype=torch.bfloat16) for _ in range(2)]
    q = _rn(g, b, hq, 256, dtype=torch.bfloat16) * 4
    for kw in (dict(opts, softcap=30.0, window=70, pages_per_compute_block=2),
               dict(opts, softcap=30.0, recent_k=ring[0], recent_v=ring[1])):
        out = paged.paged_attention(q, kp, vp, lengths, table, **kw)
        torch.cuda.synchronize()
        saved = paged._paged_decode_cuda
        paged._paged_decode_cuda = paged.paged_decode_plain
        try:
            ref = paged.paged_attention(q, kp, vp, lengths, table, **kw)
        finally:
            paged._paged_decode_cuda = saved
        assert torch.equal(out, ref)


@pytest.mark.parametrize("pages", ["bfloat16", "int8", "int4", "fp8"])
def test_paged_prefill_kernel_d256_matches_plain(dev, pages):
    from tpu_flash_torch.ops.flash import paged_prefill as pp
    from tpu_flash_torch.ops.quant import quantize_pages

    g = torch.Generator(device=dev).manual_seed(22)
    b, hq, hkv, q_len, ps, pps = 2, 4, 2, 64, 32, 8
    n_pages = b * pps + 1
    q = _rn(g, b, hq, q_len, 256, dtype=torch.bfloat16) * 4
    ck, cv = (_rn(g, b, hkv, q_len, 256, dtype=torch.bfloat16)
              for _ in range(2))
    kp, vp = (_rn(g, hkv, n_pages, ps, 256) for _ in range(2))
    if pages == "bfloat16":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    else:
        kp, vp = quantize_pages(kp, pages), quantize_pages(vp, pages)
    table = torch.randperm(n_pages - 1, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    offs = torch.tensor([256, 100], dtype=torch.int32, device=dev)

    def run(**kw):
        return pp.paged_prefill_attention(q, ck, cv, kp, vp, offs, table,
                                          hist_cap=256, **kw)

    kw = dict(softcap=50.0, window=150, pages_per_compute_block=4)
    out = run(**kw)
    torch.cuda.synchronize()
    saved = pp._paged_prefill_cuda
    pp._paged_prefill_cuda = pp.paged_prefill_plain
    try:
        ref, control = run(**kw), run(pages_per_compute_block=4)
    finally:
        pp._paged_prefill_cuda = saved
    _check_with_control(out, ref, control)


def test_ragged_prefill_kernel_d256_matches_plain(dev):
    from tpu_flash_torch.ops.flash import ragged

    g = torch.Generator(device=dev).manual_seed(23)
    q = _rn(g, 3, 4, 64, 256, dtype=torch.bfloat16) * 4
    k, v = (_rn(g, 3, 2, 256 + 64, 256, dtype=torch.bfloat16)
            for _ in range(2))
    offs = torch.tensor([0, 100, 256], dtype=torch.int32, device=dev)

    def run(**kw):
        return ragged.flash_attention_ragged(q, k, v, offs, hist_cap=256,
                                             **kw)

    out = run(softcap=50.0, window=120)
    torch.cuda.synchronize()
    saved = ragged._ragged_prefill_cuda
    ragged._ragged_prefill_cuda = ragged.ragged_prefill_plain
    try:
        ref, control = run(softcap=50.0, window=120), run(softcap=50.0)
    finally:
        ragged._ragged_prefill_cuda = saved
    _check_with_control(out, ref, control)


@pytest.mark.parametrize("d,kw,ckw", [
    (256, dict(causal=True, softcap=50.0, window=200), dict(causal=True)),
    (64, dict(causal=True), dict(causal=False)),
    (64, dict(causal=True, q_offset=100, kv_len=400), dict(causal=True)),
], ids=["d256-softcap-window", "d64-causal", "d64-offset-tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_other_widths_match_plain(dev, dtype, d, kw, ckw):
    """As test_flash_bwd_kernels_match_plain at d 256 and 64: each row
    within its bar, the control missed in some row, and where the case
    has no q offset, the late control missed in 90% of the late rows."""
    from tpu_flash_torch.ops.flash import backward as bw
    from tpu_flash_torch.ops.flash.forward import flash_fwd_plain

    g = torch.Generator(device=dev).manual_seed(24)
    sq = 512 - kw.get("q_offset", 0)
    q = _rn(g, 2, 4, sq, d, dtype=dtype) * (4 if d == 256 else 1)
    k, v = (_rn(g, 2, 2, 512, d, dtype=dtype) for _ in range(2))
    do = _rn(g, 2, 4, sq, d, dtype=dtype)
    scale = d ** -0.5

    def args(opts):
        o, lse = flash_fwd_plain(q, k, v, sm_scale=scale, save_lse=True,
                                 **opts)
        return (q, k, v, o, do, lse)

    out = bw.flash_bwd(*args(kw), sm_scale=scale, **kw)
    torch.cuda.synchronize()
    rp = dtype == torch.bfloat16  # the bf16 kernels' bf16 P in dV
    ref = bw.flash_bwd_plain(*args(kw), sm_scale=scale, round_p=rp, **kw)
    control = bw.flash_bwd_plain(*args(ckw), sm_scale=scale, round_p=rp,
                                 **ckw)
    late = (None,) * 3
    if not kw.get("q_offset"):  # causal with sq = skv
        q_, k_, v_, o, do_, lse = args(kw)
        late = bw.flash_bwd_plain(q_, k_, v_, o, _late_do(do_), lse,
                                  sm_scale=scale, round_p=rp, **kw)
    for name, a, r, c, sh in zip(("dq", "dk", "dv"), out, ref, control,
                                 late):
        _check_rows_with_control(
            a, r, c, name, None if sh is None else (sh, sh.shape[-2] // 2))


# -- the variant harness's kernel (K13) ----------------------------------


def _variants():
    from tpu_flash_torch.ops.flash.variant import KERNEL_TILES

    return [(t, m, e) for t in KERNEL_TILES for m in ("always", "diag")
            for e in (False, True)]


@pytest.mark.parametrize("blocks,mode,exp2", _variants())
def test_variant_kernel_matches_plain(dev, blocks, mode, exp2):
    """Every built variant at b 2, h 2, s 512: each row within 2 bf16 ulps
    of the row's max |ref| of the plain version; a diagonal one column off
    misses some row's bar, and the plain version on v raised 3% (every
    output moved by 3% of its own value) misses 90% of the rows past
    s/2."""
    from tpu_flash_torch.core.reference import reference_gqa_attention
    from tpu_flash_torch.ops import build
    from tpu_flash_torch.ops.flash.variant import (variant_attention,
                                                   variant_attention_plain)

    g = torch.Generator(device=dev).manual_seed(25)
    q, k, v = (_rn(g, 2, 2, 512, 128, dtype=torch.bfloat16)
               for _ in range(3))
    kw = dict(sm_scale=128 ** -0.5, block_q=blocks[0],
              block_kv_major=blocks[1], block_kv=blocks[2], mask_mode=mode,
              use_exp2=exp2)
    before = build.VARIANT_FWD.launches
    out = variant_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert build.VARIANT_FWD.launches == before + 1
    ref = variant_attention_plain(q, k, v, **kw)
    bars = _row_bars(ref)

    def off(other):
        return (out.float() - other.float()).abs().amax(-1)

    assert (off(ref) <= bars).all()
    control = reference_gqa_attention(q, k, v, causal=True, q_offset=1)
    assert (off(control) > bars).any()
    late = off(variant_attention_plain(q, k, v * 1.03, **kw))[..., 256:]
    assert (late > bars[..., 256:]).float().mean() >= 0.9


def test_variant_kernel_refuses_what_it_does_not_build(dev):
    from tpu_flash_torch.ops.flash.variant import variant_attention

    x = torch.zeros(1, 1, 512, 128, dtype=torch.bfloat16, device=dev)
    args = dict(sm_scale=1.0, block_q=256, block_kv_major=256, block_kv=256)
    with pytest.raises(ValueError, match="block_q, block_kv_major"):
        variant_attention(x, x, x, **args)
    args.update(block_q=64, block_kv_major=64, block_kv=64)
    with pytest.raises(ValueError, match="bfloat16"):
        variant_attention(x.float(), x.float(), x.float(), **args)
    with pytest.raises(ValueError, match="head_dim"):
        y = torch.zeros(1, 1, 512, 64, dtype=torch.bfloat16, device=dev)
        variant_attention(y, y, y, **args)


# -- the engine surface of the HTTP server -----------------------------------


def test_engine_forks_and_ban_match_the_plain_engine(dev):
    """Phase 5's forks and logit bias on the trained checkpoint with an
    int8 cache and a 32-token ring (the ring copied at the fork):
    chip_smoke.check_trained_forks holds an n=3 greedy group (a prompt
    ending mid page), a request with its likeliest bytes banned and a
    neighbour token for token against the same engine on the plain
    versions, every kernel call against its plain version, the branches
    against the prompt served alone, and no banned byte emitted; here
    also the decode and order-exact prefill kernels launched."""
    from tpu_flash_torch.checkpoint import load_hf_dir
    from tpu_flash_torch.ops import build

    cs = _smoke()
    ckpt = os.path.join(cs.REPO, "checkpoints", "tiny-byte-llama")
    model, params = load_hf_dir(ckpt, dtype="bfloat16", device=dev)
    build.reset_launch_counts()
    (rec,) = cs.check_trained_forks((model, params), tiers=(("int8", 32),))
    launches = build.launch_counts()
    assert launches.get("paged_decode") and launches.get("flash_fwd_exact")
    assert rec["match_plain"] and rec["branches_equal_solo"]
    assert not rec["banned_emitted"]
