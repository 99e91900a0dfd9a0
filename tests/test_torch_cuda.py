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
version without the case's offsets or options must miss the bar.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _case_bar(ref):
    top = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return 2.0 ** -12 * top


def _check_with_control(out, ref, control):
    """out within ref's bar, and out off the control by more than it."""
    bar = _case_bar(ref)
    assert (out.float() - ref.float()).abs().max() <= bar
    assert (out.float() - control.float()).abs().max() > bar


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
    ],
    ids=["causal", "chunk", "noncausal-tail", "window-softcap",
         "sinks-alibi-lse"],
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


def test_cuda_tensor_never_takes_the_plain_path(dev):
    """A CUDA tensor the kernel does not serve raises; it is not routed to
    the plain version."""
    from tpu_flash_torch.ops.flash import flash_attention

    q = torch.zeros(1, 2, 8, 64, device=dev)
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
    version, each within its own bar, and off the control (the plain
    version without the case's option) by more than it."""
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
    ref = bw.flash_bwd_plain(*args, sm_scale=128 ** -0.5, dlse=dlse, **kw)
    control = bw.flash_bwd_plain(*args, sm_scale=128 ** -0.5, **ckw)
    for name, a, r, c in zip(("dq", "dk", "dv"), out, ref, control):
        assert a.dtype == r.dtype and a.shape == r.shape
        if case == "dlse" and name == "dv":
            # dV = P^T dO does not depend on the lse cotangent.
            assert (a.float() - r.float()).abs().max() <= _case_bar(r)
            continue
        _check_with_control(a, r, c)


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

    q = torch.zeros(1, 2, 8, 64, device=dev)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_bwd(q, q, q, q, q, lse, causal=True, sm_scale=0.125)
