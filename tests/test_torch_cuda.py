"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips unless a CUDA device is present
(decided inside the test, never at import). Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` because the suite's conftest imports JAX, which a GPU
machine need not have.)

Both sides produce bf16 (or f32) from the same roundings and differ only
in f32 summation order: bars 2e-2 for bf16 outputs (one bf16 ulp at
magnitude < 2), 1e-4 for f32.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


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


@pytest.mark.parametrize("tier", ["float32", "bfloat16", "int8-mxu",
                                  "int8-exact"])
@pytest.mark.parametrize(
    "opts",
    [dict(), dict(pages_per_compute_block=2, window=20),
     dict(softcap=4.0, sinks=True, alibi=True), dict(ring=32),
     dict(return_state=True)],
    ids=["plain", "2blk-window", "softcap-sinks-alibi", "ring32", "state"],
)
def test_paged_decode_kernel_matches_plain(dev, tier, opts):
    from tpu_flash_torch.ops.decode import paged
    from tpu_flash_torch.ops.quant import quantize

    g = torch.Generator(device=dev).manual_seed(1)
    b, hq, hkv, ps, pps, n_pages = 3, 8, 2, 16, 8, 40
    lengths = torch.tensor([128, 57, 1], dtype=torch.int32, device=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[
        : b * pps].reshape(b, pps).int()
    kp, vp = _rn(g, hkv, n_pages, ps, 128), _rn(g, hkv, n_pages, ps, 128)
    if tier.startswith("int8"):
        kp, vp = quantize(kp), quantize(vp)
    else:
        kp, vp = kp.to(getattr(torch, tier)), vp.to(getattr(torch, tier))
    q = _rn(g, b, hq, 128, dtype=torch.bfloat16)
    kw = dict(opts, int8_mxu=tier != "int8-exact")
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
    args = dict(kw)
    tier_id = {"float32": paged.TIER_F32, "bfloat16": paged.TIER_BF16,
               "int8-mxu": paged.TIER_INT8_MXU,
               "int8-exact": paged.TIER_INT8}[tier]
    quant = tier.startswith("int8")
    ref = paged.paged_decode_plain(
        q, kp.values if quant else kp, vp.values if quant else vp,
        kp.scales[..., 0] if quant else None,
        vp.scales[..., 0] if quant else None, lengths, table,
        tier=tier_id, sm_scale=128 ** -0.5,
        pages_per_compute_block=args.pop("pages_per_compute_block", pps),
        **{k: v for k, v in args.items() if k != "int8_mxu"},
    )
    if kw.get("return_state"):
        for a, r in zip(out[1:], ref[1:]):
            assert (a - r).abs().max() <= 1e-3
        out, ref = out[0], ref[0]
    assert (out.float() - ref.float()).abs().max() <= TOL[torch.bfloat16]


def test_cuda_tensor_never_takes_the_plain_path(dev):
    """A CUDA tensor the kernel does not serve raises; it is not routed to
    the plain version."""
    from tpu_flash_torch.ops.flash import flash_attention

    q = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
