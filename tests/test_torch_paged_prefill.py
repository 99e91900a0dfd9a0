"""The port's paged prefill (its plain version, on CPU) against the JAX
package: ``paged_prefill_attention`` with its Pallas kernel in interpret
mode in three cases (each such call costs seconds here), and the jnp
oracle -- ``reference_gqa_attention`` over the history from
``gather_pages_to_dense`` plus the chunk, per row at its own offset -- in
the others.

Bars. Against the JAX kernel the port walks the same blocks with the same
roundings, so the outputs differ by f32 summation order only: one bf16
ulp of an output at most, 2e-2 at these magnitudes (the JAX package's own
bf16 bar for this kernel is 1e-2 against its oracle). Against the oracle
in f32, where no P rounding happens, 2e-5 (summation order and the
blocked softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.core.reference import (
    gather_pages_to_dense,
    reference_gqa_attention,
)
from tpu_flash.ops.flash import paged_prefill_attention as j_paged_prefill
from tpu_flash.ops.quant import QuantizedTensor as JQT
from tpu_flash_torch.ops.flash import paged_prefill_attention
from tpu_flash_torch.ops.quant import QuantizedTensor as TQT
from tpu_flash_torch.ops.quant import quantize

BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
B, HQ, HKV, D, PS, NP = 3, 4, 2, 32, 8, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, q_len, pps, offsets, dtype, kv="float"):
    """Seeded q/chunk K/V, pages and page tables for both packages. Rows
    whose offset is 0 get a table of the trash page (the last page)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, q_len, D), dtype=np.float32)
    ck = rng.standard_normal((B, HKV, q_len, D), dtype=np.float32)
    cv = rng.standard_normal((B, HKV, q_len, D), dtype=np.float32)
    kp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    vp = rng.standard_normal((HKV, NP, PS, D), dtype=np.float32)
    table = rng.permutation(NP - 1)[:B * pps].reshape(B, pps).astype(np.int32)
    offs = np.asarray(offsets, np.int32)
    table[offs == 0] = NP - 1
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = dict(q=torch.from_numpy(q).to(tdt), ck=torch.from_numpy(ck).to(tdt),
             cv=torch.from_numpy(cv).to(tdt), offs=torch.from_numpy(offs),
             table=torch.from_numpy(table))
    j = dict(q=jnp.asarray(q, jdt), ck=jnp.asarray(ck, jdt),
             cv=jnp.asarray(cv, jdt), offs=jnp.asarray(offs),
             table=jnp.asarray(table))
    if kv == "int8":
        kq, vq = quantize(torch.from_numpy(kp)), quantize(torch.from_numpy(vp))
        t.update(kp=kq, vp=vq)
        j.update(kp=JQT(jnp.asarray(kq.values.numpy()),
                        jnp.asarray(kq.scales.numpy()), "int8"),
                 vp=JQT(jnp.asarray(vq.values.numpy()),
                        jnp.asarray(vq.scales.numpy()), "int8"))
    else:
        t.update(kp=torch.from_numpy(kp).to(tdt),
                 vp=torch.from_numpy(vp).to(tdt))
        j.update(kp=jnp.asarray(kp, jdt), vp=jnp.asarray(vp, jdt))
    return t, j


def _options(kw):
    """sinks / alibi arrays for both packages from flags in ``kw``."""
    kw = dict(kw)
    tkw, jkw = {}, {}
    if kw.pop("sinks", False):
        s = np.linspace(-1.0, 2.0, HQ).astype(np.float32)
        tkw["sinks"], jkw["sinks"] = torch.from_numpy(s), jnp.asarray(s)
    if kw.pop("alibi", False):
        a = np.linspace(0.5, 0.05, HQ).astype(np.float32)
        tkw["alibi"], jkw["alibi"] = torch.from_numpy(a), jnp.asarray(a)
    return {**kw, **tkw}, {**kw, **jkw}


def _port(t, hist_cap, **kw):
    return paged_prefill_attention(
        t["q"], t["ck"], t["cv"], t["kp"], t["vp"], t["offs"], t["table"],
        hist_cap=hist_cap, **kw,
    )


@pytest.mark.parametrize(
    "dtype,kv,offsets,kw",
    [
        ("bfloat16", "float", (0, 13, 48), dict(pages_per_compute_block=2)),
        ("bfloat16", "int8", (40, 7, 24), dict()),
        ("bfloat16", "float", (9, 33, 48),
         dict(pages_per_compute_block=2, window=20, softcap=5.0,
              sinks=True, alibi=True)),
    ],
    ids=["bf16-gqa-mixed-offsets", "int8-pages", "window-softcap-sinks-alibi"],
)
def test_paged_prefill_matches_jax_kernel(dtype, kv, offsets, kw):
    """Mixed offsets over several history blocks (a pad row with offset 0
    among them), int8 pages, and every option, block_q 8 over a 16-row
    chunk: two chunk blocks."""
    t, j = _inputs(0, 16, 6, offsets, dtype, kv)
    tkw, jkw = _options(dict(kw, block_q=8))
    want = j_paged_prefill(j["q"], j["ck"], j["cv"], j["kp"], j["vp"],
                           j["offs"], j["table"], hist_cap=48,
                           interpret=True, **jkw)
    got = _port(t, 48, **tkw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def _oracle(t, hist_cap, window=None, softcap=None, sinks=None, alibi=None):
    """Per row: causal attention at q_offset = offs[b] over the row's
    first offs[b] history tokens (dequantized) plus the chunk."""
    kp, vp = t["kp"], t["vp"]
    if isinstance(kp, TQT):
        kp = (kp.values.float() * kp.scales).to(t["q"].dtype)
        vp = (vp.values.float() * vp.scales).to(t["q"].dtype)
    table = jnp.asarray(t["table"].numpy())
    hk = gather_pages_to_dense(jnp.asarray(kp.float().numpy()), table)
    hv = gather_pages_to_dense(jnp.asarray(vp.float().numpy()), table)
    q = jnp.asarray(t["q"].float().numpy())
    ck = jnp.asarray(t["ck"].float().numpy())
    cv = jnp.asarray(t["cv"].float().numpy())
    rows = []
    for b, off in enumerate(t["offs"].tolist()):
        # [history | chunk | zeros]: one shape for every row (so eager JAX
        # compiles each op once); the causal mask at q_offset = off never
        # reaches the zeros.
        pad = jnp.zeros_like(hk[b:b + 1, :, :hist_cap - off])
        k = jnp.concatenate([hk[b:b + 1, :, :off], ck[b:b + 1], pad], axis=2)
        v = jnp.concatenate([hv[b:b + 1, :, :off], cv[b:b + 1], pad], axis=2)
        rows.append(reference_gqa_attention(
            q[b:b + 1], k, v, causal=True, q_offset=off, window=window,
            softcap=softcap,
            sinks=None if sinks is None else jnp.asarray(sinks.numpy()),
            alibi=None if alibi is None else jnp.asarray(alibi.numpy()),
        ))
    return np.asarray(jnp.concatenate(rows, axis=0))


@pytest.mark.parametrize(
    "case", ["pad-rows", "verify", "f32-options", "one-vs-many-q-blocks",
             "int8-f32-q"],
)
def test_paged_prefill_matches_oracle(case):
    """f32 cases against the jnp oracle. pad-rows: offset-0 rows whose
    table is all trash page, and that page full of NaN, give finite
    outputs (history past a row's offset never reaches a sum). verify: 9
    rows (speculation_k 8 + 1) at per-row lengths over a whole table.
    one-vs-many-q-blocks: one chunk block and four give the oracle's
    output. int8-f32-q: int8 pages under f32 queries."""
    hist_cap, pps, q_len, kw = 48, 6, 16, {}
    offsets, kv = (0, 21, 0), "float"
    if case == "verify":
        q_len, offsets = 9, (5, 30, 47)
    elif case == "f32-options":
        offsets = (3, 40, 17)
        kw = dict(window=11, softcap=4.0, sinks=True, alibi=True,
                  pages_per_compute_block=1)
    elif case == "int8-f32-q":
        offsets, kv = (8, 48, 31), "int8"
    t, _ = _inputs(1, q_len, pps, offsets, "float32", kv)
    if case == "pad-rows":
        t["kp"][:, NP - 1] = float("nan")
        t["vp"][:, NP - 1] = float("nan")
    tkw, _ = _options(kw)
    want = _oracle(t, hist_cap, **{k: v for k, v in tkw.items()
                                   if k != "pages_per_compute_block"})
    if case == "one-vs-many-q-blocks":
        outs = [_port(t, hist_cap, block_q=bq) for bq in (16, 4)]
    else:
        outs = [_port(t, hist_cap, **tkw)]
    for got in outs:
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_paged_prefill_refuses_int4_pages():
    """int4 pages must be token-packed; group-affine int4 (int4g32) and
    mixed tiers never reach paged prefill (the engine gathers them)."""
    t, _ = _inputs(2, 8, 6, (8, 8, 8), "bfloat16")
    lanes = TQT(t["kp"].to(torch.int8), torch.ones(HKV, NP, PS, 1), "int4")
    group = TQT(t["kp"].to(torch.int8)[:, :, : PS // 2],
                torch.ones(HKV, NP, 2, PS), "int4g32", "tokens")
    int8 = TQT(t["kp"].to(torch.int8), torch.ones(HKV, NP, PS, 1), "int8")
    for pages, msg in (((lanes, lanes), "token-packed"),
                       ((group, group), "int4g32"),
                       ((int8, lanes._replace(packing="tokens")), "one tier")):
        with pytest.raises(ValueError, match=msg):
            paged_prefill_attention(t["q"], t["ck"], t["cv"], *pages,
                                    t["offs"], t["table"], hist_cap=48)


def test_kernel_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """Editing a shared ``*.cuh`` header renames every kernel library
    built from that directory, so the next build compiles afresh; the
    eleven kernels are registered, the two prefill kernels and the
    forward on the shared tile header, the two forward entries and the
    two backward kernels each in one source and library."""
    from tpu_flash_torch.ops import build

    assert set(build.KERNELS) == {"flash_fwd", "flash_fwd_exact",
                                  "paged_decode", "paged_prefill",
                                  "ragged_prefill", "flash_bwd_dkv",
                                  "flash_bwd_dq", "quant_fwd",
                                  "quantize_rows", "attn_weights",
                                  "variant_fwd"}
    for first, second, source in (("flash_fwd", "flash_fwd_exact",
                                   "flash_fwd.cu"),
                                  ("flash_bwd_dkv", "flash_bwd_dq",
                                   "flash_bwd.cu")):
        a, b = build.KERNELS[first], build.KERNELS[second]
        assert a.source == b.source and a.source.name == source
        assert a.library_path() == b.library_path()
    for name in ("paged_prefill", "ragged_prefill", "flash_fwd"):
        src = build.KERNELS[name].source.read_text()
        assert '#include "prefill_tile.cuh"' in src
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    kernel = build.CudaKernel("k", "k", [], replaces="-")
    before = kernel.library_path()
    assert kernel.library_path() == before
    header.write_text("// v2\n")
    assert kernel.library_path() != before


def test_built_library_keeps_its_nvcc_log(tmp_path, monkeypatch):
    """A library already built is reused with the nvcc log saved beside
    it (the ptxas report that the card's checks read), so a second build
    in the same checkout has the same log; a library without its log is
    built again."""
    from tpu_flash_torch.ops import build

    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// kernel\n")
    kernel = build.CudaKernel("k", "k", [], replaces="-")
    (tmp_path / "build").mkdir()
    kernel.library_path().write_bytes(b"")
    kernel.log_path().write_text("ptxas info : Used 40 registers\n")
    kernel.finish_build(kernel.start_build())
    assert kernel.build_seconds == 0.0
    assert kernel.build_log == "ptxas info : Used 40 registers\n"

    def no_nvcc():
        raise RuntimeError("would build")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    kernel.log_path().unlink()
    with pytest.raises(RuntimeError, match="would build"):
        kernel.start_build()
