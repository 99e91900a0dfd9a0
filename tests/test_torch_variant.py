"""The causal-forward variant harness (K13) and the bench's configs 5, 7, 8
and 11, on CPU.

``variant_attention_plain`` (the plain version of the ``variant_fwd``
kernel) against the JAX package's ``variant_attention`` with its Pallas
kernel in interpret mode, on the same inputs made from a seed with numpy.
Both round q' = q * scale and P to bf16 at the same places, so a bf16
case's bar is 2 bf16 ulps of max |ref| (a flipped rounding of an output
is one ulp; a flipped P element moves an output by a small part of one);
the f32 case keeps no rounding but summation order: 1e-5. Each bar has
controls that must miss it: exp2 without the log2 e fold, and a causal
diagonal one column off. The sweep and the bench configs run at tiny
sizes with a short timing window (their CPU times mean nothing); the
cases check rows, names, metrics and the parity gate. Five JAX interpret
calls in all, one module fixture.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.bench.experiments import variant_attention as j_variant
from tpu_flash_torch.bench import __main__ as bench_main
from tpu_flash_torch.bench import experiments, suite
from tpu_flash_torch.core.reference import reference_gqa_attention
from tpu_flash_torch.ops.flash import variant_attention
from tpu_flash_torch.ops.flash.variant import (
    KERNEL_TILES,
    LOG2E,
    variant_attention_plain,
)

from test_torch_engine_tiers import JAX_THREADS, torch_threads

B, H, S, D = 1, 2, 256, 128
SM = D ** -0.5
F32_TOL = 1e-5
# (mask_mode, use_exp2, blocks) of the bf16 cases: each mask mode and
# exponential once, over both block shapes.
CASES = {
    "always": ("always", False, (128, 128, 64)),
    "always-exp2": ("always", True, (64, 128, 128)),
    "diag": ("diag", False, (64, 128, 128)),
    "diag-exp2": ("diag", True, (128, 128, 64)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors (see
    test_torch_engine_tiers.JAX_THREADS)."""
    with torch_threads(1):
        yield


def _bar(ref):
    """2 bf16 ulps of max |ref|."""
    top = float(np.abs(ref).max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, H, S, D), dtype=np.float32)
            for _ in range(3)]


def _jax(x, dtype, mask_mode, use_exp2, blocks, sm_scale=SM):
    jdt = getattr(jnp, dtype)
    with torch_threads(JAX_THREADS):
        out = j_variant(*(jnp.asarray(a, jdt) for a in x), sm_scale=sm_scale,
                        block_q=blocks[0], block_kv_major=blocks[1],
                        block_kv=blocks[2], mask_mode=mask_mode,
                        use_exp2=use_exp2, interpret=True)
    return np.asarray(out, np.float32)


def _port(x, dtype, mask_mode, use_exp2, blocks, sm_scale=SM):
    tdt = getattr(torch, dtype)
    out = variant_attention(
        *(torch.from_numpy(a).to(tdt) for a in x), sm_scale=sm_scale,
        block_q=blocks[0], block_kv_major=blocks[1], block_kv=blocks[2],
        mask_mode=mask_mode, use_exp2=use_exp2)
    assert out.dtype == tdt
    return out.float().numpy()


@pytest.fixture(scope="module")
def jax_outputs(inputs):
    return {name: _jax(inputs, "bfloat16", *case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_variant(inputs, jax_outputs, name):
    want = jax_outputs[name]
    got = _port(inputs, "bfloat16", *CASES[name])
    assert np.abs(got - want).max() <= _bar(want)


def test_controls_miss_the_bar(inputs, jax_outputs):
    """exp2 with the scale left unfolded, and a diagonal one column off
    (each row also attends its next column), both miss the bar."""
    mask_mode, _, blocks = CASES["always-exp2"]
    want = jax_outputs["always-exp2"]
    unfolded = _port(inputs, "bfloat16", mask_mode, True, blocks,
                     sm_scale=SM / LOG2E)
    assert np.abs(unfolded - want).max() > _bar(want)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in inputs)
    off_by_one = reference_gqa_attention(q, k, v, causal=True, q_offset=1)
    want = jax_outputs["always"]
    assert np.abs(off_by_one.float().numpy() - want).max() > _bar(want)


def test_f32_plain_matches_jax_variant(inputs):
    want = _jax(inputs, "float32", "diag", True, (128, 128, 64))
    got = _port(inputs, "float32", "diag", True, (128, 128, 64))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_plain_depends_only_on_block_kv(inputs):
    """block_q, block_kv_major and the mask mode change which tiles run,
    not the function: outputs are equal bit for bit; block_kv moves where
    P rounds."""
    x = [torch.from_numpy(a).bfloat16() for a in inputs]

    def run(bq, bkvm, bkv, mode):
        return variant_attention_plain(
            *x, sm_scale=SM, block_q=bq, block_kv_major=bkvm, block_kv=bkv,
            mask_mode=mode)

    base = run(64, 128, 64, "always")
    assert torch.equal(base, run(128, 256, 64, "diag"))
    assert torch.equal(base, run(256, 64, 64, "always"))
    assert not torch.equal(base, run(64, 128, 128, "always"))


@pytest.mark.parametrize("kw,match", [
    (dict(mask_mode="never"), "mask_mode"),
    (dict(block_q=96), "block_q"),
    (dict(block_kv_major=128, block_kv=96), "block_kv"),
])
def test_plain_refuses_bad_arguments(kw, match):
    x = torch.zeros(1, 1, 256, 128, dtype=torch.bfloat16)
    args = dict(sm_scale=SM, block_q=64, block_kv_major=128, block_kv=64)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        variant_attention(x, x, x, **args)


def test_kernel_tiles_are_what_the_source_builds():
    """The tile set the wrapper accepts is the one csrc/variant_fwd.cu
    instantiates (its VARIANT_TILES list)."""
    import re

    from tpu_flash_torch.ops import build

    src = build.VARIANT_FWD.source.read_text()
    block = src[src.index("#define VARIANT_TILES"):]
    block = block[:block.index("\n\n")]
    built = tuple(tuple(int(n) for n in m.groups()) for m in
                  re.finditer(r"X\((\d+), (\d+), (\d+)\)", block))
    assert built == KERNEL_TILES
    assert len(experiments.variants()) == 4 * len(KERNEL_TILES)


@pytest.fixture
def fast_timing(monkeypatch):
    """Differential timing with one call a window (CPU times are not the
    point here)."""
    real = suite.time_per_call

    def quick(fn, *, device="cuda", **_):
        return real(fn, device=device, inner=1, repeats=1, target_window=0.0)

    monkeypatch.setattr(suite, "time_per_call", quick)


def test_sweep_gates_then_times(fast_timing):
    rows = experiments.sweep(heads=2, seq=256, device="cpu", iters=1,
                             tiles=KERNEL_TILES[:2])
    assert len(rows) == 8
    for r in rows:
        assert r["pass"] and r["max_abs_err"] <= experiments.PARITY_TOL
        assert r["metric"] == "ms" and r["value"] > 0 and r["tflops"] > 0
        assert r["name"].startswith("variant b1 h2 s256 d128 bfloat16 "
                                    "causal ")
    assert {(r["mask_mode"], r["use_exp2"]) for r in rows} == {
        ("always", False), ("always", True), ("diag", False), ("diag", True)}


def test_sweep_parity_failure_is_not_timed(fast_timing, monkeypatch, capsys):
    monkeypatch.setattr(experiments, "PARITY_TOL", 0.0)
    full = experiments.sweep
    monkeypatch.setattr(experiments, "sweep",
                        lambda **kw: full(**kw, heads=1, seq=128))
    rc = experiments.main(["--device", "cpu", "--iters", "1"])
    out = capsys.readouterr()
    assert rc == 1 and "PARITY FAIL" in out.err
    import json

    rows = [json.loads(ln) for ln in out.out.splitlines()]
    assert len(rows) == 4 * len(KERNEL_TILES)
    assert not any(r["pass"] or "value" in r for r in rows)


@pytest.fixture
def tiny_sizes(monkeypatch, fast_timing):
    monkeypatch.setitem(bench_main.SIZES, "long_ctx", 1024)
    monkeypatch.setitem(bench_main.SIZES, "window", 128)
    monkeypatch.setitem(bench_main.SIZES, "chunk", 32)
    monkeypatch.setitem(bench_main.SIZES, "train", ((2, 128),))


@pytest.mark.parametrize("config,names,metric,extra", [
    (5, ["flash_prefill b1 h8 s1024 d128 bfloat16 causal",
         "int4-kv decode b4 gqa4 1K ps1024"], None, ()),
    (7, ["windowed decode b8 gqa4 1K ctx win128 int8-kv",
         "windowed decode b8 gqa4 1K ctx win128 bf16-kv"], "tokens_per_s",
     ("full_ctx_tokens_per_s", "window_speedup", "attended_hbm_gbps")),
    (8, ["windowed paged prefill chunk32 1K hist win128 bf16-kv",
         "windowed paged prefill chunk32 1K hist win128 int8-kv"],
     "us_per_chunk",
     ("full_hist_us_per_chunk", "window_speedup", "attended_hbm_gbps")),
    (11, ["flash_train b1 h2 s128 d128 bfloat16 causal"], "train_tflops",
     ("ms_per_step", "roofline_frac")),
])
def test_long_context_configs_on_cpu(tiny_sizes, config, names, metric,
                                     extra):
    rows = bench_main.run_configs([config], iters=1, device="cpu")
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert r["config"] == config and r["backend"] == "cpu"
        if metric:
            assert r["metric"] == metric
        assert math.isfinite(r["value"]) and r["value"] > 0
        for key in extra:
            assert math.isfinite(r[key]) and r[key] >= 0
    if config == 5:
        assert [r["metric"] for r in rows] == ["tflops", "tokens_per_s"]


def test_cli_runs_config_5(tiny_sizes, capsys):
    import json

    bench_main.main(["--configs", "5", "--device", "cpu", "--iters", "1"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in rows] == [5, 5]


@pytest.mark.parametrize("kv_quant,payload", [
    (None, 2 * 128 * 2), ("int8", 2 * (128 + 4)), ("int4", 2 * (64 + 4)),
    ("int4g32", 2 * (64 + 2 * 4 * 4)),
])
def test_kv_cache_bytes_per_tier(kv_quant, payload):
    """Payload and scale bytes of one (token, kv head) row, K and V."""
    assert suite.kv_cache_bytes(1, 128, kv_quant) == payload
