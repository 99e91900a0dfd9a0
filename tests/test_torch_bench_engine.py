"""The port's engine-level bench configs (6, 9, 10 and 12) on CPU at
shrunk sizes (``bench.__main__.SIZES``; the kernels' plain versions run):
the JAX bench's row names and metrics, finite positive rates, config 10's
kernel time under its wall time, config 9's rates, config 12's modes on
random and trained weights, and the CLI printing config 6's rows. Torch
only: ``tests/test_torch_quality.py`` holds the quality gate against
JAX.
"""

import json
import math

import pytest
import torch

from tpu_flash_torch.bench import __main__ as bench
from tpu_flash_torch.bench.suite import bench_engine_tokens_per_s

SHRUNK = dict(
    engine_model=dict(num_layers=1, hidden=64, num_q_heads=8, head_dim=8),
    engine=dict(batch=2, prompt_len=20, new_tokens=4),
    device_decode=dict(batch=2, prompt_len=20, max_ctx=32, burst=1),
    production=dict(num_layers=1, hidden=64, num_q_heads=4, num_kv_heads=2,
                    batches=(2,)),
    quality_new_tokens=(2, 26),
    speculative=dict(batch=2, prompt_len=12, new_tokens=4),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def shrunk_sizes():
    with pytest.MonkeyPatch.context() as mp:
        for key, value in SHRUNK.items():
            mp.setitem(bench.SIZES, key, value)
        yield


def _rates_ok(rows):
    for r in rows:
        assert r["backend"] == "cpu"
        assert math.isfinite(r["value"]) and r["value"] > 0, r


def test_config6_rows():
    rows = bench.run_configs([6], device="cpu")
    assert [r["name"] for r in rows] == [
        "engine continuous-batching b2 int8-kv (1-layer model)",
        "engine staggered arrivals fused=True",
        "engine staggered arrivals fused=False",
        "engine continuous-batching b2 int8-kv multi-LoRA 2 x r16 "
        "(1-layer model)",
    ]
    assert {r["metric"] for r in rows} == {"decode_tokens_per_s"}
    assert all(r["config"] == 6 for r in rows)
    _rates_ok(rows)


def test_config9_rows():
    rows = bench.run_configs([9], device="cpu")
    tiers = ("int8", "int4", "int4g32", "k8v4", "fp8")
    assert [r["name"] for r in rows] == [
        f"quant quality {dt}-kv greedy token match (tiny random-weight "
        "model)" for dt in tiers] + [
        f"quant quality {dt}-kv beyond-window stress (ring 32 << context "
        "34, random-weight model)" for dt in tiers[:4]]
    for r in rows:
        assert r["metric"] == "prefix_match_rate"
        assert 0.0 <= r["value"] <= 1.0
        assert r["value"] <= r["positionwise_match_rate"] or \
            r["value"] == r["positionwise_match_rate"] == 1.0
    assert [r["n_tokens"] for r in rows] == [6.0] * 5 + [78.0] * 4


def test_config10_rows():
    """Toy rows (MHA, GQA-4) and the production rows, each naming kernel
    time with the wall time per step and the idle share beside it."""
    rows = bench.run_configs([10], iters=4, device="cpu")
    assert [r["name"] for r in rows] == [
        "engine device-side decode b2 1L h8/8kv d8 mha bfloat16-kv "
        "(per-layer rates scale; kernel time, host excluded)",
        "engine device-side decode b2 1L h8/8kv d8 mha int8-kv "
        "(per-layer rates scale; kernel time, host excluded)",
        "engine device-side decode b2 1L h8/2kv d8 gqa4 bfloat16-kv "
        "(per-layer rates scale; kernel time, host excluded)",
    ] + [
        f"engine device-side decode b2 1L h4/2kv d128 hidden64 gqa4 "
        f"{kv}-kv auto-layout ps{r['page_size']} ring{r['recent_window']} "
        "(production shape; per-layer rates scale; kernel time, host "
        "excluded)" for kv, r in zip(("bfloat16", "int8"), rows[3:])
    ]
    _rates_ok(rows)
    for r in rows:
        assert r["metric"] == "device_decode_tokens_per_s"
        assert 0 < r["step_us"] < r["wall_step_us"]
        assert 0.0 < r["idle_share"] < 1.0
        assert r["value"] == pytest.approx(2 / (r["step_us"] * 1e-6))


def test_config12_rows():
    rows = bench.run_configs([12], device="cpu")
    modes = ("off k8", "self-draft k8", "self-draft k16",
             "prompt-lookup k8")
    assert [r["name"] for r in rows] == [
        f"speculative serving {m} b2 random-weights bf16-kv ps128 "
        "(12-token prompts, 4 new)" for m in modes] + [
        f"speculative serving {m} b4 trained-weights bf16-kv ps128 "
        "(48-token prompts, 4 new)" for m in modes]
    _rates_ok(rows)
    for r in rows:
        assert r["steps"] > 0 and r["decode_tokens_per_step"] > 0
    for r in rows[0::4]:
        assert r["acceptance_rate"] == 0.0  # off
    # The trained checkpoint drafts for itself: most drafts verify.
    assert rows[5]["acceptance_rate"] >= 0.5


def test_cli_prints_config6_and_refuses_lora(capsys):
    """The CLI prints config 6's four rows (the last through adapters);
    ``lora_rank`` without an adapter to serve it is refused."""
    bench.main(["--configs", "6", "--device", "cpu"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in rows] == [6, 6, 6, 6]
    with pytest.raises(ValueError, match="lora_count >= 1"):
        bench_engine_tokens_per_s(lora_rank=4, lora_count=0, device="cpu")
