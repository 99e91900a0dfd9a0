"""The port's bench entry point (``python -m tpu_flash_torch.bench``) and
``utils/device.py`` on CPU, against the JAX package where both compute
the same thing: the bench's FLOP and byte counts, config 1's rows (the
flash forward's plain version, d 64 and d 128), the flash forward at
d 64 against the JAX kernel in interpret mode (bar 2e-5 in f32: the two
sum in different orders), and the CLI's refusals of unknown configs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.bench import suite as j_suite
from tpu_flash.ops.flash import flash_attention as j_flash
from tpu_flash_torch.bench import (
    attention_flops,
    attention_hbm_bytes,
    bench_decode_tokens_per_s,
    time_per_call,
)
from tpu_flash_torch.bench.__main__ import main, run_configs
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.flash.forward import flash_fwd_plain
from tpu_flash_torch.utils import device_info


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(1, 32, 2048, 2048, 128),
                                   (2, 4, 384, 512, 64),
                                   (1, 32, 8192, 8192, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_flop_and_byte_counts_equal_jax(shape, causal):
    b, h, sq, skv, d = shape
    assert attention_flops(b, h, sq, skv, d, causal) == \
        j_suite.attention_flops(b, h, sq, skv, d, causal)
    for itemsize in (1, 2, 4):
        assert attention_hbm_bytes(b, h, h // 4 or 1, sq, skv, d,
                                   itemsize) == j_suite.attention_hbm_bytes(
            b, h, h // 4 or 1, sq, skv, d, itemsize)


def test_config1_rows_pass_on_cpu():
    """Config 1 with the plain versions: the JAX bench's row names, both
    parity rows within their targets."""
    rows = run_configs([1], device="cpu")
    assert [r["name"] for r in rows] == [
        "parity b1 h1 s128 d64 float32",
        "parity b2 h4 s384 d128 bfloat16 causal",
    ]
    for r in rows:
        assert r["metric"] == "max_abs_err" and r["backend"] == "cpu"
        assert r["pass"] and 0.0 <= r["value"] <= r["target"]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_plain_d64_matches_jax(causal):
    """Config 1's width: the d 64 forward against the JAX kernel."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 128, 64), dtype=np.float32)
               for _ in range(3))
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal))
    got = flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, sm_scale=64 ** -0.5)
    assert np.abs(got.numpy() - want).max() <= 2e-5


def test_decode_bench_tiny_on_cpu():
    """bench_decode_tokens_per_s at a tiny shape on the plain versions:
    finite positive tok/s, step time and GB/s."""
    tps, secs, gbps = bench_decode_tokens_per_s(
        batch=2, num_q_heads=4, num_kv_heads=2, head_dim=128, context=256,
        page_size=64, kv_quant="int8", pages_per_compute_block=4, iters=1,
        device="cpu")
    for x in (tps, secs, gbps):
        assert math.isfinite(x) and x > 0
    assert tps == pytest.approx(2 / secs)


def test_time_per_call_measures_a_known_wait():
    """Differential timing of a 2 ms sleep lands near 2 ms."""
    import time

    secs = time_per_call(lambda: time.sleep(2e-3), device="cpu", inner=2,
                         repeats=2, target_window=0.02)
    assert 1.5e-3 <= secs <= 0.05


@pytest.mark.parametrize("configs,message", [
    ("0", "unknown config(s) [0]"),
    ("1,13", "unknown config(s) [13]"),
    ("13", "unknown config"),
    ("x", "comma-separated"),
])
def test_cli_refuses_unported_and_unknown_configs(capsys, configs, message):
    with pytest.raises(SystemExit) as exc:
        main(["--configs", configs, "--device", "cpu"])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_prints_one_json_row_per_row(capsys):
    import json

    main(["--configs", "1", "--device", "cpu"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in rows] == [1, 1]


def test_device_info_on_cpu():
    info = device_info("cpu")
    assert info.platform == "cpu" and info.kind == "cpu"
    assert not info.native_fp8_matmul
    assert info.roofline_attention_tflops(1e12, 1e9) == 0.0


def test_launch_names_a_shared_memory_refusal():
    """An entry point that refuses a block too wide for the card's shared
    memory (paged_decode checks its own layout against the card's limit)
    raises a ValueError that says so, and the refused call is not
    counted as a launch; any other nonzero code is a CUDA error."""
    kernel = build.CudaKernel("k", "k", [], replaces="-")
    kernel.function = lambda: (lambda *args: build.ERR_SHARED_MEMORY)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.launch()
    kernel.function = lambda: (lambda *args: 1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kernel.launch()
    kernel.function = lambda: (lambda *args: 0)
    kernel.launch(tag="t")
    assert kernel.launches == 1 and kernel.launches_by_tag == {"t": 1}