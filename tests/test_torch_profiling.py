"""The port's profiler (``tpu_flash_torch/utils/profiling.py``) on CPU:
the six cases of ``tests/test_profiling.py`` (tensor-core and HBM
placement, report formatting, the empty report, a real step timed, the
trace written to a file), ``KernelProfile`` and ``roofline_report``
against the JAX package's formulas for the same device figures,
``kernel_seconds`` over a trace, and ``timed``'s window.
"""

import json
import os

import pytest
import torch

from tpu_flash.utils.device import DeviceInfo as JDeviceInfo
from tpu_flash.utils.profiling import KernelProfile as JKernelProfile
from tpu_flash.utils.profiling import roofline_report as j_roofline_report
from tpu_flash_torch.utils.device import DeviceInfo
from tpu_flash_torch.utils.profiling import (
    KernelProfile,
    kernel_seconds,
    profile_step,
    roofline_report,
    timed,
    trace,
)

# The H100 SXM's data-sheet figures, as utils/device.py records them.
H100 = DeviceInfo(
    kind="NVIDIA H100 80GB HBM3", platform="gpu", num_devices=1,
    hbm_bytes=80 * 2**30, hbm_bandwidth_gbps=3350.0,
    peak_bf16_tflops=989.0, peak_int8_tflops=1979.0,
    smem_per_block_bytes=232448, num_sms=132,
)
J_H100 = JDeviceInfo(
    kind=H100.kind, platform="gpu", num_devices=1, num_local_devices=1,
    hbm_bytes=H100.hbm_bytes, hbm_bandwidth_gbps=H100.hbm_bandwidth_gbps,
    vmem_bytes=0, peak_bf16_tflops=H100.peak_bf16_tflops,
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


class TestKernelProfile:
    def test_tensor_bound_placement(self):
        # High intensity (flash prefill-like): the tensor-core roof.
        p = KernelProfile(
            name="prefill", seconds=1e-3, flops=500e12 * 1e-3,
            hbm_bytes=50e9 * 1e-3, device=H100,
        )
        assert p.bound == "tensor"
        assert p.roofline_tflops == pytest.approx(989.0)
        assert p.roofline_frac == pytest.approx(500 / 989, rel=1e-3)
        assert p.tflops == pytest.approx(500.0)

    def test_hbm_bound_placement(self):
        # Low intensity (decode-like): the memory roof.
        p = KernelProfile(
            name="decode", seconds=1e-3, flops=1e12 * 1e-3,
            hbm_bytes=500e9 * 1e-3, device=H100,
        )
        assert p.bound == "hbm"
        # roof = intensity * rate = (1e9 / 500e9 FLOP/B) * 3350 GB/s
        assert p.roofline_tflops == pytest.approx(2 * 3.35, rel=1e-2)

    def test_report_formatting(self):
        p = KernelProfile(
            name="k", seconds=1e-3, flops=1e10, hbm_bytes=1e8, device=H100,
        )
        rep = roofline_report([p])
        assert "NVIDIA H100 80GB HBM3" in rep
        assert "k" in rep
        assert "% of" in rep

    def test_empty_report(self):
        assert roofline_report([]) == "(no profiles)"


@pytest.mark.parametrize("seconds,flops,hbm_bytes", [
    (1e-3, 5e11, 5e7),      # tensor-core bound
    (1e-3, 1e9, 5e8),       # memory bound
    (2.5e-4, 3e10, 0.0),    # no bytes: intensity against one byte
    (7e-2, 6.4e13, 2.1e10),
])
def test_formulas_equal_jax(seconds, flops, hbm_bytes):
    """The same measurement on the same device figures: every property
    and the report equal JAX's, with the roof named "tensor" where JAX
    says "mxu"."""
    p = KernelProfile("attn", seconds, flops, hbm_bytes, H100)
    j = JKernelProfile("attn", seconds, flops, hbm_bytes, J_H100)
    for prop in ("tflops", "hbm_gbps", "intensity", "roofline_tflops",
                 "roofline_frac"):
        assert getattr(p, prop) == getattr(j, prop), prop
    assert p.bound == {"mxu": "tensor", "hbm": "hbm"}[j.bound]
    assert p.row() == j.row().replace("% of mxu roof", "% of tensor roof")
    assert roofline_report([p]) == j_roofline_report([j]).replace(
        "% of mxu roof", "% of tensor roof")


class TestProfileStep:
    def test_times_a_real_step(self):
        w = torch.eye(128)
        x0 = torch.ones(128, 128)

        def step(x, w):
            return x @ w

        p = profile_step(
            step, x0, w, name="matmul128", flops=2 * 128**3,
            hbm_bytes=3 * 128 * 128 * 4, inner=4,
        )
        assert p.seconds > 0
        assert p.tflops > 0
        assert p.device.platform == "cpu"
        assert "matmul128" in p.row()


class TestTrace:
    def test_trace_writes_a_chrome_trace(self, tmp_path):
        logdir = str(tmp_path / "trace")
        with trace(logdir) as prof:
            x = torch.ones(64, 64) @ torch.ones(64, 64)
        assert float(x[0, 0]) == 64.0
        files = os.listdir(logdir)
        assert len(files) == 1 and files[0].endswith(".json")
        with open(os.path.join(logdir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        assert any("aten::mm" in ev.get("name", "") for ev in events)
        assert prof.key_averages()

    def test_kernel_seconds_sums_each_op(self):
        """Without a card the trace records the CPU, and kernel_seconds
        gives each PyTorch op's own time; no logdir writes no file."""
        a = torch.randn(256, 256)
        with trace(None) as prof:
            for _ in range(3):
                a = torch.relu(a @ a)
        secs = kernel_seconds(prof, "cpu")
        assert secs.get("aten::mm", 0.0) > 0
        assert all(v > 0 for v in secs.values())
        assert kernel_seconds(prof, "cuda") == {}

    def test_timed_window_and_idle_share(self, tmp_path):
        """timed runs fn once inside a trace and returns its wall time,
        the ops' own time and the idle share 1 - kernel time / wall,
        against its own wall or another given; a logdir gets the trace."""
        a = torch.randn(256, 256)
        out = []
        win = timed(lambda: out.append(torch.relu(a @ a)), "cpu",
                    str(tmp_path))
        assert len(out) == 1 and len(os.listdir(tmp_path)) == 1
        assert win.wall > 0 and win.kernels.get("aten::mm", 0.0) > 0
        assert win.busy == sum(win.kernels.values())
        assert win.idle_share() == 1.0 - win.busy / win.wall
        assert win.idle_share(2 * win.busy) == 0.5
