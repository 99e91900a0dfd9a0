"""Tracing, per-kernel profiling and roofline reporting: the port of
``tpu_flash/utils/profiling.py``.

* ``trace(logdir)``: a context manager around ``torch.profiler`` over CPU
  and CUDA activity that writes a Chrome/Perfetto trace of everything
  inside under ``logdir`` (open it in ``chrome://tracing`` or
  ui.perfetto.dev). It yields the profiler, whose events
  :func:`kernel_seconds` sums by kernel.
* ``timed(fn, device)``: one call of ``fn`` under ``trace`` between two
  synchronisations: its wall time, its kernel time and the device's idle
  share (the port's one definition of it).
* ``profile_step``: the time of a step function by the bench's
  differential timing (``bench/suite.py::time_per_call``), annotated with
  its FLOPs and bytes.
* ``roofline_report``: achieved against achievable (the smaller of the
  tensor-core peak and intensity x memory rate) per profile.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterable, Optional

import torch

from tpu_flash_torch.utils.device import DeviceInfo, device_info


@contextlib.contextmanager
def trace(logdir: Optional[str], *, host_tracer_level: int = 2):
    """Profile the enclosed block with ``torch.profiler``; yields the
    profiler.

    CUDA activity is recorded when there is a card, CPU activity unless
    ``host_tracer_level`` is 0 (device kernels alone: host-side op
    tracing slows an eager, host-bound loop such as decode and inflates
    its idle share; without a card the CPU is always recorded). With a
    ``logdir`` the trace is written there as
    ``trace_<pid>_<ns>.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if host_tracer_level > 0 or not activities:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def kernel_seconds(prof, device="cuda") -> Dict[str, float]:
    """Self time by name of a finished ``trace``: the device time of each
    CUDA kernel, or on the CPU the time of each PyTorch op itself."""
    cuda = torch.device(device).type == "cuda"
    out: Dict[str, float] = {}
    for ev in prof.key_averages():
        if cuda:
            if ev.device_type.name != "CUDA":
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
        else:
            us = ev.self_cpu_time_total
        if us and ev.key:
            out[ev.key] = out.get(ev.key, 0.0) + us * 1e-6
    return out


@dataclasses.dataclass(frozen=True)
class Window:
    """A traced window: the host's wall seconds and each kernel's
    device seconds (``kernel_seconds``)."""

    wall: float
    kernels: Dict[str, float]

    @property
    def busy(self) -> float:
        """Summed kernel time."""
        return sum(self.kernels.values())

    def idle_share(self, wall: Optional[float] = None) -> float:
        """1 - kernel time / wall time (one stream): the share of this
        window's wall time, or of ``wall`` for the same work run
        untraced, that the device spent idle."""
        return 1.0 - self.busy / (self.wall if wall is None else wall)


def timed(fn, device="cuda", logdir: Optional[str] = None) -> Window:
    """Run ``fn()`` once under ``trace`` between two synchronisations of
    ``device`` and return its window. On a card only device activity is
    recorded: host-side op tracing slows an eager, host-bound loop such
    as decode and inflates its idle share. On the CPU each op's own time
    stands for kernel time."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with trace(logdir, host_tracer_level=0 if cuda else 2) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return Window(wall, kernel_seconds(prof, device))


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """One profiled kernel or step: measured time and roofline placement."""

    name: str
    seconds: float
    flops: float
    hbm_bytes: float
    device: DeviceInfo

    @property
    def tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def hbm_gbps(self) -> float:
        return self.hbm_bytes / self.seconds / 1e9

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOP per HBM byte."""
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def roofline_tflops(self) -> float:
        return self.device.roofline_attention_tflops(
            self.flops, self.hbm_bytes
        )

    @property
    def roofline_frac(self) -> float:
        r = self.roofline_tflops
        return self.tflops / r if r else 0.0

    @property
    def bound(self) -> str:
        """Which roof applies at this intensity: "tensor" (the tensor
        cores' bf16 peak) or "hbm"."""
        bw_tflops = (
            self.intensity * self.device.hbm_bandwidth_gbps * 1e9 / 1e12
        )
        return "hbm" if bw_tflops < self.device.peak_bf16_tflops else "tensor"

    def row(self) -> str:
        return (
            f"{self.name:<44s} {self.seconds * 1e3:>8.3f} ms "
            f"{self.tflops:>7.1f} TF/s {self.hbm_gbps:>7.1f} GB/s "
            f"{100 * self.roofline_frac:>5.1f}% of {self.bound} roof"
        )


def profile_step(
    step,
    x0,
    *rest,
    name: str,
    flops: float,
    hbm_bytes: float,
    inner: int = 16,
    info: Optional[DeviceInfo] = None,
) -> KernelProfile:
    """Profile ``step(x0, *rest)`` by differential timing
    (``bench/suite.py::time_per_call``: n and 2n calls between device
    synchronisations, the difference over n) on ``x0``'s device."""
    from tpu_flash_torch.bench.suite import time_per_call

    secs = time_per_call(lambda: step(x0, *rest), device=x0.device,
                         inner=inner)
    return KernelProfile(
        name=name,
        seconds=secs,
        flops=flops,
        hbm_bytes=hbm_bytes,
        device=info or device_info(x0.device),
    )


def roofline_report(profiles: Iterable[KernelProfile]) -> str:
    """Multi-line report: achieved against roofline per profile."""
    profiles = list(profiles)
    if not profiles:
        return "(no profiles)"
    info = profiles[0].device
    header = (
        f"device: {info.kind} | peak {info.peak_bf16_tflops:.0f} BF16 "
        f"TFLOP/s | HBM {info.hbm_bandwidth_gbps:.0f} GB/s\n"
        f"{'kernel':<44s} {'time':>11s} {'achieved':>12s} "
        f"{'hbm':>12s} {'roofline':>20s}"
    )
    return "\n".join([header] + [p.row() for p in profiles])
