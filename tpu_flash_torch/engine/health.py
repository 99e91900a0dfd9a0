"""Failure detection and health monitoring for the engine.

The port of ``tpu_flash/engine/health.py``: a NaN/Inf watchdog on the
logits of every prefill/decode step (the engine computes the finite flag
on the device and fetches it with the step's results), a per-step
wall-clock deadline on device-to-host fetches, and a structured health
status for operators.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import time
from typing import List, Optional


class EngineFailure(RuntimeError):
    """Base class for health-check failures raised by the engine."""


class NumericsError(EngineFailure):
    """Non-finite values detected in step outputs (NaN/Inf watchdog)."""


class StepTimeoutError(EngineFailure):
    """A device step failed to produce results within the deadline."""


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Engine health-check policy.

    ``check_numerics`` computes an ``isfinite`` reduction on the device
    in each step (the flag travels with the tokens the host fetches
    anyway). ``step_timeout_s`` bounds the host-side
    wait for each step's results; a hung device/relay surfaces as
    ``StepTimeoutError`` instead of a silent stall. ``slow_step_factor``
    marks steps slower than factor x the trailing-mean as degraded.
    """

    check_numerics: bool = True
    step_timeout_s: Optional[float] = None  # None = wait forever
    slow_step_factor: float = 10.0
    window: int = 64

    def __post_init__(self):
        if self.step_timeout_s is not None and self.step_timeout_s <= 0:
            raise ValueError("step_timeout_s must be positive or None")
        if self.slow_step_factor <= 1.0:
            raise ValueError("slow_step_factor must be > 1")


@dataclasses.dataclass
class HealthMonitor:
    """Aggregated engine health: step outcomes, slow-step detection,
    terminal failure state. One per engine instance."""

    config: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    steps: int = 0
    slow_steps: int = 0
    failure: Optional[str] = None
    _durations: List[float] = dataclasses.field(default_factory=list)

    def record_step(self, duration_s: float) -> None:
        self.steps += 1
        window = self._durations[-self.config.window :]
        if window:
            mean = sum(window) / len(window)
            if duration_s > self.config.slow_step_factor * max(mean, 1e-6):
                self.slow_steps += 1
        self._durations.append(duration_s)
        if len(self._durations) > self.config.window:
            del self._durations[: -self.config.window]

    def record_failure(self, kind: str, detail: str) -> None:
        self.failure = f"{kind}: {detail}"

    @property
    def status(self) -> str:
        if self.failure is not None:
            return "failed"
        if self.steps and self.slow_steps / max(self.steps, 1) > 0.1:
            return "degraded"
        return "healthy"

    def to_json(self) -> str:
        return json.dumps(
            {
                "status": self.status,
                "steps": self.steps,
                "slow_steps": self.slow_steps,
                "failure": self.failure,
            }
        )


class DeadlineFetcher:
    """Fetch device tensors to the host with a wall-clock deadline.

    ``fetch(x)`` returns ``x`` as a numpy array (a ``.cpu()`` copy, which
    waits for the device) or raises ``StepTimeoutError`` when the
    deadline passes. With a deadline the copy runs on a worker thread so
    a hung device does not wedge the engine's control loop; it runs on
    the caller's current CUDA stream (a data-parallel replica steps on a
    stream of its own), so it waits for the work that made ``x``.
    """

    def __init__(self, timeout_s: Optional[float]):
        self._timeout = timeout_s
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1)
            if timeout_s is not None
            else None
        )

    @staticmethod
    def _to_host(x, stream=None):
        import numpy as np

        if stream is not None:
            import torch

            with torch.cuda.stream(stream):
                return x.detach().cpu().numpy()
        if hasattr(x, "detach"):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def fetch(self, x, *, scale: float = 1.0):
        """Fetch with the configured deadline x ``scale`` (burst decode
        passes its step count so the per-step contract holds)."""
        if self._pool is None:
            return self._to_host(x)
        stream = None
        if getattr(x, "is_cuda", False):
            import torch

            stream = torch.cuda.current_stream(x.device)
        fut = self._pool.submit(self._to_host, x, stream)
        try:
            return fut.result(timeout=self._timeout * scale)
        except concurrent.futures.TimeoutError:
            # The worker is wedged inside the copy; abandon it and start a
            # fresh pool so a transient stall doesn't poison later fetches.
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            raise StepTimeoutError(
                f"device step exceeded {self._timeout * scale:g}s deadline"
            ) from None

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)


def watchdog_check(
    monitor: HealthMonitor,
    finite_flag,
    *,
    phase: str,
    request_ids: List[int],
) -> None:
    """Raise NumericsError if a step's fused isfinite flag is False."""
    if not bool(finite_flag):
        detail = (
            f"non-finite logits in {phase} step "
            f"(requests {request_ids}); likely causes: fp overflow in "
            f"unscaled weights, corrupted KV pages, or quantization "
            f"underflow"
        )
        monitor.record_failure("numerics", detail)
        raise NumericsError(detail)


class StepTimer:
    """Context manager: times a step into the monitor."""

    def __init__(self, monitor: HealthMonitor):
        self._monitor = monitor

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._monitor.record_step(time.perf_counter() - self._t0)
        return False
