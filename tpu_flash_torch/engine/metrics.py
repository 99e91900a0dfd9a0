"""Engine observability: per-step structured decode metrics.

The reference's only observability is printf (tests/main.cu:69-71) and an
untracked debug-macro header (.gitignore:3); this provides the structured
per-request decode metrics SURVEY.md §5 requires: tokens/s, batch occupancy,
prefill/decode split, step latency percentiles.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List


# The engine's dispatch routes: a same-stage prefill group, a mixed-stage
# ragged prefill, a ragged prefill that carries the step's decode rows, a
# decode burst, a speculative verify.
ROUTES = ("prefill_group", "prefill_ragged", "fused", "decode",
          "speculative")


@dataclasses.dataclass
class EngineMetrics:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0
    total_seconds: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)
    occupancy_sum: float = 0.0
    started_at: float = dataclasses.field(default_factory=time.perf_counter)
    # One entry per engine dispatch, in order: its route (one of ROUTES).
    dispatches: List[str] = dataclasses.field(default_factory=list)
    # Per route: seconds spent in its dispatches, and their tokens
    # (prompt tokens for the prefill routes and fused steps, committed
    # tokens for decode bursts and speculative steps).
    route_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    route_tokens: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Synchronise the device around each dispatch, so that route_seconds
    # hold its device work (for profiling: it gives up the overlap of
    # host and device work between dispatches).
    sync_dispatches: bool = False

    def record_step(
        self,
        prefill_tokens: int,
        decode_tokens: int,
        step_seconds: float,
        batch_occupancy: float,
    ) -> None:
        self.prefill_tokens += prefill_tokens
        self.decode_tokens += decode_tokens
        self.steps += 1
        self.total_seconds += step_seconds
        self.step_times.append(step_seconds)
        self.occupancy_sum += batch_occupancy

    def record_dispatch(self, route: str, seconds: float,
                        tokens: int) -> None:
        self.dispatches.append(route)
        self.route_seconds[route] = (
            self.route_seconds.get(route, 0.0) + seconds
        )
        self.route_tokens[route] = self.route_tokens.get(route, 0) + tokens

    def route_counts(self) -> Dict[str, int]:
        """Dispatches per route, every route listed."""
        return {r: self.dispatches.count(r) for r in ROUTES}

    @property
    def decode_tokens_per_second(self) -> float:
        return self.decode_tokens / self.total_seconds if self.total_seconds else 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    def percentile_step_ms(self, pct: float) -> float:
        if not self.step_times:
            return 0.0
        xs = sorted(self.step_times)
        idx = min(int(len(xs) * pct / 100.0), len(xs) - 1)
        return xs[idx] * 1e3

    def summary(self) -> Dict[str, object]:
        return {
            "steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": round(self.decode_tokens_per_second, 2),
            "mean_batch_occupancy": round(self.mean_occupancy, 4),
            "p50_step_ms": round(self.percentile_step_ms(50), 3),
            "p99_step_ms": round(self.percentile_step_ms(99), 3),
            "wall_seconds": round(self.total_seconds, 3),
            "dispatches": self.route_counts(),
        }

    def to_json(self) -> str:
        return json.dumps(self.summary())
