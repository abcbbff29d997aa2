"""Structured serving telemetry.

Copy of the reference package's ``serving/metrics.py``.

The batcher stamps wall-clock times at enqueue / first-dispatch / retire
and per-step compute spans; this module turns those stamps into the
per-request latency decomposition (queue vs compute vs total) and the
aggregate throughput/percentile rows (``chip_smoke.py`` prints them).
Pure host bookkeeping.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class RequestRecord:
    """Lifecycle stamps of one request (seconds, perf_counter domain)."""
    rid: int
    slo: str
    alloc: int
    tokens: int = 0                   # frames actually served
    t_enqueue: float = 0.0
    t_start: Optional[float] = None   # first step that computed this lane
    t_done: Optional[float] = None
    shed: bool = False
    degraded: bool = False
    fallback: bool = False

    @property
    def queue_s(self) -> Optional[float]:
        if self.t_start is None:
            return None
        return self.t_start - self.t_enqueue

    @property
    def compute_s(self) -> Optional[float]:
        if self.t_start is None or self.t_done is None:
            return None
        return self.t_done - self.t_start

    @property
    def total_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_enqueue

    @property
    def tokens_per_s(self) -> Optional[float]:
        t = self.total_s
        if t is None or t <= 0.0 or self.tokens == 0:
            return None
        return self.tokens / t


@dataclass
class StepRecord:
    """One batcher step: how many lanes were live and what it cost."""
    step: int
    n_lanes: int          # live (non-pad) lanes in the dispatch
    bucket: int           # compile bucket the dispatch padded to
    tokens: int           # frames produced across live lanes
    compute_s: float
    n_dispatches: int = 1  # >1 only for the serial per-group baseline


@dataclass
class ServingLog:
    """Accumulates request + step records and reduces them to bench rows."""
    requests: Dict[int, RequestRecord] = field(default_factory=dict)
    steps: List[StepRecord] = field(default_factory=list)

    def add_request(self, rec: RequestRecord) -> RequestRecord:
        self.requests[rec.rid] = rec
        return rec

    def add_step(self, rec: StepRecord) -> StepRecord:
        self.steps.append(rec)
        return rec

    # -- reductions ------------------------------------------------------
    def completed(self) -> List[RequestRecord]:
        return [r for r in self.requests.values()
                if r.t_done is not None and not r.shed]

    def shed_count(self) -> int:
        return sum(1 for r in self.requests.values() if r.shed)

    def total_tokens(self) -> int:
        return sum(r.tokens for r in self.completed())

    def tokens_per_s(self) -> float:
        """Aggregate throughput over the busy span (first enqueue to last
        retire) — the headline open-loop number."""
        done = self.completed()
        if not done:
            return 0.0
        t0 = min(r.t_enqueue for r in done)
        t1 = max(r.t_done for r in done)
        span = t1 - t0
        return 0.0 if span <= 0.0 else self.total_tokens() / span

    def step_latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 of per-step compute seconds (the SLO-facing number:
        a decode step is the unit of head-of-line blocking)."""
        if not self.steps:
            return {"p50_s": 0.0, "p99_s": 0.0}
        xs = np.asarray([s.compute_s for s in self.steps], np.float64)
        return {"p50_s": float(np.percentile(xs, 50)),
                "p99_s": float(np.percentile(xs, 99))}

    def latency_summary(self) -> Dict[str, float]:
        done = self.completed()
        if not done:
            return {}
        q = np.asarray([r.queue_s for r in done], np.float64)
        c = np.asarray([r.compute_s for r in done], np.float64)
        t = np.asarray([r.total_s for r in done], np.float64)
        return {
            "queue_mean_s": float(q.mean()),
            "compute_mean_s": float(c.mean()),
            "total_mean_s": float(t.mean()),
            "total_p99_s": float(np.percentile(t, 99)),
        }

    def summary(self) -> Dict[str, object]:
        """Everything the bench row needs, JSON-ready."""
        out: Dict[str, object] = {
            "n_completed": len(self.completed()),
            "n_shed": self.shed_count(),
            "n_steps": len(self.steps),
            "n_dispatches": sum(s.n_dispatches for s in self.steps),
            "tokens": self.total_tokens(),
            "tokens_per_s": self.tokens_per_s(),
        }
        out.update(self.step_latency_percentiles())
        out.update(self.latency_summary())
        by_slo: Dict[str, int] = {}
        for r in self.completed():
            by_slo[r.slo] = by_slo.get(r.slo, 0) + 1
        out["by_slo"] = by_slo
        return out
