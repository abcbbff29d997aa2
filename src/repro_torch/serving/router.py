"""SLO-class routing over a deployment's Pareto front.

Copy of the reference package's ``serving/router.py`` (the reference's
``serving`` package imports JAX on import, so the port keeps its own).

The front gives a menu of operating points; the router's job is the
application-side half of the MOHAQ premise — pick the point that matches
each request's service-level objective at *request* time, not at search
time. An ``SLOClass`` declares bounds (``max_error`` in the search's
error-%% units for accuracy tiers, ``max_cost_bits`` in MAC-weighted mean
weight bits for latency tiers); the router precomputes, per class, the
feasible allocations ordered best-accuracy-first, and at ``route`` time
applies load-aware degradation:

- normal load        -> the class's best feasible allocation;
- ``queue_depth`` past ``shed_depth`` -> the class's *cheapest* feasible
  allocation (graceful degradation: keep latency bounded by spending
  fewer bits, not by dropping accuracy guarantees silently — the chosen
  lane still satisfies the class's bounds);
- ``queue_depth`` at ``max_queue`` -> admission refused (request shed).

A class with no feasible allocation falls back to the front's
minimum-violation point (never crashes); the fallback is recorded so
callers can surface it. All randomness (``spread=True`` picks uniformly
among feasible candidates to spread load) flows through a seeded
``np.random.Generator`` — never the global numpy RNG — so routing is a
pure function of (seed, arrival order).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.artifact import DeploymentArtifact


@dataclass(frozen=True)
class SLOClass:
    """One service tier. ``None`` bounds are unconstrained."""
    name: str
    max_error: Optional[float] = None       # search error, % units
    max_cost_bits: Optional[float] = None   # MAC-weighted mean weight bits

    def violation(self, error: Optional[float], cost_bits: float) -> float:
        """Total bound violation of an operating point (0.0 == feasible).

        A point with unknown error (artifact packed without objective
        rows) is treated as feasible on the error axis: the front is
        Pareto-optimal by construction, so cost ordering is the only
        information available and the class degenerates to a latency tier.
        """
        v = 0.0
        if self.max_error is not None and error is not None:
            v += max(0.0, error - self.max_error)
        if self.max_cost_bits is not None:
            v += max(0.0, cost_bits - self.max_cost_bits)
        return v


def default_classes(artifact: DeploymentArtifact) -> List[SLOClass]:
    """Three tiers spanning the front by cost quantiles.

    ``premium`` admits everything (always gets the most accurate point),
    ``standard`` caps cost at the front's upper cost tercile, ``economy``
    at the lower tercile — so on any non-degenerate front the three
    classes map to genuinely different allocations.
    """
    costs = np.asarray([artifact.cost_bits(i)
                        for i in range(artifact.n_allocs)], np.float64)
    hi = float(np.quantile(costs, 2.0 / 3.0))
    lo = float(np.quantile(costs, 1.0 / 3.0))
    return [
        SLOClass("premium"),
        SLOClass("standard", max_cost_bits=hi),
        SLOClass("economy", max_cost_bits=lo),
    ]


@dataclass
class RouteDecision:
    alloc: int                  # front index, or -1 when shed
    slo: str
    shed: bool = False          # admission refused
    degraded: bool = False      # load-shed to the cheapest feasible point
    fallback: bool = False      # class infeasible; min-violation point used


class Router:
    """Maps (SLO class, queue depth) -> front allocation index."""

    def __init__(self, artifact: DeploymentArtifact,
                 classes: Optional[Sequence[SLOClass]] = None, *,
                 max_queue: int = 64, shed_depth: Optional[int] = None,
                 seed: int = 0, spread: bool = False):
        if artifact.n_allocs == 0:
            raise ValueError("cannot route over an empty front: the "
                             "artifact packs no allocations")
        self.artifact = artifact
        self.classes = list(classes) if classes is not None \
            else default_classes(artifact)
        if not self.classes:
            raise ValueError("need at least one SLO class")
        self.max_queue = int(max_queue)
        self.shed_depth = int(shed_depth if shed_depth is not None
                              else max(1, self.max_queue // 2))
        self.spread = bool(spread)
        self._rng = np.random.Generator(
            np.random.PCG64(np.random.SeedSequence(seed)))
        self._by_name: Dict[str, SLOClass] = {c.name: c for c in self.classes}
        # Per class: feasible allocation indices best-accuracy-first (error
        # ascending, cost descending breaks unknown-error ties toward the
        # point the search spent the most bits on), plus the fallback.
        self._candidates: Dict[str, List[int]] = {}
        self._fallback: Dict[str, int] = {}
        errs = [artifact.error(i) for i in range(artifact.n_allocs)]
        costs = [artifact.cost_bits(i) for i in range(artifact.n_allocs)]
        for c in self.classes:
            order = sorted(
                range(artifact.n_allocs),
                key=lambda i: (errs[i] if errs[i] is not None else 0.0,
                               -costs[i]))
            feas = [i for i in order if c.violation(errs[i], costs[i]) == 0.0]
            self._candidates[c.name] = feas
            self._fallback[c.name] = min(
                order, key=lambda i: c.violation(errs[i], costs[i]))

    def slo_class(self, name: str) -> SLOClass:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"unknown SLO class {name!r}; have "
                           f"{sorted(self._by_name)}") from None

    def admit(self, queue_depth: int) -> bool:
        return queue_depth < self.max_queue

    def route(self, slo: str, queue_depth: int = 0) -> RouteDecision:
        """Pick the allocation for one request of class ``slo``."""
        cls = self.slo_class(slo)
        if not self.admit(queue_depth):
            return RouteDecision(alloc=-1, slo=slo, shed=True)
        cand = self._candidates[slo]
        if not cand:
            return RouteDecision(alloc=self._fallback[slo], slo=slo,
                                 fallback=True)
        if queue_depth > self.shed_depth:
            cheapest = min(cand, key=self.artifact.cost_bits)
            return RouteDecision(alloc=cheapest, slo=slo,
                                 degraded=cheapest != cand[0])
        if self.spread and len(cand) > 1:
            return RouteDecision(alloc=cand[int(self._rng.integers(
                len(cand)))], slo=slo)
        return RouteDecision(alloc=cand[0], slo=slo)

    def candidates(self, slo: str) -> List[int]:
        """Feasible front indices for a class, best-accuracy-first."""
        return list(self._candidates[self.slo_class(slo).name])
