"""Beacon-based search (paper §4.3, Algorithm 1).

A *beacon* is a retrained model placed in the search space. Candidate
solutions evaluate their error using the nearest beacon's parameters instead
of the original pre-trained ones; a new beacon is created (retraining) only
when the nearest beacon is farther than a distance threshold.

Distance (paper): D_ij = sum_k | log2 w_bits(sol_i, k) - log2 w_bits(beacon_j, k) |
— weight precisions only (the paper found activations don't matter for
neighborhood identity).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.mohaq import Alloc, MOHAQProblem


def beacon_distance(alloc_a: Alloc, alloc_b: Alloc,
                    layer_names: Sequence[str]) -> float:
    return float(sum(abs(np.log2(alloc_a[n][0]) - np.log2(alloc_b[n][0]))
                     for n in layer_names))


@dataclass
class Beacon:
    alloc: Alloc
    params: Any           # retrained full-precision parameters


@dataclass
class BeaconSearch:
    """Wraps a MOHAQProblem's error evaluation with Algorithm 1.

    retrain_fn(alloc) -> retrained params (binary-connect QAT, caller-owned).
    error_with_params(params, alloc) -> error %.
    batch_error_with_params(params, allocs) -> [error %] (optional): a
    population evaluator with an explicit parameter set — when provided,
    ``attach`` wires a *beacon-grouped* batched evaluator instead of
    detaching batching entirely (see ``batch_error_fn``).
    """
    problem: MOHAQProblem
    base_params: Any
    retrain_fn: Callable[[Alloc, Any], Any]
    error_with_params: Callable[[Any, Alloc], float]
    batch_error_with_params: Optional[
        Callable[[Any, Sequence[Alloc]], Sequence[float]]] = None
    distance_threshold: float = 6.0
    # enlarged beacon-feasible area (paper: wider than the plain feasible area
    # because retraining pulls solutions back in)
    beacon_feasible_margin: float = 16.0
    # don't retrain already-low-error solutions (paper: wasted epochs)
    min_error_gain_to_retrain: float = 1.0
    max_beacons: int = 8
    beacons: List[Beacon] = field(default_factory=list)
    n_retrains: int = 0

    @classmethod
    def from_target(cls, problem: MOHAQProblem, target, *,
                    retrain_steps: int = 60, batched: bool = True,
                    mesh=None, partition: str = "shard_map",
                    distance_threshold: float = 6.0,
                    skip_retrains: int = 0) -> "BeaconSearch":
        """Build the beacon wrapper from any ``SearchTarget`` (see
        ``repro_torch.core.api``): the retrainer comes from
        ``target.beacon_retrainer(steps)`` (one data stream per search, so
        successive retrains consume successive batches — bit-identical to
        the historical experiment wiring) and both error evaluators are
        the target's parameter-explicit paths. Beacon groups shard
        independently when a ``mesh`` is given: every grouped call is
        itself a population partitioned over the mesh.

        ``skip_retrains`` fast-forwards the retraining data stream past
        the first N retrains (checkpoint resume: the restored beacons
        already consumed those batches, so the (N+1)-th retrain of the
        resumed search must see the exact batches the uninterrupted run
        would — targets support it via the stream's ``start_step``)."""
        def error_with_params(params, alloc):
            return target.val_error(alloc, params=params)

        def batch_error_with_params(params, allocs):
            return target.val_error_batch(allocs, params=params, mesh=mesh,
                                          partition=partition)

        if skip_retrains:
            retrain_fn = target.beacon_retrainer(
                retrain_steps, skip_retrains=skip_retrains)
        else:
            retrain_fn = target.beacon_retrainer(retrain_steps)
        return cls(problem=problem, base_params=target.params,
                   retrain_fn=retrain_fn,
                   error_with_params=error_with_params,
                   batch_error_with_params=(batch_error_with_params
                                            if batched else None),
                   distance_threshold=distance_threshold)

    def _route(self, alloc: Alloc,
               base_err: float) -> Tuple[Optional[float], Optional[int]]:
        """Algorithm 1 routing for one candidate, given its base-params
        error. Returns (err, None) when the base error answers directly, or
        (None, beacon_idx) when the error must be evaluated under that
        beacon's parameters. Retrains (appending a new beacon) at exactly
        the same decision points as the sequential scalar path — routing
        depends only on base_err and the beacons existing so far, so the
        grouped batched evaluator performs the identical retrains in the
        identical order."""
        baseline = self.problem.baseline_error
        if base_err > baseline + self.beacon_feasible_margin:
            return base_err, None               # outside beacon-feasible area
        if base_err <= baseline + self.min_error_gain_to_retrain:
            return base_err, None               # low error: skip retraining
        names = self.problem.layer_names
        if self.beacons:
            dists = [beacon_distance(alloc, b.alloc, names)
                     for b in self.beacons]
            nearest = int(np.argmin(dists))
            if dists[nearest] <= self.distance_threshold:
                return None, nearest
        if len(self.beacons) < self.max_beacons:
            params = self.retrain_fn(alloc, self.base_params)
            self.beacons.append(Beacon(dict(alloc), params))
            self.n_retrains += 1
            return None, len(self.beacons) - 1
        # beacon budget exhausted: use nearest anyway
        dists = [beacon_distance(alloc, b.alloc, names) for b in self.beacons]
        return None, int(np.argmin(dists))

    def error_fn(self, alloc: Alloc) -> float:
        base_err = self.error_with_params(self.base_params, alloc)
        err, bidx = self._route(alloc, base_err)
        if err is not None:
            return err
        return self.error_with_params(self.beacons[bidx].params, alloc)

    def batch_error_fn(self, allocs: Sequence[Alloc]) -> List[float]:
        """Beacon-grouped batched evaluation (restores P-wide dispatch
        amortization for the retraining-aware search):

        1. ONE batched call scores every candidate under the base params.
        2. Candidates are routed in order through Algorithm 1 (bit-identical
           decisions to the scalar path, including any retrains, because the
           batched base errors equal the scalar ones exactly).
        3. Candidates routed to a beacon are grouped by beacon index; one
           batched call per (beacon-params, candidate-group) scores each
           group. Deferring the group evals is sound: routing fixes the
           beacon per candidate, and beacon evaluation is pure.
        """
        base_errs = self.batch_error_with_params(self.base_params, allocs)
        results: List[Optional[float]] = [None] * len(allocs)
        groups: Dict[int, List[int]] = {}
        for i, (alloc, base_err) in enumerate(zip(allocs, base_errs)):
            err, bidx = self._route(alloc, float(base_err))
            if err is not None:
                results[i] = err
            else:
                groups.setdefault(bidx, []).append(i)
        for bidx, idxs in groups.items():
            errs = self.batch_error_with_params(
                self.beacons[bidx].params, [allocs[i] for i in idxs])
            for i, e in zip(idxs, errs):
                results[i] = float(e)
        return results

    def attach(self) -> MOHAQProblem:
        """Return the problem with its error evaluation re-pointed at
        beacon logic.

        With ``batch_error_with_params`` wired, populations evaluate through
        the beacon-grouped ``batch_error_fn``; otherwise the batched
        evaluator is detached (per-candidate parameter routing cannot run
        under a single shared-params vmap). Either way the problem gets a
        fresh error memo: beacon errors are retraining-aware and must not
        mix with base-params errors cached by a previous search.
        """
        self.problem.error_fn = self.error_fn
        self.problem.batch_error_fn = (
            self.batch_error_fn
            if self.batch_error_with_params is not None else None)
        self.problem.error_memo = {}
        self.problem.memo_hits = 0
        self.problem.n_error_evals = 0
        return self.problem
