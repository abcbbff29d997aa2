"""Deterministic fault injection for the population evaluator.

A ``FaultInjector`` wraps ``PopulationEvaluator`` through two hooks the
evaluator calls on its hot path (``ev.faults = FaultInjector(...)``):

- ``on_dispatch(ev)`` — immediately before every jitted batch dispatch.
  Policies can raise here: ``FailDispatch`` throws a
  ``TransientDispatchError`` (absorbed by the evaluator's bounded
  retry-with-backoff), ``LoseDevices`` throws ``DeviceLossError`` (the
  evaluator rebinds its dispatch to the surviving mesh and re-runs the
  generation).
- ``on_result(ev, errs)`` — on every completed generation's final
  per-candidate error array. ``PoisonLanes`` overwrites chosen lanes with
  NaN/Inf, exercising the search's quarantine guard.

Everything is deterministic: policies fire at fixed dispatch/batch
indices, and any per-event randomness (which lanes to poison) draws from
``SeedSequence([seed, event_index])`` — the same schedule reproduces
bit-for-bit from the same seed, so every fault scenario is a regression
test, not a flake.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


class FaultError(Exception):
    """Base class of every injected fault."""


class TransientDispatchError(FaultError):
    """A dispatch failure that a bounded retry is expected to absorb."""


class DeviceLossError(FaultError):
    """Simulated loss of mesh devices mid-search; ``keep`` devices
    survive. The evaluator re-pads and re-dispatches the generation on the
    surviving mesh (exact per-shard programs keep bit parity)."""

    def __init__(self, keep: int):
        super().__init__(f"simulated device loss: {keep} devices survive")
        self.keep = keep


# the exception types the evaluator's retry loop is allowed to absorb —
# retry sites must name what they catch (analyzer rule R6)
TRANSIENT_DISPATCH_ERRORS = (TransientDispatchError,)


@dataclass(frozen=True)
class FailDispatch:
    """Raise ``TransientDispatchError`` on dispatches
    [at, at + times) (1-based global dispatch index)."""
    at: int
    times: int = 1


@dataclass(frozen=True)
class LoseDevices:
    """Raise ``DeviceLossError(keep)`` on the ``at``-th dispatch."""
    at: int
    keep: int = 4


@dataclass(frozen=True)
class PoisonLanes:
    """Overwrite ``n_lanes`` lanes of the ``at``-th completed batch's
    error array with ``value`` (NaN by default). Lanes are an explicit
    tuple or a seeded draw from the injector's schedule RNG."""
    at: int
    n_lanes: int = 1
    value: float = float("nan")
    lanes: Optional[Tuple[int, ...]] = None


@dataclass
class FaultInjector:
    """A seeded fault schedule over an evaluator's dispatch/batch
    counters. ``log`` records every injected event (structured dicts) in
    firing order."""
    policies: Sequence[object] = ()
    seed: int = 0
    n_dispatches: int = 0
    n_batches: int = 0
    log: List[dict] = field(default_factory=list)

    def _rng(self, event_index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, event_index]))

    def on_dispatch(self, evaluator) -> None:
        """Called before each jitted dispatch; raises to inject."""
        self.n_dispatches += 1
        i = self.n_dispatches
        for pol in self.policies:
            if isinstance(pol, FailDispatch) \
                    and pol.at <= i < pol.at + pol.times:
                self.log.append({"event": "fail_dispatch", "dispatch": i})
                raise TransientDispatchError(
                    f"injected transient failure on dispatch {i}")
            if isinstance(pol, LoseDevices) and pol.at == i:
                self.log.append({"event": "lose_devices", "dispatch": i,
                                 "keep": pol.keep})
                raise DeviceLossError(pol.keep)

    def on_result(self, evaluator, errs: np.ndarray) -> np.ndarray:
        """Called with each completed generation's per-candidate error
        array (float, real lanes only); returns the possibly-poisoned
        array."""
        self.n_batches += 1
        i = self.n_batches
        for pol in self.policies:
            if isinstance(pol, PoisonLanes) and pol.at == i:
                if pol.lanes is not None:
                    lanes = [l for l in pol.lanes if l < len(errs)]
                else:
                    k = min(pol.n_lanes, len(errs))
                    lanes = sorted(self._rng(i).choice(
                        len(errs), size=k, replace=False).tolist())
                errs = np.asarray(errs, float).copy()
                errs[list(lanes)] = pol.value
                self.log.append({"event": "poison_lanes", "batch": i,
                                 "lanes": [int(l) for l in lanes],
                                 "value": float(pol.value)})
        return errs
