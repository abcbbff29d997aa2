"""MOHAQ orchestration (paper Fig. 4).

Inputs: pre-trained parameters, a hardware model (objective equations +
constraints), an error evaluator. Output: a Pareto set of per-layer
(w_bits, a_bits) allocations.

Model-agnostic by construction: a problem sees only layer names, count
dicts and error callables — never a model object. ``repro_torch.core.api``
builds problems from any ``SearchTarget`` (``build_problem_from_target``)
and ``SearchSession`` is the preferred front door; this module stays the
engine underneath.

Genome encoding follows the paper: precision p in {2,4,8,16} encoded as the
integer log2(p)-1 in {1,2,3,4}; one gene per layer-weight + one per
layer-activation (SiLago ties them: one gene per layer).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import HardwareModel
from repro_torch.core.nsga2 import NSGA2, Individual

BITS_OF_CODE = {1: 2, 2: 4, 3: 8, 4: 16}
CODE_OF_BITS = {v: k for k, v in BITS_OF_CODE.items()}

Alloc = Dict[str, Tuple[int, int]]


@dataclass
class MOHAQProblem:
    layer_names: Sequence[str]
    layer_macs: Dict[str, int]
    layer_weights: Dict[str, int]
    vector_weights: int
    hardware: HardwareModel
    error_fn: Callable[[Alloc], float]        # -> error % (lower better)
    baseline_error: float
    # optional vectorized error evaluator: list of allocs -> list of error %
    # (one vmapped forward scoring the whole population, see batched_eval).
    # Must agree with error_fn exactly; only memory-feasible candidates are
    # passed, so infeasible genomes never occupy a vmap lane.
    batch_error_fn: Optional[Callable[[Sequence[Alloc]],
                                      Sequence[float]]] = None
    fixed_ops: int = 0            # element-wise + nonlinear ops, always 16-bit
    objectives: Sequence[str] = ("error", "speedup", "energy")
    feasible_error_margin: float = 8.0        # paper: baseline + 8 pp
    base_bits: int = 32
    # allocation-keyed error memo: a quantization allocation is scored at
    # most once per search, no matter how many genomes snap to it (and, when
    # a shared dict is injected, at most once across a multi-platform sweep
    # — the error objective depends only on the allocation, not the
    # hardware model). Hardware objectives are closed-form and recomputed.
    error_memo: Optional[Dict[tuple, float]] = None
    memo_hits: int = 0
    n_error_evals: int = 0
    # NaN/Inf quarantine (graceful degradation): a poisoned error value
    # would break the dominance machinery (NaN comparisons are all-False,
    # so a poisoned individual looks non-dominated and corrupts front 0).
    # ``_finish`` instead records the genome, assigns worst-case
    # objectives plus a large constraint violation (Deb's feasibility rule
    # keeps it off every feasible front) and the search continues; each
    # quarantined allocation is logged once in ``quarantine_log``.
    quarantine_log: List[Dict] = field(default_factory=list)
    n_quarantined: int = 0
    _quarantined_keys: set = field(default_factory=set)

    def __post_init__(self):
        menu = [b for b in (2, 4, 8, 16) if b in self.hardware.supported_bits]
        self.codes = sorted(CODE_OF_BITS[b] for b in menu)
        self.tied = self.hardware.weights_equal_acts
        self.genes_per_layer = 1 if self.tied else 2
        self.n_var = len(self.layer_names) * self.genes_per_layer
        if self.error_memo is None:
            self.error_memo = {}

    def _alloc_key(self, alloc: Alloc) -> tuple:
        return tuple((n, alloc[n]) for n in self.layer_names)

    # ---- genome <-> allocation ----
    def decode(self, genome: np.ndarray) -> Alloc:
        alloc: Alloc = {}
        for i, name in enumerate(self.layer_names):
            if self.tied:
                b = BITS_OF_CODE[int(genome[i])]
                alloc[name] = (b, b)
            else:
                alloc[name] = (BITS_OF_CODE[int(genome[2 * i])],
                               BITS_OF_CODE[int(genome[2 * i + 1])])
        return alloc

    def encode(self, alloc: Alloc) -> np.ndarray:
        g = []
        for name in self.layer_names:
            wb, ab = alloc[name]
            g.append(CODE_OF_BITS[wb])
            if not self.tied:
                g.append(CODE_OF_BITS[ab])
            else:
                assert wb == ab
        return np.asarray(g, int)

    # ---- objective evaluation ----
    def hardware_objectives(self, alloc: Alloc) -> Dict[str, float]:
        out = {"speedup": self.hardware.speedup(self.layer_macs, alloc,
                                                self.fixed_ops),
               "energy": self.hardware.energy_joules(
                   self.layer_macs, self.layer_weights, alloc,
                   self.vector_weights)}
        mat_bits = sum(w * alloc[n][0] for n, w in self.layer_weights.items())
        bits = mat_bits + self.vector_weights * 16
        out["memory"] = bits / 8.0
        # paper convention: compression ratio over the MxV matrices only
        n_mat = sum(self.layer_weights.values())
        out["compression"] = n_mat * self.base_bits / mat_bits
        return out

    def _snap(self, genome: np.ndarray) -> np.ndarray:
        """Snap genes to the supported precision menu."""
        return np.asarray([min(self.codes, key=lambda c: abs(c - g))
                           for g in genome])

    def _screen(self, genome: np.ndarray):
        """Constraint screening shared by the scalar and batched paths:
        decode, check the SRAM bound. Returns (alloc, mem_violation) where a
        positive violation means the candidate must NOT reach the error
        evaluator (its error is inf by convention)."""
        alloc = self.decode(self._snap(genome))
        fits, size = self.hardware.model_fits(
            self.layer_weights, alloc, self.vector_weights)
        if fits:
            return alloc, 0.0
        return alloc, (size / self.hardware.sram_bytes) - 1.0

    # constraint violation assigned to quarantined genomes: large enough
    # that no legitimately-infeasible candidate (violations are O(1))
    # ever dominates one, so quarantine can never displace real solutions
    QUARANTINE_VIOLATION = 1e6

    def _quarantine(self, alloc: Alloc, raw_err: float) -> None:
        # count/log each distinct allocation once: re-encounters (memo
        # hits on a NaN entry) re-apply the worst-case objectives but are
        # not new quarantine events, so ``n_quarantined`` always equals
        # ``len(quarantine_log)`` (checkpoint resume relies on this)
        key = self._alloc_key(alloc)
        if key not in self._quarantined_keys:
            self._quarantined_keys.add(key)
            self.n_quarantined += 1
            self.quarantine_log.append({
                "alloc": {n: list(alloc[n]) for n in self.layer_names},
                "raw_error": float(raw_err),
                "action": "quarantined (worst-case objectives, "
                          "excluded from feasible fronts)"})

    def _finish(self, alloc: Alloc, err: float,
                violation: float) -> Tuple[List[float], float]:
        if violation == 0.0 and not np.isfinite(err):
            # poisoned evaluation (NaN/Inf from a faulty lane): quarantine
            # instead of letting NaN corrupt the dominance matrix
            self._quarantine(alloc, err)
            err = float("inf")
            violation = self.QUARANTINE_VIOLATION
        if np.isfinite(err) and \
                err > self.baseline_error + self.feasible_error_margin:
            violation += (err - self.baseline_error
                          - self.feasible_error_margin) / 100.0
        return self._pack(err, self.hardware_objectives(alloc)), violation

    def evaluate(self, genome: np.ndarray) -> Tuple[List[float], float]:
        alloc, violation = self._screen(genome)
        if violation > 0.0:
            # infeasible in memory: skip the (costly) error eval
            return self._finish(alloc, float("inf"), violation)
        key = self._alloc_key(alloc)
        if key in self.error_memo:
            self.memo_hits += 1
            err = self.error_memo[key]
        else:
            err = self.error_fn(alloc)
            self.error_memo[key] = err
            self.n_error_evals += 1
        return self._finish(alloc, err, violation)

    def evaluate_population(
            self, genomes: Sequence[np.ndarray]
    ) -> List[Tuple[List[float], float]]:
        """Population-level evaluation: memory-infeasible genomes are
        screened out first (they never occupy a vmap lane), memoized
        allocations are filled from the error memo, then the remaining
        allocations (deduplicated — distinct genomes can snap to one
        allocation) are scored in ONE ``batch_error_fn`` call (scalar
        ``error_fn`` loop when no batched evaluator is wired)."""
        results: List[Optional[Tuple[List[float], float]]] = \
            [None] * len(genomes)
        pending: List[Tuple[int, Alloc, tuple]] = []
        fresh_keys: List[tuple] = []
        fresh_allocs: List[Alloc] = []
        for i, genome in enumerate(genomes):
            alloc, violation = self._screen(genome)
            if violation > 0.0:
                results[i] = self._finish(alloc, float("inf"), violation)
                continue
            key = self._alloc_key(alloc)
            if key in self.error_memo:
                self.memo_hits += 1
            elif key not in fresh_keys:
                fresh_keys.append(key)
                fresh_allocs.append(alloc)
            else:                      # duplicate within this batch
                self.memo_hits += 1
            pending.append((i, alloc, key))
        if fresh_allocs:
            if self.batch_error_fn is not None:
                errs = list(self.batch_error_fn(fresh_allocs))
            else:
                errs = [self.error_fn(a) for a in fresh_allocs]
            for key, err in zip(fresh_keys, errs):
                self.error_memo[key] = float(err)
                self.n_error_evals += 1
        for i, alloc, key in pending:
            results[i] = self._finish(alloc, self.error_memo[key], 0.0)
        return results

    def _pack(self, err: float, hw: Dict[str, float]) -> List[float]:
        objs = []
        for name in self.objectives:
            if name == "error":
                objs.append(err)
            elif name == "speedup":
                objs.append(-hw["speedup"])          # maximize
            else:
                objs.append(hw[name])
        return objs


@dataclass
class MOHAQResult:
    problem: MOHAQProblem
    pareto: List[Individual]
    n_evals: int
    # memoization accounting for the run: genome-level repeats skipped by
    # the GA's cross-generation cache, and allocation-level repeats skipped
    # by the problem's error memo
    n_cache_hits: int = 0
    n_memo_hits: int = 0

    def rows(self) -> List[Dict]:
        out = []
        for ind in sorted(self.pareto, key=lambda s: s.objectives[0]):
            alloc = self.problem.decode(ind.genome)
            hw = self.problem.hardware_objectives(alloc)
            row = {"alloc": alloc, "error": float(ind.objectives[0])}
            row.update({k: float(v) for k, v in hw.items()})
            out.append(row)
        return out


def run_search(problem: MOHAQProblem, *, n_generations: int = 60,
               pop_size: int = 10, initial_pop_size: int = 40,
               seed: int = 0, log=None,
               batched: Optional[bool] = None,
               on_generation=None, resume_state=None) -> MOHAQResult:
    """Inference-only search (paper §4.2). 60 generations x 10 individuals
    (40 in generation 0) — the paper's settings.

    ``batched=None`` (auto) scores each generation's candidates with one
    vmapped forward whenever the problem has a ``batch_error_fn`` wired;
    ``batched=False`` forces the per-candidate scalar path. Both paths visit
    identical genomes and return the identical Pareto front.

    ``on_generation``/``resume_state`` pass straight through to
    ``NSGA2.run`` — the checkpoint/resume hooks (see
    the reference package's ``core/checkpointing.py``; restoring the problem's error memo and
    counters is the caller's job)."""
    codes = problem.codes
    if batched is None:
        batched = problem.batch_error_fn is not None
    ga = NSGA2(n_var=problem.n_var, var_lo=min(codes), var_hi=max(codes),
               evaluate=problem.evaluate,
               evaluate_batch=problem.evaluate_population if batched else None,
               pop_size=pop_size, initial_pop_size=initial_pop_size,
               n_generations=n_generations, seed=seed, log=log)
    pareto = ga.run(resume=resume_state, on_generation=on_generation)
    if log:
        log(f"search done: evals={len(ga.history)} "
            f"cache_hits={ga.n_cache_hits} memo_hits={problem.memo_hits} "
            f"error_evals={problem.n_error_evals}")
    return MOHAQResult(problem, pareto, len(ga.history),
                       n_cache_hits=ga.n_cache_hits,
                       n_memo_hits=problem.memo_hits)
