"""NSGA-II (Deb et al. 2002) on integer genomes — pure numpy.

pymoo is unavailable offline; this implements the same algorithm the paper
uses via pymoo: fast non-dominated sort, crowding distance, binary-tournament
mating (rank, then crowding), elitist (mu+lambda) survival. Genome variables
are small integers (encoded precisions 1..4). Constraint handling follows
Deb's feasibility rule: feasible dominates infeasible; infeasible compared by
total violation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Individual:
    genome: np.ndarray                   # int vector
    objectives: Optional[np.ndarray] = None   # all minimized
    violation: float = 0.0               # 0 == feasible
    rank: int = 0
    crowding: float = 0.0

    def key(self) -> Tuple[int, ...]:
        return tuple(int(g) for g in self.genome)


def dominates(a: Individual, b: Individual) -> bool:
    if a.violation == 0.0 and b.violation > 0.0:
        return True
    if a.violation > 0.0 and b.violation == 0.0:
        return False
    if a.violation > 0.0 and b.violation > 0.0:
        return a.violation < b.violation
    ao, bo = a.objectives, b.objectives
    return bool(np.all(ao <= bo) and np.any(ao < bo))


def _dominance_matrix(pop: List[Individual]) -> np.ndarray:
    """Boolean (N, N) matrix D with D[i, j] == dominates(pop[i], pop[j]),
    built from whole-population broadcasts (Deb's feasibility rule folded
    in) instead of N^2 Python ``dominates`` calls."""
    O = np.stack([np.asarray(p.objectives, float) for p in pop])
    V = np.asarray([p.violation for p in pop], float)
    with np.errstate(invalid="ignore"):       # inf-inf comparisons are fine
        le = (O[:, None, :] <= O[None, :, :]).all(-1)
        lt = (O[:, None, :] < O[None, :, :]).any(-1)
    feas = V == 0.0
    both_f = feas[:, None] & feas[None, :]
    D = np.where(both_f, le & lt,
                 np.where(feas[:, None] & ~feas[None, :], True,
                          np.where(~feas[:, None] & ~feas[None, :],
                                   V[:, None] < V[None, :], False)))
    np.fill_diagonal(D, False)
    return D


def fast_non_dominated_sort(pop: List[Individual]) -> List[List[Individual]]:
    """Vectorized fast non-dominated sort: one numpy dominance matrix and
    iterative front peeling instead of the O(N^2) Python double loop
    (``_fast_non_dominated_sort_loop``, kept as the parity reference).
    Front membership, rank assignment AND the within-front order reproduce
    the loop implementation exactly — front k+1 is emitted in the order
    candidates hit zero remaining dominators there (position of their last
    dominator inside front k, ties by index), which matters for crowding
    tie-breaks downstream."""
    if not pop:
        return []
    D = _dominance_matrix(pop)
    n = D.sum(axis=0).astype(np.int64)        # dominator counts
    fronts_idx: List[np.ndarray] = []
    current = np.flatnonzero(n == 0)
    rank = 0
    while current.size:
        for i in current:
            pop[i].rank = rank
        fronts_idx.append(current)
        sub = D[current]                      # (front, N)
        n = n - sub.sum(axis=0)
        n[current] = -1                       # processed: never ready again
        ready = np.flatnonzero(n == 0)
        if ready.size:
            # loop-order reconstruction: a candidate was appended when its
            # LAST dominator within the current front was processed
            pos = np.where(sub[:, ready],
                           np.arange(len(current))[:, None], -1).max(axis=0)
            ready = ready[np.lexsort((ready, pos))]
        current = ready
        rank += 1
    return [[pop[i] for i in f] for f in fronts_idx]


def _fast_non_dominated_sort_loop(
        pop: List[Individual]) -> List[List[Individual]]:
    """Reference O(N^2) Python implementation (Deb et al. 2002 as written);
    the vectorized ``fast_non_dominated_sort`` must match it exactly —
    see tests/test_nsga2.py::TestVectorizedParity."""
    S = [[] for _ in pop]
    n = [0] * len(pop)
    fronts: List[List[int]] = [[]]
    for i, p in enumerate(pop):
        for j, q in enumerate(pop):
            if i == j:
                continue
            if dominates(p, q):
                S[i].append(j)
            elif dominates(q, p):
                n[i] += 1
        if n[i] == 0:
            p.rank = 0
            fronts[0].append(i)
    k = 0
    while fronts[k]:
        nxt = []
        for i in fronts[k]:
            for j in S[i]:
                n[j] -= 1
                if n[j] == 0:
                    pop[j].rank = k + 1
                    nxt.append(j)
        fronts.append(nxt)
        k += 1
    return [[pop[i] for i in f] for f in fronts if f]


def assign_crowding(front: List[Individual]) -> None:
    """Vectorized crowding assignment. Semantics replicate the in-place
    loop version (``_assign_crowding_loop``) exactly, including its
    sequential stable re-sorts: objective m is argsorted over the order the
    previous objective left behind, so tie-breaks (and which tied extreme
    gets the inf) are identical, and the front list is left re-ordered by
    the LAST objective as before (survival selection observes that order)."""
    if not front:
        return
    O = np.stack([np.asarray(ind.objectives, float) for ind in front])
    K, M = O.shape
    crowd = np.zeros(K)
    order = np.arange(K)
    for m in range(M):
        order = order[np.argsort(O[order, m], kind="stable")]
        om = O[order, m]
        crowd[order[0]] = crowd[order[-1]] = np.inf
        lo, hi = om[0], om[-1]
        if np.isfinite(lo) and np.isfinite(hi) and hi - lo > 0:
            crowd[order[1:-1]] += (om[2:] - om[:-2]) / (hi - lo)
    for i, ind in enumerate(front):
        ind.crowding = crowd[i]
    front[:] = [front[i] for i in order]


def _assign_crowding_loop(front: List[Individual]) -> None:
    """Reference implementation (kept for the vectorization parity tests)."""
    if not front:
        return
    n_obj = len(front[0].objectives)
    for ind in front:
        ind.crowding = 0.0
    for m in range(n_obj):
        front.sort(key=lambda s: s.objectives[m])
        front[0].crowding = front[-1].crowding = np.inf
        lo, hi = front[0].objectives[m], front[-1].objectives[m]
        if not (np.isfinite(lo) and np.isfinite(hi)) or hi - lo <= 0:
            continue
        span = hi - lo
        for i in range(1, len(front) - 1):
            front[i].crowding += (front[i + 1].objectives[m]
                                  - front[i - 1].objectives[m]) / span


def _tournament(rng, pop: List[Individual]) -> Individual:
    a, b = rng.choice(len(pop), 2, replace=False)
    pa, pb = pop[a], pop[b]
    if pa.rank != pb.rank:
        return pa if pa.rank < pb.rank else pb
    if pa.crowding != pb.crowding:
        return pa if pa.crowding > pb.crowding else pb
    return pa if rng.random() < 0.5 else pb


@dataclass
class NSGA2:
    """evaluate(genome) -> (objectives_to_minimize, constraint_violation).

    ``evaluate_batch`` (optional) takes a list of genomes and returns the
    matching list of (objectives, violation) pairs; when provided, each
    generation's offspring (and the whole initial population) is scored in
    one call — the hook for vectorized/vmapped candidate evaluation. Results
    must match ``evaluate`` exactly: the GA's RNG stream never depends on
    evaluation, so scalar and batched runs visit identical genomes and the
    Pareto front is reproduced bit-for-bit.

    Determinism: all stochastic sites thread through ONE master
    ``SeedSequence(seed)`` — the initial population and each generation's
    variation draw from their own spawned child streams. A generation's
    genomes therefore depend only on (seed, generation, surviving
    population), never on how many draws other code consumed: an evaluator
    that reorders its internal work (dedup hits, sharded gathers, grouped
    beacon calls) cannot shift the variation stream, so two same-seed runs
    always visit identical genomes.
    """
    n_var: int
    var_lo: int
    var_hi: int
    evaluate: Callable[[np.ndarray], Tuple[Sequence[float], float]]
    evaluate_batch: Optional[
        Callable[[List[np.ndarray]], List[Tuple[Sequence[float], float]]]] = None
    pop_size: int = 10
    initial_pop_size: int = 40
    n_generations: int = 60
    p_crossover: float = 0.9
    p_mutation: Optional[float] = None    # default 1/n_var
    seed: int = 0
    log: Optional[Callable[[str], None]] = None
    history: List[Individual] = field(default_factory=list)
    # cross-generation memoization stats: a genome is scored at most once
    # per search; every repeat (NSGA-II elitism makes later generations
    # 30-60% repeats) is a cache hit and skips the costly evaluator
    n_cache_hits: int = 0

    def _eval_many(self, genomes: List[np.ndarray],
                   cache: dict) -> List[Individual]:
        """Evaluate a batch of genomes, deduplicating against the
        cross-generation cache and within the batch; fresh genomes go
        through ``evaluate_batch`` in one call when available (scalar
        fallback otherwise). Cache/history semantics are identical to
        looping ``_eval``."""
        fresh: List[np.ndarray] = []
        seen = set()
        for g in genomes:
            key = tuple(int(x) for x in g)
            if key in cache or key in seen:
                self.n_cache_hits += 1
                continue
            seen.add(key)
            fresh.append(g)
        if fresh:
            if self.evaluate_batch is not None:
                results = self.evaluate_batch(fresh)
            else:
                results = [self.evaluate(g) for g in fresh]
            for g, (objs, viol) in zip(fresh, results):
                ind = Individual(g.copy(), np.asarray(objs, float),
                                 float(viol))
                cache[tuple(int(x) for x in g)] = ind
                self.history.append(ind)
        out = []
        for g in genomes:
            c = cache[tuple(int(x) for x in g)]
            out.append(Individual(g.copy(), c.objectives.copy(), c.violation))
        return out

    def _offspring(self, rng, pop: List[Individual]) -> List[np.ndarray]:
        p_mut = self.p_mutation or (1.0 / self.n_var)
        out = []
        while len(out) < self.pop_size:
            pa, pb = _tournament(rng, pop), _tournament(rng, pop)
            c1, c2 = pa.genome.copy(), pb.genome.copy()
            if rng.random() < self.p_crossover:               # two-point
                i, j = sorted(rng.choice(self.n_var, 2, replace=False))
                c1[i:j + 1], c2[i:j + 1] = pb.genome[i:j + 1].copy(), \
                    pa.genome[i:j + 1].copy()
            for c in (c1, c2):
                mask = rng.random(self.n_var) < p_mut
                c[mask] = rng.integers(self.var_lo, self.var_hi + 1,
                                       mask.sum())
                out.append(c)
        return out[:self.pop_size]

    def run(self, *, resume: Optional[dict] = None,
            on_generation: Optional[Callable[[dict], None]] = None
            ) -> List[Individual]:
        """``on_generation`` (optional) is called after the initial
        population and after every completed generation with a state dict
        {next_gen, population, history, n_cache_hits} — the checkpoint
        hook. ``resume`` (a dict of the same shape) restarts the loop at
        ``next_gen``; because generation ``gen`` always draws from spawned
        key ``1 + gen`` (a pure function of the master seed and the spawn
        index — never of how many draws earlier code consumed), a resumed
        run replays the exact variation stream and the final Pareto front
        is bit-identical to the uninterrupted run."""
        # one master key, one spawned child stream per stochastic site:
        # keys[0] seeds the initial population, keys[1 + gen] seeds
        # generation ``gen``'s variation (tournament/crossover/mutation)
        keys = np.random.SeedSequence(self.seed).spawn(self.n_generations + 1)
        cache: dict = {}

        def notify(next_gen: int, pop: List[Individual]) -> None:
            if on_generation is not None:
                on_generation({"next_gen": next_gen, "population": pop,
                               "history": self.history,
                               "n_cache_hits": self.n_cache_hits})

        if resume is not None:
            start_gen = int(resume["next_gen"])
            if start_gen > self.n_generations:
                raise ValueError(
                    f"resume state has {start_gen} generations done but "
                    f"this run asks for {self.n_generations}")
            # fresh copies: the live population mutates rank/crowding and
            # must never alias the caller's (checkpointed) individuals
            self.history = [
                Individual(i.genome.copy(),
                           np.asarray(i.objectives, float).copy(),
                           float(i.violation)) for i in resume["history"]]
            for ind in self.history:
                cache[ind.key()] = ind
            self.n_cache_hits = int(resume["n_cache_hits"])
            pop = [Individual(i.genome.copy(),
                              np.asarray(i.objectives, float).copy(),
                              float(i.violation), int(i.rank),
                              float(i.crowding))
                   for i in resume["population"]]
        else:
            start_gen = 0
            rng = np.random.default_rng(keys[0])
            pop = self._eval_many(
                [rng.integers(self.var_lo, self.var_hi + 1, self.n_var)
                 for _ in range(self.initial_pop_size)], cache)
            notify(0, pop)
        for gen in range(start_gen, self.n_generations):
            for front in fast_non_dominated_sort(pop):
                assign_crowding(front)
            children = self._eval_many(
                self._offspring(np.random.default_rng(keys[1 + gen]), pop),
                cache)
            merged = pop + children
            survivors: List[Individual] = []
            for front in fast_non_dominated_sort(merged):
                assign_crowding(front)
                if len(survivors) + len(front) <= self.pop_size:
                    survivors.extend(front)
                else:
                    front.sort(key=lambda s: -s.crowding)
                    survivors.extend(front[:self.pop_size - len(survivors)])
                    break
            pop = survivors
            notify(gen + 1, pop)
            if self.log:
                best = min(p.objectives[0] for p in pop if p.violation == 0) \
                    if any(p.violation == 0 for p in pop) else float("nan")
                self.log(f"gen {gen + 1}/{self.n_generations} "
                         f"evals={len(self.history)} "
                         f"cache_hits={self.n_cache_hits} "
                         f"best_obj0={best:.3f}")
        feasible = [p for p in pop if p.violation == 0.0]
        fronts = fast_non_dominated_sort(feasible or pop)
        return _dedup(fronts[0])


def _dedup(front: List[Individual]) -> List[Individual]:
    seen, out = set(), []
    for ind in front:
        if ind.key() not in seen:
            seen.add(ind.key())
            out.append(ind)
    return out


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated rows of a (minimization) objective
    matrix — one broadcasted dominance matrix instead of the O(N^2) Python
    scan (``_pareto_front_loop``, kept as the parity reference)."""
    pts = np.asarray(points, float)
    if pts.size == 0:
        return np.asarray([], int)
    le = (pts[:, None, :] <= pts[None, :, :]).all(-1)
    lt = (pts[:, None, :] < pts[None, :, :]).any(-1)
    return np.flatnonzero(~(le & lt).any(axis=0))


def _pareto_front_loop(points: np.ndarray) -> np.ndarray:
    """Reference implementation (kept for the vectorization parity tests)."""
    keep = []
    for i, p in enumerate(points):
        if not any(np.all(q <= p) and np.any(q < p) for q in points):
            keep.append(i)
    return np.asarray(keep, int)
