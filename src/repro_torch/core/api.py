"""mohaq.api — the model- and platform-agnostic MOHAQ search surface.

The PyTorch port's copy of the reference package's ``core/api.py``. The
search engine (NSGA-II + MOHAQProblem + beacon logic + the population
evaluator) consumes a model only through the ``SearchTarget`` protocol, and
hardware platforms resolve from names via ``core.hardware.get_platform``.
``repro_torch.core.sru_experiment.TrainedSRU`` and
``repro_torch.core.xlstm_target.XLSTMTarget`` implement it.

Differences from the reference:

- no device mesh: the population axis runs on one device, so
  ``mesh``/``partition`` are gone from every signature;
- the deprecated ``sru_experiment`` shims are not carried over.

The SearchTarget contract
-------------------------

A target is a *calibrated* model plus the frozen quantization grids of its
layers:

Search-space description
  ``layer_names``       ordered quantizable layer names (the genome layout)
  ``menu``              supported bit-widths, e.g. ``(2, 4, 8, 16)``

Hardware-objective inputs (paper Eqs. 3-5)
  ``layer_macs``        {name: MACs per inference}
  ``layer_weights``     {name: weight count} of the searchable matrices
  ``vector_weights``    always-16-bit parameter count (vectors, biases, ...)
  ``fixed_ops``         element-wise/nonlinear op count

Error evaluation
  ``baseline_val_error``                      full-precision reference
  ``val_error(alloc=None, params=None)``      scalar max-subset error %
  ``val_error_batch(allocs, params=None)``    population-batched errors,
                                              equal to the scalar path
  ``shared_error_memo``  dict shared by every base-params search built from
                        this target

Quantization-grid plumbing (consumed by the batched evaluator)
  ``qp_for(alloc)``       {layer: 6-float (w_scale, w_lo, w_hi, a_scale,
                          a_lo, a_hi)} dynamic grids
  ``qp_menu_tables()``    (L, |menu|, 3) weight/activation triple tables
  ``make_banks(params)``  precomputed quantized-weight banks per param set

Beacon retraining (optional — ``supports_retrain`` gates it)
  ``params``, ``beacon_retrainer(steps)``, ``retrain(alloc, base_params)``

A full hardware-aware search is::

    session = SearchSession(target, "silago", ("error", "speedup", "energy"))
    result = session.run(generations=15, pop=10)
    print(result.format())
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Tuple,
                    Union, runtime_checkable)

from repro_torch.core import checkpointing as ckpt
from repro_torch.core.beacon import BeaconSearch
from repro_torch.core.hardware import (HardwareModel, get_platform,
                                       list_platforms)
from repro_torch.core.mohaq import Alloc, MOHAQProblem, MOHAQResult, run_search

__all__ = [
    "SearchTarget", "SearchSession", "SearchResult",
    "build_problem_from_target", "result_table", "format_rows",
    "get_platform", "list_platforms",
]


@runtime_checkable
class SearchTarget(Protocol):
    """The full model contract the MOHAQ search engine consumes (see the
    module docstring). Implementations:
    ``repro_torch.core.sru_experiment.TrainedSRU`` and
    ``repro_torch.core.xlstm_target.XLSTMTarget``."""

    # ---- search-space description ----
    @property
    def layer_names(self) -> Sequence[str]: ...
    @property
    def menu(self) -> Tuple[int, ...]: ...

    # ---- hardware-objective inputs ----
    @property
    def layer_macs(self) -> Dict[str, int]: ...
    @property
    def layer_weights(self) -> Dict[str, int]: ...
    @property
    def vector_weights(self) -> int: ...
    @property
    def fixed_ops(self) -> int: ...

    # ---- error evaluation ----
    baseline_val_error: float
    shared_error_memo: Dict[tuple, float]

    def val_error(self, alloc: Optional[Alloc] = None,
                  params: Any = None) -> float: ...

    def val_error_batch(self, allocs: Sequence[Alloc], params: Any = None,
                        **kw) -> List[float]: ...

    # ---- quantization-grid plumbing ----
    def qp_for(self, alloc: Alloc) -> Dict[str, tuple]: ...
    def qp_menu_tables(self): ...
    def make_banks(self, params: Any): ...


def _resolve(platform: Union[str, HardwareModel]) -> HardwareModel:
    return get_platform(platform) if isinstance(platform, str) else platform


def build_problem_from_target(
        target: SearchTarget, platform: Union[str, HardwareModel],
        objectives: Sequence[str], *,
        sram_override: Optional[int] = None, batched: bool = True,
        share_memo: bool = True) -> MOHAQProblem:
    """Construct a ``MOHAQProblem`` from any ``SearchTarget``.
    ``share_memo`` keeps the target's cross-search base-params error memo
    attached (platform sweeps score each allocation once — beacon searches
    re-point it, see ``BeaconSearch.attach``)."""
    hw = _resolve(platform)
    if sram_override is not None:
        hw = dataclasses.replace(hw, sram_bytes=sram_override)

    def error_fn(alloc: Alloc) -> float:
        return target.val_error(alloc)

    def batch_error_fn(allocs):
        return target.val_error_batch(allocs)

    return MOHAQProblem(
        layer_names=list(target.layer_names),
        layer_macs=dict(target.layer_macs),
        layer_weights=dict(target.layer_weights),
        vector_weights=target.vector_weights,
        hardware=hw,
        error_fn=error_fn,
        baseline_error=target.baseline_val_error,
        batch_error_fn=batch_error_fn if batched else None,
        fixed_ops=target.fixed_ops,
        objectives=objectives,
        error_memo=target.shared_error_memo if share_memo else None)


@dataclass
class SearchResult:
    """A finished search: the Pareto front plus everything needed to render
    it for *this* target."""
    target: Any
    problem: MOHAQProblem
    result: MOHAQResult
    beacon_search: Optional[BeaconSearch] = None
    # AsyncSaver.stats for checkpointed runs (foreground/worker-CPU/drain
    # seconds + save count); None when the run was not checkpointed
    checkpoint_stats: Optional[dict] = None

    @property
    def pareto(self):
        return self.result.pareto

    @property
    def n_evals(self) -> int:
        return self.result.n_evals

    def rows(self) -> List[dict]:
        return self.result.rows()

    def table(self, with_test: bool = True) -> List[dict]:
        return result_table(self.result, self.target, with_test=with_test)

    def format(self, with_test: bool = True) -> str:
        return format_rows(self.table(with_test=with_test),
                           layer_names=list(self.target.layer_names))

    def front_key(self):
        """Canonical (genome, objectives) key set — exact front comparisons
        across runs, lowerings and packages (the parity-test idiom)."""
        return sorted((tuple(i.genome.tolist()),
                       tuple(i.objectives.tolist()),
                       float(i.violation)) for i in self.result.pareto)


@dataclass
class SearchSession:
    """Facade over a full MOHAQ search: ``SearchSession(target, platform,
    objectives).run(...)``.

    ``platform`` is a registry name (``get_platform``) or a
    ``HardwareModel``; ``batched=False`` forces the per-candidate path
    (identical fronts). Each ``run`` builds a fresh problem but shares the
    target's cross-search error memo, so multi-platform sweeps over one
    target score each allocation once."""
    target: Any
    platform: Union[str, HardwareModel]
    objectives: Sequence[str] = ("error", "speedup", "energy")
    sram_override: Optional[int] = None
    batched: bool = True
    share_memo: bool = True

    def __post_init__(self):
        self.platform = _resolve(self.platform)

    def build_problem(self) -> MOHAQProblem:
        return build_problem_from_target(
            self.target, self.platform, self.objectives,
            sram_override=self.sram_override, batched=self.batched,
            share_memo=self.share_memo)

    def run(self, generations: int = 15, pop: int = 10, initial: int = 24,
            seed: int = 0, *, beacons: bool = False, retrain_steps: int = 60,
            distance_threshold: float = 6.0, log=None,
            batched: Optional[bool] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1,
            resume: bool = False) -> SearchResult:
        """Run the search (paper Fig. 4). ``beacons=True`` switches to the
        retraining-aware Algorithm-1 search — requires the target to
        support retraining (``supports_retrain`` / ``beacon_retrainer``).

        Crash safety: ``checkpoint_dir`` persists the full search state
        (population, history, error memo, beacons) to a
        ``core.checkpointing.SearchStore`` every ``checkpoint_every``
        generations (atomic, checksummed writes); ``resume=True`` loads the
        newest loadable checkpoint for this (target, platform, menu, seed)
        + settings and continues — the resumed final Pareto front is
        bit-identical to the uninterrupted run (the GA's SeedSequence
        spawn-index discipline, not a re-seed, makes this exact)."""
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        store = state = key = settings = None
        if checkpoint_dir is not None:
            store = ckpt.SearchStore(checkpoint_dir)
            key = ckpt.search_key(self.target, self.platform, seed,
                                  sram_bytes=self.sram_override)
            settings = {
                "generations": int(generations), "pop": int(pop),
                "initial": int(initial),
                "objectives": list(self.objectives),
                "beacons": bool(beacons),
                "retrain_steps": int(retrain_steps) if beacons else 0,
                "distance_threshold":
                    float(distance_threshold) if beacons else 0.0}
            if resume:
                state = store.load_latest(
                    key, settings,
                    params_template=getattr(self.target, "params", None))
                if log and state is not None:
                    log(f"resumed from checkpoint: {state.next_gen} "
                        f"generation(s) done, {len(state.history)} evals, "
                        f"{state.n_retrains} retrains")
        prob = self.build_problem()
        bs = None
        if beacons:
            if not getattr(self.target, "supports_retrain",
                           hasattr(self.target, "beacon_retrainer")):
                raise NotImplementedError(
                    f"target {type(self.target).__name__} does not support "
                    "beacon retraining (supports_retrain is falsy); run "
                    "with beacons=False")
            bs = BeaconSearch.from_target(
                prob, self.target, retrain_steps=retrain_steps,
                batched=self.batched, distance_threshold=distance_threshold,
                skip_retrains=state.n_retrains if state is not None else 0)
            prob = bs.attach()
        resume_state = None
        if state is not None:
            ckpt.restore_into(state, prob, bs)
            resume_state = state.ga_resume()
        on_generation = saver = None
        if store is not None:
            final_prob, final_bs = prob, bs
            # persistence overlaps the next generation's compute: capture
            # copies only the new history suffix (and new beacons, to the
            # host) on this thread, the incremental encode + durable write
            # happen on the saver's worker (FIFO-ordered, drained before
            # run returns)
            saver = ckpt.AsyncSaver(store, key, settings)

            def on_generation(ga_state):
                g = ga_state["next_gen"]
                if g % max(1, checkpoint_every) == 0 or g == generations:
                    saver.save(ga_state, final_prob, final_bs)
        try:
            res = run_search(prob, n_generations=generations, pop_size=pop,
                             initial_pop_size=initial, seed=seed, log=log,
                             batched=batched, on_generation=on_generation,
                             resume_state=resume_state)
        except BaseException:
            if saver is not None:
                saver.abort()   # already unwinding; don't mask this error
            raise
        if saver is not None:
            saver.close()       # final write durable before run() returns
        return SearchResult(self.target, prob, res, bs,
                            checkpoint_stats=(dict(saver.stats)
                                              if saver else None))


# --------------------------------------------------------- result rendering

def result_table(res: MOHAQResult, target: Any = None,
                 with_test: bool = True) -> List[dict]:
    """Pareto rows (error + hardware objectives per solution), with test
    error appended when the target can score it."""
    rows = []
    for row in res.rows():
        if with_test and target is not None and hasattr(target, "test_error"):
            row["test_error"] = target.test_error(row["alloc"])
        rows.append(row)
    return rows


def format_rows(rows: List[dict], layer_names=None) -> str:
    """Human-readable Pareto table. Layer names default to the allocation's
    own ordering, so tables render correctly for any architecture."""
    if not rows:
        return "(empty Pareto front)"
    if layer_names is None:
        layer_names = list(rows[0]["alloc"])
    out = ["sol  " + " ".join(f"{n:>6s}" for n in layer_names)
           + "   err%  Cp_r  speedup  energy(uJ)  test%"]
    for i, r in enumerate(rows):
        bits = " ".join(f"{r['alloc'][n][0]}/{r['alloc'][n][1]:<3d}"
                        for n in layer_names)
        out.append(
            f"S{i+1:<3d} {bits}  {r['error']:5.1f} {r['compression']:5.1f} "
            f"{r['speedup']:7.1f}  {r['energy']*1e6:9.3f}  "
            f"{r.get('test_error', float('nan')):5.1f}")
    return "\n".join(out)
