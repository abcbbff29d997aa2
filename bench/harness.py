"""One run of one cell: set-up, warm-up, the measured window, the output
check against the plain reference, and the result line.

The window runs whole NSGA-II searches back to back through the port's
``SearchSession.run``: the traffic's search seeds, over and over, each
round in an order drawn from ``--seed``, on the configuration's model and
fold, so that every seed runs the same set of searches. A generation ends when
the search logs it; the window closes at the first generation boundary past
``--seconds`` (the log callback raises ``WindowClosed``), so it holds whole
generations only. The harness records its own spans around the calls into
each layer: the evaluator (``target.val_error_batch``) inside the search
driver. With ``trace`` on, ``torch.profiler`` records the window and the
per-layer readers (``metrics/<name>.py``) read it.

For the output check the harness keeps, from dispatches drawn from the seed,
what the program produced: the allocations the search sent, the errors it
received, each lane's integer error counts (``PopulationEvaluator.
_batch_err``'s return) and the logits of sampled lanes and sequences (from
the population forward). The configuration's module compares them with its
plain reference after the window, once the peak memory has been read.
"""
from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

import discovery

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke")


class WindowClosed(Exception):
    """Raised from the search's log callback at the first generation
    boundary past the window's end."""


class BenchError(RuntimeError):
    """A run that cannot report a result."""


# ------------------------------------------------------------- set-up

class Steps:
    """Seconds of named set-up steps, each ended by a device sync. A step
    timed inside another counts as its own, not as the outer one's. Steps
    whose name starts with ``reference`` are the plain reference's work
    (the fold's labels), which ``setup_s`` leaves out."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.seconds: Dict[str, float] = {}
        self._stack: List[str] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()
            self.sync()
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            if self._stack:
                outer = self._stack[-1]
                self.seconds[outer] = self.seconds.get(outer, 0.0) - dt

    def reference_s(self) -> float:
        return sum(s for name, s in self.seconds.items()
                   if name.startswith("reference"))

    def timed(self, name: str, fn: Callable) -> Callable:
        """``fn`` timed under ``name`` on every call."""
        def wrapper(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return wrapper


# ------------------------------------------------------------- capture

class Capture:
    """What the program produced in the window, for the output check: a
    reservoir of ``keep`` dispatches drawn from the seed, plus the first
    dispatch of an initial population (the largest)."""

    def __init__(self, rng: np.random.Generator, keep: int, lanes: int,
                 rows_per_subset: int, n_subsets: int, subset_rows: int):
        self.rng = rng
        self.keep = keep
        self.lanes = lanes
        self.rows_per_subset = rows_per_subset
        self.n_subsets = n_subsets
        self.subset_rows = subset_rows
        self.active = False
        self.seen = 0
        self.kept: List[dict] = []
        self.largest: Optional[dict] = None
        self.current: Optional[dict] = None
        self.argmax = False

    def begin(self, allocs) -> None:
        """Called before a dispatch: decide whether to keep it."""
        self.current = None
        if not self.active:
            return
        i = self.seen
        self.seen += 1
        rec = {"allocs": [dict(a) for a in allocs]}
        if self.largest is None and len(allocs) > 16:
            self.largest = rec
        elif i < self.keep:
            self.kept.append(rec)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.keep and self.kept:
                self.kept[j % len(self.kept)] = rec
            else:
                return
        n = len(allocs)
        rec["lanes"] = sorted(int(x) for x in self.rng.choice(
            n, size=min(self.lanes, n), replace=False))
        rec["rows"] = [int(s * self.subset_rows + r)
                       for s in range(self.n_subsets)
                       for r in sorted(self.rng.choice(
                           self.subset_rows,
                           size=min(self.rows_per_subset, self.subset_rows),
                           replace=False))]
        self.current = rec

    def on_logits(self, logits) -> None:
        rec = self.current
        if rec is None:
            return
        import torch
        lanes = torch.as_tensor(rec["lanes"], device=logits.device)
        rows = torch.as_tensor(rec["rows"], device=logits.device)
        rec["logits"] = logits.index_select(0, lanes).index_select(
            1, rows).clone()
        if self.argmax:
            rec["argmax"] = logits.argmax(dim=-1)

    def on_counts(self, counts) -> None:
        rec = self.current
        if rec is not None:
            rec["counts"] = counts

    def end(self, errors) -> None:
        rec = self.current
        if rec is not None:
            rec["errors"] = [float(e) for e in errors]
        self.current = None

    def dispatches(self) -> List[dict]:
        out = ([self.largest] if self.largest is not None else []) + self.kept
        for rec in out:
            c = rec.get("counts")
            if c is not None and not isinstance(c, np.ndarray):
                rec["counts"] = c.detach().cpu().numpy()
        return out


# ------------------------------------------------------------- window

class Recorder:
    """Generation boundaries and evaluator spans of the window."""

    def __init__(self, deadline_fn: Callable[[], float]):
        self.deadline_fn = deadline_fn
        self.gens = 0
        self.first_log = True
        self.last_boundary: Optional[float] = None
        self.evals: List[tuple] = []      # (t0, t1, n_allocs)
        self.armed = False

    def log(self, msg: str) -> None:
        if not msg.startswith("gen "):
            return
        now = time.perf_counter()
        if not self.armed:
            return
        # the first log of a search ends its initial population and gen 1
        self.gens += 2 if self.first_log else 1
        self.first_log = False
        self.last_boundary = now
        if now >= self.deadline_fn():
            raise WindowClosed


# ------------------------------------------------------------- trace

def _ev_ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def read_trace(prof) -> dict:
    """Device operations and the harness's host annotations of a
    ``torch.profiler`` run, from its raw events: ``ops`` (name, start_ns,
    end_ns) of every kernel, copy and fill on the device, ``spans`` (name,
    start_ns, end_ns) of the annotations ``nsga2`` and ``evaluator``."""
    import torch
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = e.device_type()
        t0 = _ev_ns(e, "start")
        t1 = t0 + _ev_ns(e, "duration")
        kind = str(getattr(e, "activity_type", lambda: "")()).lower()
        if dev == torch.autograd.DeviceType.CUDA:
            if "annotation" in kind:
                continue
            if e.is_user_annotation():
                continue
            ops.append((name, t0, t1))
        elif name in ("nsga2", "evaluator") and e.is_user_annotation():
            spans.append((name, t0, t1))
    ops.sort(key=lambda o: o[1])
    return {"ops": ops, "spans": spans}


def busy_and_gaps(ops, spans, t0: int, t1: int):
    """Seconds in [t0, t1] with an operation on the device, and the idle
    gaps between operations, each named by the innermost harness span the
    host was in when the gap began (``other`` outside both)."""
    busy = 0
    cur_s = cur_e = None
    gaps = []
    last_end = t0
    for _, s, e in ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1 > last_end:
        gaps.append((last_end, t1))

    def host_at(t):
        inner = None
        for name, s, e in spans:
            if s <= t < e and (inner is None or name == "evaluator"):
                inner = name
        return inner or "other"

    named = [(host_at(s), (e - s) * 1e-9) for s, e in gaps]
    return busy * 1e-9, named


# ------------------------------------------------------------- the run

def device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", control: Optional[str] = None,
             bench: Optional[dict] = None, bench_dir: Path = discovery.BENCH,
             spec_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
             ) -> dict:
    """Run one cell once; returns the result dict (the last line's
    object). ``setup_s`` counts from here, after ``import torch``.
    ``control`` ("tf32", "bf16", "fp8") puts the reference computed in
    that precision in the program's place for the output check (the
    control). The ``*_override`` dicts replace keys of the configuration
    and the traffic (the CPU tests' small sizes)."""
    import torch

    if torch.cuda.is_available() and device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    bench = bench if bench is not None else discovery.benchmark()
    entry = discovery.workload_entry(bench, workload)
    spec = dict(discovery.config_spec(entry["config"], bench_dir))
    spec.update(spec_override or {})
    traffic = dict(discovery.traffic(workload, bench_dir))
    traffic.update(traffic_override or {})
    cfgmod = discovery.config_module(entry["config"], bench_dir)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the capture's draws, the warm-up buckets' allocations, the order of
    # the searches
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31 - 1, size=4)
    steps = Steps(sync)
    t_setup = time.perf_counter()
    with steps("start"):
        if dev.type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=dev)
            from repro_torch.kernels import build
            build.load()                       # the kernels' compile cache
    # the model and the fold are the configuration's (its ``model_seed``):
    # the seed draws the order of the traffic's searches and the check's
    # samples, so every seed runs the same set of searches
    cell = cfgmod.setup(spec, traffic, int(spec["model_seed"]), dev, steps)
    target = cell.target
    from repro_torch.core import api

    session = api.SearchSession(target, traffic["platform"],
                                tuple(traffic["objectives"]),
                                sram_override=cell.sram_override,
                                share_memo=bool(traffic["share_memo"]))
    run_kw = dict(generations=int(traffic["generations"]),
                  pop=int(traffic["pop"]), initial=int(traffic["initial"]))

    # the harness's spans and the capture, around the calls into layers
    chk = traffic["check"]
    capture = Capture(np.random.default_rng(seeds[1]), int(chk["dispatches"]),
                      int(chk["lanes"]), int(chk["rows_per_subset"]),
                      cell.n_subsets, cell.subset_rows)
    capture.argmax = bool(chk.get("argmax", False))
    rec = Recorder(lambda: deadline)
    deadline = float("inf")
    record_fn = [None]
    evaluate = target.val_error_batch
    buckets_seen = set()

    def evaluator(allocs, params=None, **kw):
        capture.begin(allocs)
        ctx = (record_fn[0]("evaluator") if record_fn[0] is not None
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            out = evaluate(allocs, params, **kw)
        t1 = time.perf_counter()
        if rec.armed:
            rec.evals.append((t0, t1, len(allocs)))
        buckets_seen.add(len(allocs))
        capture.end(out)
        return out

    target.val_error_batch = evaluator

    # set-up ends with one whole search on a seed the window does not use
    with steps("warmup_search"):
        session.run(**run_kw, seed=int(traffic["warmup_seed"]), log=rec.log)
    ev = cell.evaluator()
    from repro_torch.core import batched_eval
    with steps("warmup_buckets"):
        # every population bucket the genome cache can leave, not yet run
        allocs = cell.sample_allocs(np.random.default_rng(seeds[2]),
                                    int(traffic["initial"]))
        sizes = {batched_eval.bucket_size(n) for n in buckets_seen}
        for b in (1, 2, 4, 8, 16, 32):
            if b <= batched_eval.bucket_size(int(traffic["initial"])) \
                    and b not in sizes:
                evaluate(allocs[:b])
    sync()
    setup_s = time.perf_counter() - t_setup - steps.reference_s()
    for name, s in steps.seconds.items():
        log(f"setup {name} {s:.4f} s")
    log(f"setup total {setup_s:.4f} s, the reference's "
        f"{steps.reference_s():.4f} s left out")

    batch_err = ev._batch_err

    def counted(*args):
        out = batch_err(*args)
        capture.on_counts(out)
        return out

    ev._batch_err = counted
    fwd_owner, fwd_attr = cell.forward_hook
    forward = getattr(fwd_owner, fwd_attr)

    def forward_pop(*args, **kw):
        out = forward(*args, **kw)
        capture.on_logits(out)
        return out

    setattr(fwd_owner, fwd_attr, forward_pop)
    hooks = (cell.window_hooks(capture) if hasattr(cell, "window_hooks")
             else [])
    unhooked = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in hooks]
    for owner, attr, fn in hooks:
        setattr(owner, attr, fn)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        record_fn[0] = record_function
        prof.__enter__()
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    capture.active = True
    rec.armed = True
    sync()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    n_searches = 0
    order = np.random.default_rng(seeds[3])
    try:
        while True:
            for search_seed in order.permutation(traffic["search_seeds"]):
                rec.first_log = True
                n_searches += 1
                ctx = (record_fn[0]("nsga2") if record_fn[0] is not None
                       else contextlib.nullcontext())
                with ctx:
                    session.run(**run_kw, seed=int(search_seed), log=rec.log)
    except WindowClosed:
        pass
    sync()
    t_end = rec.last_boundary
    rec.armed = False
    capture.active = False
    if prof is not None:
        prof.__exit__(None, None, None)
        record_fn[0] = None
    setattr(fwd_owner, fwd_attr, forward)
    for owner, attr, fn in unhooked:
        setattr(owner, attr, fn)
    ev._batch_err = batch_err
    del target.val_error_batch
    launches = kops.launch_counts()
    window_s = t_end - t_start
    gens = rec.gens
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    mods = forbidden_modules()
    if mods:
        raise BenchError(f"forbidden modules loaded: {mods}")

    e2e = {"setup_s": setup_s, "search_gen_s": window_s / max(gens, 1),
           "peak_gib": peak / 2 ** 30}
    eval_s = [t1 - t0 for t0, t1, _ in rec.evals]
    ctx = {
        "cell": workload, "gens": gens, "window_s": window_s,
        "eval_s": eval_s, "eval_sizes": [n for _, _, n in rec.evals],
        "work": cell.work, "launches": launches, "trace": None,
    }
    breakdown = None
    if prof is not None:
        tr = read_trace(prof)
        del prof
        if tr["ops"]:
            # the traced window: from the first to the last device op or
            # annotation inside the run, on the trace's own clock
            starts = [s for _, s, _ in tr["spans"]] + [o[1] for o in tr["ops"]]
            ends = [e for _, _, e in tr["spans"]] + [o[2] for o in tr["ops"]]
            t0n, t1n = min(starts), max(ends)
            busy_s, gaps = busy_and_gaps(tr["ops"], tr["spans"], t0n, t1n)
            tr.update(t0=t0n, t1=t1n, busy_s=busy_s,
                      traced_s=(t1n - t0n) * 1e-9, gaps=gaps)
            ctx["trace"] = tr
            by_name: Dict[str, float] = {}
            for name, s, e in tr["ops"]:
                by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
            totals: Dict[str, float] = {}
            longest: Dict[str, float] = {}
            for name, g in gaps:
                totals[name] = totals.get(name, 0.0) + g
                longest[name] = max(longest.get(name, 0.0), g)
            idle = ([[f"{n} total", v] for n, v in totals.items()]
                    + [[f"{n} longest", v] for n, v in longest.items()])
            idle.sort(key=lambda kv: -kv[1])
            breakdown = {"device_ops": [[n, v] for n, v in top],
                         "idle_gaps": idle[:10]}

    # ---- the output check, after the peak is read
    dispatches = capture.dispatches()
    program = cell.program_outputs()
    # the program's state goes before the reference runs
    del session, evaluate, evaluator, counted, forward_pop, forward, ev
    del batch_err, target, capture, hooks, unhooked
    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cfgmod.check(cell, program, dispatches, control=control)
    check_s = time.perf_counter() - t_check
    limits = traffic["check"]["limits"]
    compared = {}
    correct = bool(dispatches)
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and np.isfinite(value) and value <= limit
        correct = correct and ok
        compared[name] = {"value": value, "limit": limit}
    detail = {k: v for k, v in numbers.items() if k not in limits}
    log(f"check seconds {check_s:.3f}; dispatches compared "
        f"{len(dispatches)}; other readings {json.dumps(detail)}")
    log(f"window {window_s:.4f} s, {gens} generations, {n_searches} "
        f"searches, {len(rec.evals)} dispatches, launches {launches}")

    # a search that fails raises: the run prints no result
    result = {"correct": correct, "attempted": gens, "failed": 0}
    metrics = {}
    if trace:
        for m in discovery.metrics_for(bench, workload, "per_layer"):
            reader = discovery.metric_reader(m["name"], bench_dir)
            if reader is None:
                continue
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        # the three of this harness, or a reader of the metric's own
        ctx.update(setup_s=setup_s, peak_bytes=peak)
        for m in discovery.metrics_for(bench, workload, "end_to_end"):
            if m["name"] in e2e:
                value = e2e[m["name"]]
            else:
                reader = discovery.metric_reader(m["name"], bench_dir)
                value = reader.read(ctx) if reader is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"] = metrics
    info = device_info(torch, dev)
    info["memory_peak_bytes"] = int(peak)
    if trace:
        tr = ctx["trace"]
        info["busy_s"] = float(tr["busy_s"]) if tr else 0.0
        info["window_s"] = float(tr["traced_s"]) if tr else float(window_s)
    result["device"] = info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["_readings"] = numbers
    result["checks"] = compared
    for name, c in compared.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result
