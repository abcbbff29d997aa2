"""Where one dry-run cell's seconds go, on this machine's CPU.

Runs ``repro_torch.launch.dryrun.run_cell`` once and prints one JSON line:
the cell's wall and CPU seconds, its counted ops and collectives, and the
seconds DTensor spends in its sharding propagation of new op schemas and
in its redistribute planner (graph-based plans, their Dijkstra searches,
greedy plans), with call counts. ``--layers N`` cuts the model's depth
(the widths stay); ``--no-quick-planner`` leaves DTensor's own planner in
place of ``dryrun.quick_redistribute_planning``; ``--cprofile K`` also
prints the K functions with the most own time.

    PYTHONPATH=src python tools/torch_profile_cell.py --arch stablelm-1.6b \\
        --shape train_4k --mesh multi --layers 2
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import dataclasses
import io
import json
import pstats
import sys
import time


def _timed(stats, key, owner, name) -> None:
    fn = getattr(owner, name, None)
    if fn is None:
        return

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            row = stats[key]
            row[0] += 1
            row[1] += time.perf_counter() - t0
    setattr(owner, name, wrapper)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "pod", "multi"])
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--no-quick-planner", action="store_true")
    ap.add_argument("--cprofile", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    if args.layers:
        get_config = dryrun.get_config
        dryrun.get_config = lambda arch: dataclasses.replace(
            get_config(arch), n_layers=args.layers)
    if args.no_quick_planner and hasattr(dryrun,
                                         "quick_redistribute_planning"):
        dryrun.quick_redistribute_planning = lambda: None
    stats = collections.defaultdict(lambda: [0, 0.0])
    try:
        from torch.distributed.tensor import _redistribute as rd
        from torch.distributed.tensor import _sharding_prop as sp
        planner = rd.DTensorRedistributePlanner
        _timed(stats, "propagation_of_new_schemas", sp.ShardingPropagator,
               "propagate_op_sharding_non_cached")
        _timed(stats, "graph_based_plans", planner,
               "generate_graph_based_transform_infos")
        _timed(stats, "dijkstra_searches", planner, "find_min_cost_path")
        _timed(stats, "greedy_plans", planner,
               "generate_greedy_transform_infos")
    except (ImportError, AttributeError):
        pass
    counts = {}
    count = dryrun.counter.count

    def counting(*a, **kw):
        counts["c"] = out = count(*a, **kw)
        return out
    dryrun.counter.count = counting
    prof = cProfile.Profile() if args.cprofile else None
    t0, c0 = time.time(), time.process_time()
    if prof:
        prof.enable()
    res = dryrun.run_cell(args.arch, args.shape, args.mesh, verbose=False)
    if prof:
        prof.disable()
    c = counts.get("c")
    row = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "layers": args.layers or None, "status": res["status"],
           "wall_s": time.time() - t0, "cpu_s": time.process_time() - c0,
           "analyze_cpu_s": res.get("analyze_cpu_s"),
           "quick_planner": not args.no_quick_planner,
           "n_ops": c.n_ops if c else None,
           "n_collectives": c.n_collectives if c else None,
           "dtensor": {k: {"calls": n, "s": s} for k, (n, s) in
                       stats.items()}}
    print(json.dumps(row), flush=True)
    if prof:
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(
            args.cprofile)
        print(buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
