"""Runs of one cell in a row, each its own process as a check runs them,
with their metrics summarised: medians, quartiles (Python's
``statistics.quantiles(values, n=4)``) and each metric's spread, the
distance between the quartiles as a share of the median.

    python3 bench/series.py --workload sru_timit.search --seeds 1 2 3 4 5 6 \\
        --seconds 10 --trace 0 [--out build/bench_runs]

Each run's standard output and error go to ``<out>/<workload>.<seed>.<trace>
.{out,err}``; one summary line a run, then one for the series, go to
standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--out", default=str(ROOT / "build" / "bench_runs"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for seed in args.seeds:
        cmd = [sys.executable, str(BENCH / "run.py"), "--workload",
               args.workload, "--seed", str(seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace)]
        if args.control:
            cmd += ["--control", args.control]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        stem = f"{args.workload}.{seed}.{args.trace}"
        (out / f"{stem}.out").write_text(p.stdout)
        (out / f"{stem}.err").write_text(p.stderr)
        line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        try:
            res = json.loads(line)
        except json.JSONDecodeError:
            res = None
        setup = [ln for ln in p.stderr.splitlines()
                 if ln.startswith(("setup ", "window ", "check "))]
        row = {"seed": seed, "rc": p.returncode, "wall_s": round(wall, 2)}
        if res:
            row.update(correct=res["correct"], attempted=res["attempted"],
                       metrics={k: v["value"]
                                for k, v in res["metrics"].items()},
                       device=res["device"],
                       checks={k: v["value"]
                               for k, v in res["checks"].items()})
            if "breakdown" in res:
                row["breakdown"] = res["breakdown"]
        else:
            row["stderr_tail"] = p.stderr[-3000:]
        row["log"] = setup
        runs.append(row)
        print(json.dumps(row), flush=True)
    names = sorted({k for r in runs for k in r.get("metrics", {})})
    summary = {"workload": args.workload, "trace": args.trace,
               "runs": len(runs),
               "correct": sum(bool(r.get("correct")) for r in runs)}
    for k in names:
        vals = [r["metrics"][k] for r in runs if k in r.get("metrics", {})]
        summary[k] = {"median": statistics.median(vals),
                      "spread": spread(vals), "values": vals}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
