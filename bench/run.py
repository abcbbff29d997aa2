"""The benchmark of ``repro_torch``: one run of one cell.

    python3 bench/run.py --workload sru_timit.search --seed 7 --seconds 10 --trace 0

Run from the checkout's root. Prints the set-up's steps, the output check's
numbers beside their limits (the last lines of standard error) and, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``. Exits 2, printing no result, without a
CUDA device or with fewer than the cell asks for; 1 when the run fails or
JAX or the JAX package is loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no Flax from any
    library."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "bf16", "fp8"),
                    default=None,
                    help="put the reference in this lower precision in the "
                         "program's place for the output check (the control)")
    ap.add_argument("--fault", default=None,
                    help="plant a fault under the timed path (faults.py)")
    args = ap.parse_args(argv)
    _environment()
    import torch

    import discovery
    import harness

    bench = discovery.benchmark(ROOT)
    entry = discovery.workload_entry(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import contextlib

    import faults
    plant = (faults.planted(args.fault) if args.fault
             else contextlib.nullcontext())
    try:
        with plant:
            result = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), device="cuda",
                                      control=args.control, bench=bench)
    except harness.BenchError as exc:
        print(f"run failed: {exc}", file=sys.stderr)
        return 1
    mods = harness.forbidden_modules()
    if mods:
        print(f"forbidden modules loaded: {mods}", file=sys.stderr)
        return 1
    result.pop("_readings", None)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
