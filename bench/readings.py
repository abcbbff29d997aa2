"""The output check's readings over many seeds in one process: set-up, a
short window at the cell's own load and the check, seed after seed, for the
program or (``--control``) for the reference in a lower precision put in
its place. The limits in ``workloads/<cell>.json`` are set from these
readings (the program's largest and the control's smallest);
``--vary-model`` draws a new model and fold from each seed as well.

    python3 bench/readings.py --workload sru_timit.search --seeds 1 2 3 \\
        --seconds 3 [--control tf32]

One JSON line a seed: every number the check computed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--vary-model", action="store_true",
                    help="draw the model and the fold from each seed too "
                         "(the configuration's model_seed is the cell's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    import run
    run._environment()
    import contextlib

    import faults
    import harness

    for seed in args.seeds:
        t0 = time.perf_counter()
        plant = (faults.planted(args.fault) if args.fault
                 else contextlib.nullcontext())
        with plant:
            res = harness.run_cell(
                args.workload, seed, args.seconds, False,
                control=args.control, log=lambda s: None,
                spec_override={"model_seed": seed} if args.vary_model
                else None)
        print(json.dumps({"seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": res["correct"],
                          "readings": res["_readings"],
                          "seconds": round(time.perf_counter() - t0, 2)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
