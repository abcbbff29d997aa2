"""The xLSTM beacon search of ``chip_smoke.py``'s ``xlstm_search`` phase at
several retraining budgets on one card.

The target is trained once, as the phase trains it (``train_xlstm``:
xlstm-350m at full width and depth, ``XLSTM_TRAIN``), and the beacon search
(``SEARCH_KW``, ``XLSTM_DISTANCE``, bitfusion, an SRAM that holds any
allocation) then runs once a budget from the same trained weights, each in
a session of its own. Each beacon's retraining stream is seeded, so the
budgets differ in their step count alone. One JSON line a budget: every
beacon's allocation, its val error with the base and with the retrained
weights and its seconds, the front, the search's seconds.

    python tools/torch_retrain_steps.py [--steps 10 20]

Needs a CUDA card; imports nothing of the reference package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--steps", type=int, nargs="+", default=[10, 20])
    args = ap.parse_args(argv)
    cs.configure_torch()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    target = cs.train_xlstm(dev, get_config(cs.XLSTM_ARCH))
    sram = (sum(target.layer_weights.values()) + target.vector_weights) * 2
    for steps in args.steps:
        retrain_s, retrainer = [], target.beacon_retrainer

        def timed_retrainer(n, **kw):
            fn = retrainer(n, **kw)

            def retrain(alloc, base):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(alloc, base)
                torch.cuda.synchronize()
                retrain_s.append(time.perf_counter() - t)
                return out
            return retrain

        sess = api.SearchSession(target, "bitfusion", ("error", "speedup"),
                                 sram_override=sram, share_memo=False)
        target.beacon_retrainer = timed_retrainer
        t0 = time.perf_counter()
        try:
            res = sess.run(beacons=True, retrain_steps=steps,
                           distance_threshold=cs.XLSTM_DISTANCE,
                           **cs.SEARCH_KW)
            torch.cuda.synchronize()
        finally:
            del target.beacon_retrainer
        search_s = time.perf_counter() - t0
        beacons = [{"alloc": {k: list(v) for k, v in b.alloc.items()},
                    "retrain_s": s,
                    "error_base_params": target.val_error(b.alloc),
                    "error_beacon_params": target.val_error(
                        b.alloc, params=b.params)}
                   for b, s in zip(res.beacon_search.beacons, retrain_s)]
        print(json.dumps({"retrain_steps": steps, "search_s": search_s,
                          "n_retrains": res.beacon_search.n_retrains,
                          "beacons": beacons,
                          "front": cs.front_rows(res.table())}), flush=True)
        del res, sess
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
