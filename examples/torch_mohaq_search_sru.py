"""The paper's three experiments end to end (Figs 7-10, Tables 5-8) on the
PyTorch port, through the model-agnostic SearchTarget API.

Trains the SRU speech model on the synthetic TIMIT stand-in, then:
  exp1: NSGA-II minimizing (error, memory)            — paper §5.2
  exp2: SiLago, (error, speedup, energy), SRAM bound  — paper §5.3
  exp3: Bitfusion, (error, speedup), small SRAM;
        inference-only THEN beacon-based search       — paper §5.4

Each experiment is a ``SearchSession`` over the trained target. On a CUDA
card each generation is one population forward through ``bank_mxv_pop``
and ``sru_scan_pop``, and the beacons retrain on the card.

The counterpart of ``examples/mohaq_search_sru.py``, on ``repro_torch``
alone (no JAX).

Run: PYTHONPATH=src python examples/torch_mohaq_search_sru.py [--fast]
     [--device cpu]
"""
import argparse
import time

from repro_torch.core import sru_experiment as X
from repro_torch.core.api import SearchSession, get_platform


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer generations / training steps")
    ap.add_argument("--train-steps", type=int, default=None)
    ap.add_argument("--generations", type=int, default=None)
    ap.add_argument("--scalar", action="store_true",
                    help="force per-candidate evaluation (the batched "
                         "population evaluator is the default and returns "
                         "the same Pareto front up to frames at exact "
                         "logit ties)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist crash-safe search checkpoints here (a "
                         "repro_torch.core.checkpointing.SearchStore; every "
                         "experiment keys its own state)")
    ap.add_argument("--resume", action="store_true",
                    help="resume each search from the newest checkpoint "
                         "in --checkpoint-dir (bit-identical to the "
                         "uninterrupted run)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    gens = args.generations or (6 if args.fast else 20)
    steps = args.train_steps or (150 if args.fast else 500)
    batched = not args.scalar
    ckpt_kw = dict(checkpoint_dir=args.checkpoint_dir, resume=args.resume) \
        if args.checkpoint_dir else {}

    t0 = time.time()
    print(f"[1/4] training SRU speech model ({steps} steps)...")
    trained = X.train_small_sru(steps=steps, verbose=True,
                                device=args.device)
    print(f"  baseline: val {trained.baseline_val_error:.1f}% "
          f"test {trained.baseline_test_error:.1f}%  ({time.time()-t0:.0f}s)")
    print(f"  candidate evaluation: "
          f"{'batched (one population forward per generation)' if batched else 'per-candidate scalar'}")

    run_kw = dict(generations=gens, pop=10, initial=24, seed=0)

    print(f"\n[2/4] experiment 1 — (error, memory), {gens} generations")
    t1 = time.time()
    res1 = SearchSession(trained, "mem-only", ("error", "memory"),
                         batched=batched).run(
        log=lambda m: print("   ", m), **run_kw, **ckpt_kw)
    print(f"  {res1.n_evals} candidate evals in {time.time()-t1:.1f}s "
          f"({(time.time()-t1)/max(res1.n_evals,1)*1e3:.0f} ms/eval)")
    print(res1.format())

    print("\n[3/4] experiment 2 — SiLago (error, speedup, energy)")
    silago = get_platform("silago")
    sram = int(trained.cfg.total_weights() * 32 / 8 / 3.5)
    res2 = SearchSession(trained, silago, ("error", "speedup", "energy"),
                         sram_override=sram, batched=batched).run(
        log=lambda m: print("   ", m), **run_kw, **ckpt_kw)
    print(res2.format())
    best = max(r["speedup"] for r in res2.rows())
    print(f"  max speedup found {best:.1f}x of SiLago max 4.0x "
          f"({100*best/3.947:.0f}% of the all-4-bit bound)")

    print("\n[4/4] experiment 3 — Bitfusion 10.6x-SRAM bound")
    mat = sum(trained.layer_weights.values())
    sram3 = int((mat * 3.5 + trained.vector_weights * 16) / 8)
    sess3 = SearchSession(trained, "bitfusion", ("error", "speedup"),
                          sram_override=sram3, batched=batched)
    res3 = sess3.run(**run_kw, **ckpt_kw)
    print("  inference-only search:")
    print(res3.format())

    res3b = sess3.run(beacons=True, **run_kw, **ckpt_kw)
    bs = res3b.beacon_search
    print(f"  beacon-based search ({bs.n_retrains} beacons retrained):")
    print(res3b.format())

    def best_at(rows, err_budget):
        ok = [r for r in rows
              if r["error"] <= trained.baseline_val_error + err_budget]
        return max((r["speedup"] for r in ok), default=float("nan"))
    for budget in (2.0, 4.0, 8.0):
        a = best_at(res3.rows(), budget)
        b = best_at(res3b.rows(), budget)
        print(f"  max speedup within +{budget:.0f}pp: inference-only {a:.1f}x"
              f" vs beacon {b:.1f}x")
    print(f"\ndone in {time.time()-t0:.0f}s")
    return {"exp1": res1, "exp2": res2, "exp3": res3, "exp3_beacon": res3b,
            "trained": trained}


if __name__ == "__main__":
    main()
