"""MOHAQ on a second architecture with the PyTorch port: the registry
xLSTM through the model-agnostic SearchTarget API.

The search stack (NSGA-II, MOHAQProblem, the population evaluator, the
platform registry) is the one the SRU experiments use: per-block
(w_bits, a_bits) search over the xLSTM's mLSTM/sLSTM pairs and LM head, on
two platforms, from platform names. On a CUDA card every quantized MxV of
the population forward runs on ``bank_mxv_pop``.

The counterpart of ``examples/mohaq_search_xlstm.py``, on ``repro_torch``
alone (no JAX).

Run: PYTHONPATH=src python examples/torch_mohaq_search_xlstm.py [--fast]
     [--device cpu]
"""
import argparse
import time

from repro_torch.core import xlstm_target as XT
from repro_torch.core.api import SearchSession, get_platform


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer generations / training steps")
    ap.add_argument("--train-steps", type=int, default=None)
    ap.add_argument("--generations", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    gens = args.generations or (4 if args.fast else 12)
    steps = args.train_steps or (80 if args.fast else 200)

    t0 = time.time()
    print(f"[1/3] training registry xLSTM ({steps} steps, "
          f"{XT.search_config().n_layers} blocks)...")
    target = XT.train_small_xlstm(steps=steps, verbose=True,
                                  device=args.device)
    print(f"  baseline: val {target.baseline_val_error:.1f}% "
          f"test {target.baseline_test_error:.1f}%  ({time.time()-t0:.0f}s)")
    print(f"  searchable layers: {', '.join(target.layer_names)}")

    print(f"\n[2/3] Bitfusion search — (error, speedup), {gens} generations")
    t1 = time.time()
    sess = SearchSession(target, "bitfusion", ("error", "speedup"))
    res = sess.run(generations=gens, pop=8, initial=16, seed=0,
                   log=lambda m: print("   ", m))
    print(f"  {res.n_evals} candidate evals in {time.time()-t1:.1f}s; "
          f"platform = {get_platform('bitfusion').name}")
    print(res.format())

    print("\n[3/3] memory-only search — (error, memory)")
    res2 = SearchSession(target, "mem-only", ("error", "memory")).run(
        generations=gens, pop=8, initial=16, seed=0)
    print(res2.format())
    print(f"\ndone in {time.time()-t0:.0f}s — same engine, second "
          f"architecture, zero SRU code involved")
    return {"bitfusion": res, "mem_only": res2, "target": target}


if __name__ == "__main__":
    main()
