"""MOHAQ for serving on the PyTorch port: a per-layer weight-precision
search for deepseek-67b decode priced by the H100 roofline of a dry-run
cell; the SRU search sharded over a population mesh; and a checkpointed
search's front packed and served.

The counterpart of ``examples/mohaq_tpu_serving.py``, on ``repro_torch``
alone (no JAX). Three modes:

- default: read the dry-run cell of the (16, 16) mesh,
  ``experiments/torch_dryrun/deepseek-67b_decode_32k_pod_kv8.json``
  (``python -m repro_torch.launch.dryrun --arch deepseek-67b --shape
  decode_32k --mesh pod --kv-cache-int8 --tag kv8`` writes it), the
  counterpart of the reference reading its 256-chip cell, and search
  per-group weight bits with NSGA-II, per card. Objectives: a ZeroQ-style
  sensitivity proxy (sum of MACs x the relative MSE of b-bit quantization
  of a normal weight) and the decode step's lower bound, the cell's
  roofline terms with the weight stream rescaled to the candidate's bits,
  at the H100's memory rate (``roofline/report.py::H100_HBM_BYTES_S``).
  Constraint: one card's quantized weights plus its shard of the KV cache
  (the cell's per-device argument bytes less its bf16 weights) fit the
  card's 80 GB (``H100_HBM_CAPACITY_BYTES``). On 256 cards the int8 KV
  cache (about 816 GB whole) is a few GB a card, so front members fit;
  the one-card cell (``--mesh single``) still fits none, and then every
  member's violation is printed.
- ``--sharded-demo``: the SRU search with every generation partitioned
  over a population mesh (``launch/mesh.py``; ``--shards N`` places N
  shards round-robin on the visible cards, the counterpart of the
  reference's XLA host-device flag); the front must equal the unsharded
  run's bit for bit.
- ``--serve-demo``: a checkpointed SRU search, its front taken from the
  store (``serving/convert.py::front_from_store``), packed
  (``pack_deployment``), routed by SLO and served by the continuous
  batcher; every request's logits must be bitwise equal to the scalar
  ``forward(qp=)``.

Run: PYTHONPATH=src python examples/torch_mohaq_serving.py
     [--sharded-demo [--shards N] | --serve-demo] [--device cpu]
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.nsga2 import NSGA2
from repro_torch.device import resolve_device
from repro_torch.roofline.report import (H100_HBM_BYTES_S,
                                         H100_HBM_CAPACITY_BYTES)

# relative MSE of b-bit symmetric quantization of a unit normal (numeric)
QNOISE = {2: 0.119, 4: 0.0104, 8: 5.0e-5, 16: 1e-9}
BITS = [2, 4, 8, 16]
ARTIFACT = "experiments/torch_dryrun/deepseek-67b_decode_32k_pod_kv8.json"
DRYRUN = ("python -m repro_torch.launch.dryrun --arch deepseek-67b "
          "--shape decode_32k --mesh pod --kv-cache-int8 --tag kv8")


def sharded_demo(dev, shards=None, train_steps=40) -> dict:
    """The SRU search on a population mesh against the unsharded search:
    the fronts must be equal bit for bit."""
    from repro_torch.core import sru_experiment as X
    from repro_torch.core.api import SearchSession, get_platform
    from repro_torch.launch.mesh import make_population_mesh

    trained = X.train_small_sru(steps=train_steps, device=dev)
    mesh = make_population_mesh(shards, device=dev.type)
    print(f"population mesh: 1-D 'pop' axis, {mesh.size} shard(s) on "
          f"{mesh.physical_devices} physical device(s)")
    kw = dict(generations=3, pop=8, initial=16, seed=0)
    bitfusion = get_platform("bitfusion")
    runs = {}
    for name, m in (("sharded", mesh), ("single", None)):
        t0 = time.time()
        runs[name] = SearchSession(trained, bitfusion, ("error", "speedup"),
                                   mesh=m, share_memo=False).run(**kw)
        runs[name + "_s"] = time.time() - t0
    res = runs["sharded"]
    assert res.front_key() == runs["single"].front_key(), \
        "sharded front diverged!"
    print(f"sharded search: {runs['sharded_s']:.1f}s over {mesh.size} "
          f"shard(s); single-device: {runs['single_s']:.1f}s; fronts "
          f"BIT-IDENTICAL ({len(res.pareto)} solutions, {res.n_evals} "
          f"unique evals)")
    print(res.format(with_test=False))
    return {"mode": "sharded", "shards": mesh.size,
            "physical_devices": mesh.physical_devices,
            "front_equal": True, "n_evals": res.n_evals}


def serve_demo(dev, train_steps=40) -> dict:
    """Search -> checkpoint -> front from the store -> pack -> serve, with
    every request's logits held bitwise to the scalar ``forward(qp=)``."""
    from repro_torch import serving as S
    from repro_torch.core import sru_experiment as X
    from repro_torch.core.api import SearchSession
    from repro_torch.models import sru
    from repro_torch.serving.convert import front_from_store

    trained = X.train_small_sru(steps=train_steps, device=dev)
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "ckpt")
        SearchSession(trained, "bitfusion", ("error", "speedup"),
                      share_memo=False).run(generations=2, pop=6, initial=8,
                                            seed=0, checkpoint_dir=ckpt)
        allocs, rows = front_from_store(ckpt, trained)
        out = os.path.join(root, "artifact")
        manifest = S.pack_deployment(trained, allocs, out, objectives=rows)
        art = S.DeploymentArtifact.load(out)
    by = manifest["bytes"]
    print(f"packed front: {art.n_allocs} allocations from the checkpointed "
          f"search ({by['packed_weight_banks']/1e3:.0f}kB banks, "
          f"{by['ratio']:.2f}x smaller than f32)")
    router = S.Router(art)
    for c in router.classes:
        dec = router.route(c.name)
        row = art.objectives[dec.alloc]
        print(f"  SLO {c.name:>8s} -> allocation {dec.alloc}: error "
              f"{row['error']:.2f}%, speedup {row.get('speedup', 0.0):.2f}x,"
              f" {row['cost_bits']:.1f} mean weight bits")
    bat = S.ContinuousBatcher(S.ServingEngine(art, device=dev), router,
                              max_lanes=4, chunk=16, collect=True)
    rng = np.random.default_rng(0)
    dim = art.cfg.input_dim
    reqs = [S.Request(rid=i, slo=("premium", "standard", "economy")[i % 3],
                      feats=rng.normal(size=(32, dim)).astype(np.float32))
            for i in range(9)]
    for r in reqs:
        bat.submit(r)
    log = bat.run_until_idle()
    for r in reqs:
        qp = trained.qp_for(art.allocs[log.requests[r.rid].alloc])
        feats = torch.from_numpy(r.feats).to(dev)
        ref = torch.cat([
            sru.forward(trained.params, trained.cfg, feats[s:s + 16][None],
                        qp=qp)[0] for s in range(0, 32, 16)])
        assert np.array_equal(bat.results[r.rid], ref.cpu().numpy()), \
            f"request {r.rid} diverged from the scalar path"
    s = log.summary()
    print(f"served {s['n_completed']} requests across "
          f"{len(router.classes)} SLO classes in {s['n_dispatches']} "
          f"dispatches ({s['tokens_per_s']:.0f} frames/s) — logits bitwise "
          f"== scalar forward(qp=)")
    return {"mode": "serve", "served": s, "n_allocs": art.n_allocs,
            "bitwise": True}


def roofline_search(artifact, reduced=False) -> dict:
    """NSGA-II over deepseek-67b's per-group weight bits, priced by the
    dry-run cell ``artifact`` at the H100's memory rate and capacity."""
    if not os.path.exists(artifact):
        raise SystemExit(f"{artifact} is missing; write it first with: "
                         f"{DRYRUN}")
    with open(artifact) as f:
        d = json.load(f)
    cfg = get_config(d["arch"])
    cfg = cfg.reduced() if reduced else cfg
    r = d["roofline"]
    n_dev = int(d["n_devices"])

    # per-layer-group weight counts (bf16 baseline)
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    groups = {
        "attn_qo": L * (D * H * hd + H * hd * D),
        "attn_kv": L * 2 * D * KV * hd,
        "mlp_gate_up": L * 2 * D * F,
        "mlp_down": L * F * D,
        "embed_head": 2 * cfg.padded_vocab * D,
    }
    names = list(groups)
    total_params = sum(groups.values())
    bf16_bytes_dev = 2 * total_params / n_dev
    base_mem_s = r["memory_s"]
    # the weight stream's share of the baseline memory term
    other_mem_s = max(base_mem_s - bf16_bytes_dev / H100_HBM_BYTES_S, 0.0)
    # what a device holds besides its weights: its shard of the int8 KV
    # cache (the cell's argument bytes are one device's)
    cache_bytes = max(d["memory_analysis"]["argument_bytes"]
                      - bf16_bytes_dev, 0.0)
    coll_comp = max(r["collective_s"], r["compute_s"])
    sizes = np.asarray([groups[n] for n in names], float)
    bits_arr = np.asarray(BITS, float)
    qnoise_arr = np.asarray([QNOISE[b] for b in BITS], float)

    def evaluate_batch(genomes):
        G = np.stack(genomes).astype(int) - 1            # (P, n_var)
        sens = (sizes[None, :] * qnoise_arr[G]).sum(1) / total_params
        wbytes_dev = (sizes[None, :] * bits_arr[G] / 8).sum(1) / n_dev
        mem_s = other_mem_s + wbytes_dev / H100_HBM_BYTES_S
        step_bound = np.maximum(mem_s, coll_comp)
        viol = np.maximum(0.0, (wbytes_dev + cache_bytes
                                - H100_HBM_CAPACITY_BYTES) / 1e9)
        return [([float(s), float(sb)], float(v))
                for s, sb, v in zip(sens, step_bound, viol)]

    def evaluate(genome):
        return evaluate_batch([genome])[0]

    ga = NSGA2(n_var=len(names), var_lo=1, var_hi=4, evaluate=evaluate,
               evaluate_batch=evaluate_batch, pop_size=12,
               initial_pop_size=40, n_generations=40, seed=0)
    front = ga.run()
    print(f"search: {len(ga.history)} evals, {ga.n_cache_hits} cache hits "
          f"(population-axis batched evaluation)")
    print(f"{d['arch']} {d['shape']} on {n_dev} H100 (80 GB, "
          f"{H100_HBM_BYTES_S/1e12:.2f} TB/s): baseline memory "
          f"{base_mem_s*1e3:.0f} ms, compute {r['compute_s']*1e3:.1f} ms; "
          f"KV cache {cache_bytes/1e9:.1f} GB a card")
    print(f"{'bits ' + '/'.join(names):>58s}   sensitivity  step_bound  "
          f"over 80 GB")
    members = []
    for ind in sorted(front, key=lambda s: s.objectives[0]):
        alloc = [BITS[int(g) - 1] for g in ind.genome]
        members.append({"bits": alloc, "sensitivity": ind.objectives[0],
                        "step_bound_s": ind.objectives[1],
                        "violation_gb": float(ind.violation)})
        print(f"{str(alloc):>58s}   {ind.objectives[0]:.5f}      "
              f"{ind.objectives[1]*1e3:7.2f} ms  {ind.violation:8.1f} GB")
    fits = [m for m in members if m["violation_gb"] == 0.0]
    if fits:
        print(f"{len(fits)} of {len(members)} front members fit one card")
    else:
        print(f"no allocation fits one card: the KV cache alone is "
              f"{cache_bytes/1e9:.1f} GB against "
              f"{H100_HBM_CAPACITY_BYTES/1e9:.0f} GB")
    return {"mode": "roofline", "n_devices": n_dev, "front": members,
            "cache_bytes": cache_bytes, "fits": len(fits)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--sharded-demo", action="store_true",
                    help="the SRU search on a population mesh, held to the "
                         "unsharded front")
    ap.add_argument("--serve-demo", action="store_true",
                    help="checkpointed search -> packed front -> SLO-routed "
                         "serving (repro_torch.serving)")
    ap.add_argument("--shards", type=int, default=None,
                    help="population shards (default: one a visible card; "
                         "1 on the CPU)")
    ap.add_argument("--train-steps", type=int, default=40)
    ap.add_argument("--artifact", default=ARTIFACT,
                    help="the dry-run cell the default mode prices")
    ap.add_argument("--reduced", action="store_true",
                    help="the artifact was written with run_cell(reduced="
                         "True): price the reduced config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.serve_demo:
        return serve_demo(dev, args.train_steps)
    if args.sharded_demo:
        return sharded_demo(dev, args.shards, args.train_steps)
    return roofline_search(args.artifact, args.reduced)


if __name__ == "__main__":
    main()
