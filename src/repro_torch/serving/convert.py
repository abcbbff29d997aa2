"""Writing a packed deployment artifact: a calibrated model and its chosen
allocations -> the directory ``serving.artifact`` reads.

Port of ``pack_deployment``, ``front_from_store`` and the command line of
the reference's ``tools/convert_checkpoint.py``, in the same format (the
reference's ``load_deployment`` reads what this writes, and the other way
round).

Command line (writes one artifact):

    PYTHONPATH=src python -m repro_torch.serving.convert --out DIR \
        [--steps 40] [--bits 2,4,8,16] [--front-from CHECKPOINT_DIR] \
        [--device cuda]

trains the small search model (``core.sru_experiment.train_small_sru``)
and packs one uniform (bits, 8) allocation per value of ``--bits``. With
``--front-from`` the allocations are the Pareto front of the newest
loadable ``SearchStore`` checkpoint under CHECKPOINT_DIR whose target
fingerprint matches the trained model; the model must be trained the same
way (same ``--steps``, same device) for the fingerprint to match, and a
mismatch is an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import checkpointing as ckpt
from repro_torch.core import durable_io
from repro_torch.core import quantization as Q
from repro_torch.core.mohaq import BITS_OF_CODE
from repro_torch.serving.artifact import (ARTIFACT_VERSION, MANIFEST_NAME,
                                          PAYLOAD_NAME, load_deployment)


def _bank_weight_bytes(trained, banks) -> int:
    """Bytes of the per-layer 'W' bank nodes (what the format changes)."""
    total = 0
    for name in trained.cfg.layer_names():
        nodes = ([banks[name][d] for d in ("fwd", "bwd")]
                 if name.startswith("L") else [banks[name]])
        for node in nodes:
            total += Q.packed_bank_nbytes(node["W"])
    return total


def pack_deployment(trained, allocs: Sequence[Dict[str, tuple]],
                    out_dir: str,
                    objectives: Optional[Sequence[dict]] = None) -> dict:
    """Write the packed artifact of ``trained`` (a
    ``core.sru_experiment.TrainedSRU``) under ``out_dir`` and return the
    manifest. ``allocs``: the chosen per-layer (w_bits, a_bits)
    allocations; their quantization-grid rows go into the manifest, so
    serving needs no calibration state. ``objectives`` (optional, one row
    per allocation): search objective values for the router's SLO tiers."""
    if objectives is not None and len(objectives) != len(allocs):
        raise ValueError(f"{len(objectives)} objective rows for "
                         f"{len(allocs)} allocations")
    os.makedirs(out_dir, exist_ok=True)
    banks = trained.make_packed_banks(trained.params)
    extras = {"FC": {"b": trained.params["FC"]["b"]}}
    tree = {"banks": banks, "extras": extras}

    buf = io.BytesIO()
    np.savez(buf, **{k: durable_io.leaf_array(v)
                     for k, v in durable_io.flatten_tree(tree).items()})
    durable_io.write_checksummed(os.path.join(out_dir, PAYLOAD_NAME),
                                 buf.getvalue())

    names = list(trained.cfg.layer_names())
    packed_b = _bank_weight_bytes(trained, banks)
    f32_b = _bank_weight_bytes(trained, trained.make_banks(trained.params))
    manifest = {
        "version": ARTIFACT_VERSION,
        "payload": PAYLOAD_NAME,
        "tree_digest": durable_io.tree_digest(tree),
        "model": dataclasses.asdict(trained.cfg),
        "menu": list(trained.menu),
        "layer_names": names,
        "allocs": [{n: [int(a[n][0]), int(a[n][1])] for n in names}
                   for a in allocs],
        # per alloc, per layer: the 6-float (w_scale, w_lo, w_hi, a_scale,
        # a_lo, a_hi) grid row of forward_population's qp stack
        "qp": [[[float(v) for v in trained.qp_for(a)[n]] for n in names]
               for a in allocs],
        "bytes": {"packed_weight_banks": packed_b,
                  "f32_weight_banks": f32_b,
                  "ratio": f32_b / packed_b},
    }
    if objectives is not None:
        manifest["objectives"] = [
            {k: float(v) for k, v in row.items()} for row in objectives]
    durable_io.atomic_write_bytes(
        os.path.join(out_dir, MANIFEST_NAME),
        json.dumps(manifest, indent=1).encode())
    return manifest


def front_from_store(root: str, trained) -> Tuple[List[dict], List[dict]]:
    """Pull the Pareto front out of a ``SearchStore`` for ``trained``.

    Scans ``root`` for search identities whose target fingerprint matches
    ``trained`` (same layer names, menu and parameter tree — a checkpoint
    of a differently-trained model can never be packed against the wrong
    weights), loads the newest loadable checkpoint among them, decodes the
    stored front genomes into per-layer allocations and maps each front
    individual's objective vector back to named values (the search stores
    ``speedup`` negated for NSGA-II minimization; it comes back positive
    here). Returns (allocs, objective_rows), both sorted by error."""
    fp = ckpt.target_fingerprint(trained)
    store = ckpt.SearchStore(root)
    names = list(trained.layer_names)
    best = None            # (newest gen file mtime, state, settings)
    for key_hash in (sorted(os.listdir(root)) if os.path.isdir(root)
                     else []):
        key_file = os.path.join(root, key_hash, "KEY.json")
        if not os.path.isfile(key_file):
            continue
        with open(key_file, "rb") as f:
            key = json.loads(f.read().decode())
        if key.get("fingerprint") != fp:
            continue
        for sh in sorted(os.listdir(os.path.join(root, key_hash))):
            sfile = os.path.join(root, key_hash, sh, "SETTINGS.json")
            if not os.path.isfile(sfile):
                continue
            with open(sfile, "rb") as f:
                settings = json.loads(f.read().decode())
            state = store.load_latest(
                key, settings,
                params_template=getattr(trained, "params", None))
            if state is None:
                continue
            gens = store.generations(key, settings)
            path = os.path.join(store.dir_for(key, settings),
                                store._FMT.format(gens[-1]))
            mtime = os.path.getmtime(path)
            if best is None or mtime > best[0]:
                best = (mtime, state, settings)
    if best is None:
        raise FileNotFoundError(
            f"no loadable checkpoint under {root!r} matches the trained "
            f"model (fingerprint {fp[:12]})")
    _, state, settings = best
    L = len(names)

    def decode(genome) -> dict:
        g = [int(v) for v in np.asarray(genome).tolist()]
        if len(g) == L:                              # tied: w bits == a bits
            return {n: (BITS_OF_CODE[g[i]], BITS_OF_CODE[g[i]])
                    for i, n in enumerate(names)}
        if len(g) == 2 * L:
            return {n: (BITS_OF_CODE[g[2 * i]], BITS_OF_CODE[g[2 * i + 1]])
                    for i, n in enumerate(names)}
        raise ValueError(f"genome length {len(g)} fits neither tied ({L}) "
                         f"nor untied ({2 * L}) encoding for {L} layers")

    obj_names = list(settings.get("objectives", []))
    front = [state.population[i] for i in state.front_idx]
    seen, picks = set(), []
    for ind in sorted(front, key=lambda i: float(i.objectives[0])):
        alloc = decode(ind.genome)
        akey = tuple(sorted((n, alloc[n]) for n in alloc))
        if akey in seen:
            continue
        seen.add(akey)
        row = {}
        for name, v in zip(obj_names, ind.objectives):
            row[name] = float(-v) if name == "speedup" else float(v)
        picks.append((alloc, row))
    return [a for a, _ in picks], [r for _, r in picks]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--steps", type=int, default=40,
                    help="training steps for the demo model")
    ap.add_argument("--bits", default="2,4,8,16",
                    help="comma list: one uniform (b, 8)-allocation each")
    ap.add_argument("--front-from", default=None, metavar="CHECKPOINT_DIR",
                    help="pack the Pareto front of the newest matching "
                         "SearchStore checkpoint instead of --bits")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.core import sru_experiment as X
    trained = X.train_small_sru(steps=args.steps, device=args.device)
    objectives = None
    if args.front_from is not None:
        allocs, objectives = front_from_store(args.front_from, trained)
        if not allocs:
            raise SystemExit(f"checkpoint under {args.front_from} has an "
                             f"empty front")
    else:
        menu = tuple(trained.menu)
        allocs = []
        for b in (int(s) for s in args.bits.split(",")):
            if b not in menu:
                raise SystemExit(f"--bits {b} not in menu {menu}")
            allocs.append({n: (b, 8) for n in trained.layer_names})
    manifest = pack_deployment(trained, allocs, args.out,
                               objectives=objectives)
    _m, banks, _x = load_deployment(args.out)   # verify the round trip
    del banks
    by = manifest["bytes"]
    src = (f"front of {args.front_from}" if args.front_from is not None
           else f"uniform bits {args.bits}")
    print(f"wrote {args.out}: {len(allocs)} allocation(s) from {src}, "
          f"packed weight banks {by['packed_weight_banks']} B "
          f"({by['ratio']:.2f}x smaller than f32 banks), "
          f"digest {manifest['tree_digest'][:12]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
