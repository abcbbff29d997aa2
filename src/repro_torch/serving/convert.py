"""Writing a packed deployment artifact: a calibrated model and its chosen
allocations -> the directory ``serving.artifact`` reads.

Port of ``pack_deployment`` from the reference's
``tools/convert_checkpoint.py``, in the same format (the reference's
``load_deployment`` reads what this writes, and the other way round).
Packing a stored search front (the reference's ``front_from_store``) waits
for checkpointing, ROADMAP.md queue 1, item 7.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import durable_io
from repro_torch.core import quantization as Q
from repro_torch.serving.artifact import (ARTIFACT_VERSION, MANIFEST_NAME,
                                          PAYLOAD_NAME)


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
