"""Reading a packed deployment artifact.

Port of the reference package's ``serving/artifact.py``, with no JAX. An
artifact (written by ``serving/convert.py`` or by the reference's
``tools/convert_checkpoint.py``; the format is the same) is a directory:

    packed_banks.bin   checksummed (core/durable_io) npz of the packed banks
                       and the extras the banked forward needs (the FC bias)
    manifest.json      model config, menu, allocations with their (w, a)
                       quantization-grid rows, objective rows, the payload's
                       ``tree_digest`` and byte accounting

``DeploymentArtifact`` loads it once, on the host (numpy), and exposes the
per-allocation rows the router and the batcher index per request;
``serving.batcher.ServingEngine`` moves the banks to the device.
"""
from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import durable_io
from repro_torch.models.sru import SRUModelConfig

ARTIFACT_VERSION = 1
PAYLOAD_NAME = "packed_banks.bin"
MANIFEST_NAME = "manifest.json"

Alloc = Dict[str, Tuple[int, int]]


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    """Inverse of ``durable_io.flatten_tree`` for plain nested dicts."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split(durable_io.SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def load_deployment(out_dir: str):
    """Read back (manifest, banks, extras) as numpy trees; raises
    ``durable_io.CorruptFileError`` on a torn or corrupt payload and
    ``ValueError`` when the payload does not match the manifest digest."""
    with open(os.path.join(out_dir, MANIFEST_NAME), "rb") as f:
        manifest = json.loads(f.read().decode())
    payload = durable_io.read_checksummed(os.path.join(out_dir,
                                                       manifest["payload"]))
    with np.load(io.BytesIO(payload)) as z:
        tree = _nest({k: z[k] for k in z.files})
    digest = durable_io.tree_digest(tree)
    if digest != manifest["tree_digest"]:
        raise ValueError(f"{out_dir}: payload digest {digest} does not "
                         f"match manifest {manifest['tree_digest']}")
    return manifest, tree["banks"], tree["extras"]


def serving_params(manifest: dict, extras: dict) -> dict:
    """Minimal parameter skeleton for the banked forwards: the lanes read
    their weights from the banks, so only the FC bias is carried."""
    params: dict = {}
    for name in manifest["layer_names"]:
        params[name] = ({"fwd": {}, "bwd": {}} if name.startswith("L")
                        else {})
    params["FC"] = {"b": extras["FC"]["b"]}
    return params


def qp_stack(manifest: dict) -> np.ndarray:
    """(P, L, 6) float32 qp grid stack of the packed allocations."""
    L = len(manifest["layer_names"])
    return np.asarray(manifest["qp"], np.float32).reshape(-1, L, 6)


def alloc_cost_bits(alloc: Alloc, counts: Dict[str, int]) -> float:
    """Cost proxy of an allocation: MAC-weighted mean weight bit-width
    (``counts``: per-layer MxV weight counts == MACs per frame)."""
    total = sum(counts[n] for n in alloc)
    return sum(counts[n] * alloc[n][0] for n in alloc) / max(total, 1)


@dataclass
class DeploymentArtifact:
    """One loaded deployment: shared packed banks + per-allocation rows.
    ``objectives[i]`` carries ``cost_bits`` (recomputed on load) and the
    objective values the search stored, if any."""
    path: str
    manifest: dict
    banks: dict
    extras: dict
    cfg: SRUModelConfig = field(init=False)
    allocs: List[Alloc] = field(init=False)
    qp: np.ndarray = field(init=False)            # (P, L, 6) float32
    objectives: List[dict] = field(init=False)

    def __post_init__(self):
        self.cfg = SRUModelConfig(**self.manifest["model"])
        names = list(self.manifest["layer_names"])
        if names != list(self.cfg.layer_names()):
            raise ValueError(
                f"{self.path}: manifest layer names {names} disagree with "
                f"the model config's {list(self.cfg.layer_names())}")
        self.allocs = [{n: (int(a[n][0]), int(a[n][1])) for n in names}
                       for a in self.manifest["allocs"]]
        self.qp = qp_stack(self.manifest)
        counts = self.cfg.layer_weight_counts()
        stored = self.manifest.get("objectives") or [{}] * len(self.allocs)
        self.objectives = [
            {**row, "cost_bits": alloc_cost_bits(a, counts)}
            for a, row in zip(self.allocs, stored)]

    @classmethod
    def load(cls, path: str) -> "DeploymentArtifact":
        manifest, banks, extras = load_deployment(path)
        return cls(path=path, manifest=manifest, banks=banks, extras=extras)

    @property
    def n_allocs(self) -> int:
        return len(self.allocs)

    @property
    def layer_names(self) -> Tuple[str, ...]:
        return tuple(self.manifest["layer_names"])

    @property
    def menu(self) -> Tuple[int, ...]:
        return tuple(self.manifest["menu"])

    def serving_params(self) -> dict:
        return serving_params(self.manifest, self.extras)

    def qp_rows(self, lanes: Sequence[int]) -> np.ndarray:
        """(len(lanes), L, 6) qp stack: lane *i* of the next dispatch gets
        allocation ``lanes[i]``'s grid row."""
        return self.qp[np.asarray(lanes, np.int64)]

    def cost_bits(self, i: int) -> float:
        return self.objectives[i]["cost_bits"]

    def error(self, i: int):
        """Stored search error % of allocation ``i`` (None without
        objective rows)."""
        v = self.objectives[i].get("error")
        return None if v is None else float(v)
