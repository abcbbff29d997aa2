"""Time two versions of the port's training checkpoint module in turns, in
one process on one CUDA card (no JAX).

    python tools/torch_checkpoint_io.py --other OTHER/training/checkpoint.py \
        [--gb 4.64] [--dir DIR]

``--other`` is the same module from another checkout (an earlier commit
unpacked with ``git archive``); it is loaded beside this checkout's
``repro_torch.training.checkpoint`` and the two save and restore one
seeded float32 tree on the card in the order other, this, this, other, so
that a drift of the host shows on both. Each restore must equal the tree.
Prints one JSON line: the tree's bytes, each run's version, save and
restore seconds, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.training import checkpoint as this  # noqa: E402

LEAF_ELEMENTS = 58_000_000          # 232 MB a float32 leaf


def load_other(path: str):
    spec = importlib.util.spec_from_file_location("other_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seeded_tree(n_bytes: float, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(22)
    leaf = min(LEAF_ELEMENTS, max(1, int(n_bytes // 4)))
    n_leaves = max(1, round(n_bytes / (4 * leaf)))
    return {"layers": {f"l{i:02d}": {"w": torch.randn(
        leaf, generator=g, device=dev)} for i in range(n_leaves)}}


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="training/checkpoint.py of another checkout")
    ap.add_argument("--gb", type=float, default=4.64,
                    help="the tree's size in 1e9 bytes")
    ap.add_argument("--dir", default=str(REPO / "build" / "checkpoint_io"),
                    help="where the checkpoints are written (removed after)")
    args = ap.parse_args()
    dev = resolve_device("cuda")
    other = load_other(args.other)
    tree = seeded_tree(args.gb * 1e9, dev)
    n_bytes = sum(v["w"].numel() * 4 for v in tree["layers"].values())
    runs = []
    try:
        for name, module in (("other", other), ("this", this),
                             ("this", this), ("other", other)):
            ckpt = Path(args.dir) / f"run{len(runs)}"
            _, save_s = timed(lambda: module.save(str(ckpt), 1, tree,
                                                  keep=1))
            (got, _), restore_s = timed(
                lambda: module.restore(str(ckpt), tree))
            equal = all(torch.equal(got["layers"][k]["w"], v["w"])
                        for k, v in tree["layers"].items())
            del got
            shutil.rmtree(ckpt)
            runs.append({"version": name, "save_s": save_s,
                         "restore_s": restore_s, "equal": equal})
            if not equal:
                raise AssertionError(f"run {len(runs)} restored another tree")
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"bytes": n_bytes, "runs": runs, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
