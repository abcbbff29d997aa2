"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics.
Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own under ``bench/``:

- ``configs/<config>.json``: the configuration's sizes, source, cuts
  (``reduced``) and assumptions (``assumed``); ``configs/<config>.py``:
  its set-up (weights and data from the seed, handed to the port) and its
  plain reference;
- ``workloads/<cell>.json``: the cell's traffic (the search's parameters)
  and the limits of its output check;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` of one per-layer metric.

A new cell, configuration or metric is a new file; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_spec(name: str, bench_dir: Path = BENCH) -> dict:
    return load_json(bench_dir / "configs" / f"{check_name(name)}.json")


def traffic(cell: str, bench_dir: Path = BENCH) -> dict:
    return load_json(bench_dir / "workloads" / f"{check_name(cell)}.json")


def _module(path: Path, prefix: str) -> ModuleType:
    mod_name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_module(name: str, bench_dir: Path = BENCH) -> ModuleType:
    return _module(bench_dir / "configs" / f"{check_name(name)}.py",
                   "bench_config")


def metric_reader(name: str, bench_dir: Path = BENCH) -> Optional[ModuleType]:
    """The reader module of a per-layer metric, or None if it has none."""
    path = bench_dir / "metrics" / f"{check_name(name)}.py"
    if not path.exists():
        return None
    return _module(path, "bench_metric")


def metrics_for(bench: dict, cell: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
    with no ``workloads`` key, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
