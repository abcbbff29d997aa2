"""Render markdown tables from the dry run's JSON artifacts
(``launch/dryrun.py``).

A copy of the reference package's ``roofline/tables.py`` (its
``roofline_md`` and ``dryrun_md`` render the same markdown from the same
JSON), reading ``experiments/torch_dryrun`` by default, plus ``h100_md``:
one row a cell with its GFLOPs, GB, the three terms, the bottleneck, the
floor, whether it fits one H100 and the reckoned peak.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional


def load_cells(out_dir: str = "experiments/torch_dryrun", mesh: str = "single",
               tag: str = "") -> List[dict]:
    suffix = f"_{mesh}{('_' + tag) if tag else ''}.json"
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*" + suffix))):
        base = os.path.basename(f)[:-len(suffix)]
        if tag == "" and any(base.endswith(x) for x in ("",)):
            # exclude tagged files when no tag requested
            rest = os.path.basename(f)[len(base):]
            if rest != suffix:
                continue
        cells.append(json.load(open(f)))
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def roofline_md(cells: List[dict]) -> str:
    rows = ["| arch | shape | status | compute | memory | collective | "
            "bottleneck | frac | useful | HBM GiB/dev |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d["status"] == "skip":
            rows.append(f"| {d['arch']} | {d['shape']} | SKIP ({d['reason'][:40]}…) "
                        "| | | | | | | |")
            continue
        if d["status"] != "ok":
            rows.append(f"| {d['arch']} | {d['shape']} | FAIL | | | | | | | |")
            continue
        r = d["roofline"]
        m = d["memory_analysis"]
        hbm = (m["argument_bytes"] + m["temp_bytes"]) / 2 ** 30
        rows.append(
            f"| {d['arch']} | {d['shape']} | ok | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {r['roofline_fraction']:.3f} | "
            f"{r['useful_ratio']:.2f} | {hbm:.1f} |")
    return "\n".join(rows)


def dryrun_md(cells: List[dict]) -> str:
    rows = ["| arch | shape | mesh | fsdp | accum | args/dev | temp/dev | "
            "collectives | compile |",
            "|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d["status"] != "ok":
            continue
        m = d["memory_analysis"]
        r = d["roofline"]
        colls = ", ".join(f"{k.split('-')[0][:3]}+{k.split('-')[-1][:4]}:"
                          f"{v/2**30:.1f}G"
                          for k, v in sorted(
                              r["collective_bytes_by_type"].items()))
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
            f"{'Y' if d.get('fsdp') else 'N'} | {d.get('accum_steps') or '-'} | "
            f"{m['argument_bytes']/2**30:.2f}G | {m['temp_bytes']/2**30:.2f}G | "
            f"{r['n_collectives']} ops, {r['ici_bytes']/2**30:.1f}G/dev | "
            f"{d['compile_s']:.0f}s |")
    return "\n".join(rows)


def h100_md(cells: List[dict]) -> str:
    rows = ["| arch | shape | status | GFLOP | GB | compute | memory | "
            "collective | bottleneck | floor | fits | peak GB | useful |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d["status"] != "ok":
            why = f"SKIP ({d['reason'][:40]}…)" if d["status"] == "skip" \
                else "FAIL"
            rows.append(f"| {d['arch']} | {d['shape']} | {why} "
                        "| | | | | | | | | | |")
            continue
        r = d["roofline"]
        rows.append(
            f"| {d['arch']} | {d['shape']} | ok | {r['flops']/1e9:.1f} | "
            f"{r['hbm_bytes']/1e9:.1f} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {_fmt_s(d['floor_s'])} | "
            f"{'yes' if d['fits'] else 'no'} | "
            f"{d['reckoned_peak_bytes']/1e9:.1f} | {r['useful_ratio']:.2f} |")
    return "\n".join(rows)
