"""The kernel verifier from the command line.

    python -m repro_torch.analysis [--device cuda|cpu] [--json]
    python -m repro_torch.analysis --checked
    python -m repro_torch.analysis --sanitize [--tools memcheck ...]

The first form runs ``kernel_rules.run_kernel_checks`` (K0-K4 on the card,
the default, which raises where there is none; ``--device cpu``: the
static rules) and prints one JSON line a rule with its
counts, on a card one line an instantiation (its driven result and
resources), then each finding as ``path:line RULE message``; it exits 1 on
any finding. ``--checked`` (a card) is K2's bounds half
(``kernel_rules.check_bounds``): the drivers, the ragged cases and the
large shapes that fit through the checked build
of the kernels and the default one, after the static accessor rule; it
prints one line a case (violations, equal, seconds), then the findings,
and exits 1 on any. ``--sanitize`` (a card) builds the kernels once and then
re-runs the K0 drivers, one launch an instantiation at their small
shapes, in one child process a tool under ``compute-sanitizer`` (found
beside ``nvcc``; it raises where there is none), its instrumentation
limited to the port's kernels; it prints each tool's error count, exit
code and seconds and exits 1 on any error, and fails naming the tools
where the sanitizer refuses the device. Beside the refusal it prints what
may explain it (``sanitizer_context``: the driver, the ``nvidia-smi -q``
virtualization, MIG and confidential-compute fields, ``nvcc`` and the
sanitizer versions) and tries memcheck with every other
``compute-sanitizer`` the machine's toolkits hold; one that runs takes all
four tools. ``--drivers-only`` is what each child runs.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.analysis import kernel_rules as kr
from repro_torch.device import resolve_device
from repro_torch.kernels import build

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# instrument only the port's kernels (their mangled names), not PyTorch's
KERNEL_FILTER = ("regex=(bank_mxv_pop|bank_qmm_pop|quant_matmul|"
                 "sru_scan_pop)_kernel")


def sanitizer_path() -> str:
    """``compute-sanitizer`` beside ``nvcc`` (``bin/``, or the toolkit's
    ``compute-sanitizer/`` folder)."""
    nvcc = Path(build.nvcc_path())
    for cand in (nvcc.parent / "compute-sanitizer",
                 nvcc.parent.parent / "compute-sanitizer" /
                 "compute-sanitizer"):
        if cand.exists():
            return str(cand)
    raise RuntimeError(f"no compute-sanitizer beside {nvcc}: this "
                       "toolkit cannot run the sanitizer pass")


def other_sanitizers(first: str) -> list:
    """Every other ``compute-sanitizer`` of the machine's toolkits
    (``/usr/local/cuda*`` and the ``nvidia`` Python packages), by real
    path."""
    import site
    roots = ["/usr/local/cuda*/bin", "/usr/local/cuda*/compute-sanitizer",
             "/opt/nvidia/*/bin"]
    roots += [f"{d}/nvidia/*/bin" for d in site.getsitepackages()]
    seen, out = {os.path.realpath(first)}, []
    for root in roots:
        for cand in sorted(glob.glob(f"{root}/compute-sanitizer")):
            real = os.path.realpath(cand)
            if real not in seen and os.access(real, os.X_OK):
                seen.add(real)
                out.append(cand)
    return out


def _run(cmd, timeout=60.0) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e!r}"
    return (proc.stdout + proc.stderr).strip()


SMI_FIELDS = re.compile(r"virtuali[sz]ation|MIG|confidential|conf(\.|\s)?"
                        r"compute|\bCC\b|driver version|cuda version",
                        re.I)


def sanitizer_context(sanitizers=()) -> dict:
    """What may explain a refusal: the driver version, the ``nvidia-smi
    -q`` lines of virtualization, MIG and confidential compute (each with
    the two lines after it, where a section's values are), ``nvidia-smi
    conf-compute -f``, the ``/dev/nvidia*`` nodes (a sanitizer attaches
    through the driver's tools interface), ``nvcc --version`` and each
    sanitizer's ``--version``."""
    smi = _run(["nvidia-smi", "-q"]).splitlines()
    fields = []
    for i, line in enumerate(smi):
        if SMI_FIELDS.search(line):
            fields += [ln.strip() for ln in smi[i:i + 3]
                       if ln.strip() not in fields]
    return {
        "driver": _run(["nvidia-smi", "--query-gpu=name,driver_version,"
                        "power.limit", "--format=csv,noheader"]),
        "nvidia_smi_q": fields,
        "conf_compute": _run(["nvidia-smi", "conf-compute", "-f"]),
        "device_nodes": sorted(glob.glob("/dev/nvidia*")),
        "nvcc": _run([build.nvcc_path(), "--version"]).splitlines()[-2:],
        "sanitizers": {s: _run([s, "--version"]).splitlines()[-2:]
                       for s in sanitizers}}


def sanitize(tools=TOOLS, timeout: float = 900.0, cs=None) -> list:
    """One child a tool: ``compute-sanitizer --tool T`` (``cs``, else the
    one beside ``nvcc``) over ``--drivers-only``. Returns a row a tool: its
    error count (the tool's ERROR SUMMARY), the child's exit code, the
    drivers' findings and the seconds."""
    cs = cs or sanitizer_path()
    build.build()
    env = dict(os.environ)
    src = str(Path(kr.__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    rows = []
    for tool in tools:
        cmd = [cs, "--tool", tool, "--kernel-name", KERNEL_FILTER,
               "--error-exitcode", "86", "--print-limit", "20",
               sys.executable, "-m", "repro_torch.analysis",
               "--drivers-only"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=timeout)
        text = proc.stdout + proc.stderr
        errors = re.search(r"ERROR SUMMARY: (\d+) error", text)
        child = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith('{"drivers"')]
        refused = re.search(r"Error: (Device not supported[^\n]*)", text)
        rows.append({
            "sanitizer": cs,
            "tool": tool, "errors": int(errors.group(1)) if errors else None,
            "refused": refused.group(1) if refused else None,
            "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "drivers": child[0] if child else None,
            "report": [ln for ln in text.splitlines()
                       if ln.startswith("=========")][:40]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: every rule; raises where there "
                    "is no card) or cpu (the static rules)")
    ap.add_argument("--json", action="store_true",
                    help="also print the whole report as one JSON line")
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--checked", action="store_true",
                    help="K2's bounds half through the checked build")
    ap.add_argument("--tools", nargs="*", choices=TOOLS, default=list(TOOLS))
    ap.add_argument("--drivers-only", action="store_true")
    args = ap.parse_args(argv)
    if args.sanitize:
        rows = sanitize(args.tools)
        for row in rows:
            print(json.dumps(row), flush=True)
        refused = [r["tool"] for r in rows if r["refused"]]
        if refused:
            others = other_sanitizers(rows[0]["sanitizer"])
            print(json.dumps({"sanitizer_context": sanitizer_context(
                [rows[0]["sanitizer"], *others])}), flush=True)
            for cs in others:
                tried = sanitize(["memcheck"], cs=cs)
                print(json.dumps(tried[0]), flush=True)
                if not tried[0]["refused"]:
                    rows = tried + sanitize(
                        [t for t in args.tools if t != "memcheck"], cs=cs)
                    for row in rows[1:]:
                        print(json.dumps(row), flush=True)
                    break
            else:
                raise SystemExit(f"compute-sanitizer refused this device "
                                 f"for {refused} ({rows[0]['refused']}), "
                                 f"and {len(others)} other sanitizer(s) "
                                 "too: no sanitizer result")
        return int(any(r["errors"] != 0 or r["rc"] != 0 for r in rows))
    device = resolve_device(args.device)
    if args.checked:
        findings, _ = kr.check_accessors()
        bounds, report = kr.check_bounds(
            device, emit=lambda row: print(json.dumps({"rule": "K2", **row}),
                                           flush=True))
        findings += bounds
        print(json.dumps({"rule": "K2", **{
            k: v for k, v in report.items() if k != "rows"}}), flush=True)
        for f in findings:
            print(f.format(), flush=True)
        return int(bool(findings))
    if args.drivers_only:
        findings, rows = kr.run_drivers(device)
        torch.cuda.synchronize()
        print(json.dumps({"drivers": len(rows), "findings": [
            f.format() for f in findings]}), flush=True)
        return int(bool(findings))
    findings, report = kr.run_kernel_checks(device)
    for rule in kr.RULES:
        print(json.dumps({"rule": rule, **{
            k: v for k, v in report[rule].items()
            if not isinstance(v, (list, dict))}}), flush=True)
    for row in report["K3"].get("instantiations", []):
        print(json.dumps({"rule": "K3", **row}), flush=True)
    if args.json:
        print(json.dumps(report, default=str), flush=True)
    for f in findings:
        print(f.format(), flush=True)
    return int(bool(findings))


if __name__ == "__main__":
    sys.exit(main())
