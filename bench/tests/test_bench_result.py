"""The last line's shape: the keys a check reads, the cell's metrics
with their units, the checks last; no result without a CUDA device."""
import json
import subprocess
import sys

import pytest

import discovery

BENCH = discovery.BENCH


@pytest.mark.parametrize("trace", (False, True))
def test_result_shape(trace, small_run):
    bench = discovery.benchmark()
    res = small_run("sru_timit.search", 123456789012, trace=trace)
    res.pop("_readings")
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in bench[kind]}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name]
        assert isinstance(m["value"], float)
    if not trace:
        assert {"setup_s", "search_gen_s", "peak_gib"} <= set(res["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        # the CPU's trace has no device operations: no breakdown, and no
        # reading of the device's metrics
        assert "breakdown" not in res and "idle_share" not in res["metrics"]
        assert {"host_ms", "eval_ms", "eval_ms_p95"} <= set(res["metrics"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_no_result_without_a_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "sru_timit.search", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=discovery.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_no_result_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and bench/ gives no result."""
    import shutil
    shutil.copy(discovery.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "sru_timit.search", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, env={"PATH": "/usr/bin:/bin",
                                          "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_json_follows_the_contract():
    bench = discovery.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "search_gen_s", "peak_gib"} <= e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert discovery.NAME.match(m["name"])
    for c in bench["configs"]:
        spec = discovery.config_spec(c["name"])
        assert set(c["reduced"]) <= set(spec["reduced"]) | set(spec)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_setup_s_leaves_out_the_references_work():
    """The fold's labels are the reference's: a step named ``reference...``
    is timed and logged but left out of ``setup_s``."""
    import time

    import harness
    steps = harness.Steps(lambda: None)
    with steps("data"):
        with steps("reference_labels"):
            time.sleep(0.05)
    assert steps.reference_s() >= 0.05
    assert steps.seconds["data"] < 0.05


def test_small_run_logs_the_reference_apart(small_run):
    lines = []
    small_run("sru_timit.search", 5, log=lines.append)
    assert any(ln.startswith("setup reference_labels ") for ln in lines)
    total = [ln for ln in lines if ln.startswith("setup total ")]
    assert len(total) == 1 and "left out" in total[0]
