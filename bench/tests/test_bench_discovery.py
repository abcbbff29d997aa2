"""A configuration, a workload and a per-layer metric added as new files are
taken up by name, with no edit to a file the benchmark has."""
import json
import shutil
from pathlib import Path

import discovery
from conftest import SMALL

BENCH = Path(__file__).resolve().parents[1]


def _copy(tmp_path):
    dst = tmp_path / "bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    return dst


def test_new_config_workload_and_metric_are_found(tmp_path, small_run):
    bench_dir = _copy(tmp_path)
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    # a new configuration: the Bi-SRU at two layers, its own files
    spec = json.loads((bench_dir / "configs" / "sru_timit.json").read_text())
    spec.update(name="sru_two", n_sru_layers=2)
    (bench_dir / "configs" / "sru_two.json").write_text(json.dumps(spec))
    shutil.copy(bench_dir / "configs" / "sru_timit.py",
                bench_dir / "configs" / "sru_two.py")
    # a new traffic mix for it: Bitfusion, three generations
    traffic = json.loads(
        (bench_dir / "workloads" / "sru_timit.search.json").read_text())
    traffic.update(platform="bitfusion", objectives=["error", "speedup"],
                   generations=3)
    (bench_dir / "workloads" / "sru_two.bitfusion.json").write_text(
        json.dumps(traffic))
    # a new per-layer metric: dispatches a generation
    (bench_dir / "metrics" / "dispatches_per_gen.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx['eval_s']) / ctx['gens'] if ctx['gens'] else None\n")
    bench = json.loads((discovery.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sru_two", "source": "test",
                             "file": "bench/configs/sru_two.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sru_two.bitfusion",
                               "config": "sru_two", "traffic": "bitfusion",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dispatches_per_gen", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "evaluator", "moves": "search_gen_s",
                               "workloads": ["sru_two.bitfusion"]})
    # and a new end-to-end metric: generations a second
    (bench_dir / "metrics" / "gens_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx['gens'] / ctx['window_s']\n")
    bench["end_to_end"].append({"name": "gens_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["sru_two.bitfusion"]})
    plain = small_run("sru_two.bitfusion", 5, bench=bench,
                      spec_override=dict(SMALL["sru_timit.search"]),
                      bench_dir=bench_dir)
    assert plain["metrics"]["gens_per_s"]["value"] > 0
    res = small_run("sru_two.bitfusion", 5, trace=True, bench=bench,
                    spec_override=dict(SMALL["sru_timit.search"]),
                    bench_dir=bench_dir)
    assert res["correct"]
    assert res["metrics"]["dispatches_per_gen"]["value"] > 0
    assert "scan_roofline" not in res["metrics"]    # not listed for it
    after = {p.relative_to(bench_dir): p.read_bytes()
             for p in bench_dir.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_metrics_for_a_cell():
    bench = discovery.benchmark()
    sru = {m["name"] for m in discovery.metrics_for(
        bench, "sru_timit.search", "per_layer")}
    x = {m["name"] for m in discovery.metrics_for(
        bench, "xlstm_350m.search", "per_layer")}
    assert "scan_roofline" in sru and "scan_roofline" not in x
    assert {"host_ms", "eval_ms", "mxv_roofline", "gen_mfu"} <= sru & x
    for m in bench["per_layer"]:
        assert discovery.metric_reader(m["name"]) is not None
    for w in bench["workloads"]:
        assert discovery.traffic(w["name"])["kind"] == "search"
        assert discovery.config_module(w["config"]).setup


def test_names_are_checked():
    import pytest
    with pytest.raises(ValueError):
        discovery.check_name("../x")
