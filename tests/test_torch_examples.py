"""The port's user examples (``examples/torch_*.py``) run in-process on the
CPU at their smallest arguments: a handful of training steps, one
generation. ``torch_quickstart``'s Table 4 counts and S7 objectives equal
the reference's numbers (its training is cut to 5 steps here by wrapping
``train_small_sru``)."""

import importlib.util
from pathlib import Path

import pytest

from repro.configs import get_config as ref_get_config
from repro.core.hardware import SILAGO as REF_SILAGO
from repro.core.mohaq import MOHAQProblem as RefProblem
from repro.models.sru import LAYER_NAMES as REF_LAYER_NAMES

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These runs are many small ops: one intra-op thread keeps them off
    the other test workers' cores (with six workers on eight cores a
    multithreaded small op waits on its own threads)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference_numbers(monkeypatch):
    mod = _load("torch_quickstart")
    train = mod.X.train_small_sru
    monkeypatch.setattr(mod.X, "train_small_sru",
                        lambda steps, **kw: train(steps=5, **kw))
    out = mod.main(["--device", "cpu"])
    paper = ref_get_config("sru_timit")
    assert out["table4"] == paper.layer_weight_counts()
    assert sum(out["table4"].values()) == 5549500
    macs = paper.layer_weight_counts()
    prob = RefProblem(list(REF_LAYER_NAMES), macs, macs,
                      paper.vector_weight_count(), REF_SILAGO,
                      lambda a: 0.0, 16.2, fixed_ops=88000 + 10704)
    want = prob.hardware_objectives({n: (4, 4) for n in REF_LAYER_NAMES})
    assert out["s7"] == want
    assert round(want["speedup"], 1) == 3.9 and \
        round(want["compression"], 1) == 8.0
    assert sorted(out["ptq"]) == [2, 4, 8]


def test_train_sru_speech_restores_exactly(tmp_path):
    out = _load("torch_train_sru_speech").main(
        ["--steps", "5", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["restored_exact"] and out["step"] == 5
    assert {k: round(cr, 1) for k, (_, cr) in out["sweep"].items()} == {
        (8, 16): 4.0, (4, 16): 8.0, (4, 8): 8.0, (2, 16): 16.0,
        (2, 8): 16.0}


def test_mohaq_search_sru_resumes(tmp_path):
    args = ["--train-steps", "5", "--generations", "1", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path)]
    mod = _load("torch_mohaq_search_sru")
    out = mod.main(args)
    assert out["exp1"].n_evals > 0 and out["exp3_beacon"].beacon_search
    resumed = mod.main(args + ["--resume"])
    for k in ("exp1", "exp2", "exp3"):
        assert resumed[k].front_key() == out[k].front_key()



def test_mohaq_search_xlstm():
    out = _load("torch_mohaq_search_xlstm").main(
        ["--train-steps", "3", "--generations", "1", "--device", "cpu"])
    assert out["bitfusion"].n_evals > 0 and out["mem_only"].n_evals > 0
    assert len(out["target"].layer_names) == 5


def test_serve_quantized():
    """The int8 head's logit error stays within its rounding bound
    (``serving.lm.head_error_bound``), and its greedy tokens equal the
    dense head's up to the first position where the dense top-2 margin is
    within the bound's reach, and part only there (seeded random weights
    can put two logits on an exact bf16 tie)."""
    out = _load("torch_serve_quantized").main(["--device", "cpu"])
    held = out["held_on_margins"]
    assert held["ok"], held
    assert held["first_differing"] is None or (
        held["first_tie"] is not None
        and held["first_differing"] >= held["first_tie"])
    assert out["served"]["n_completed"] == 6
    assert out["quant_matmul_launches"] == 0     # no kernel on the CPU


@pytest.mark.parametrize("fault", ["scales_x1.1", "clip_0.8"])
def test_serve_quantized_bound_fails_a_wrong_head(fault):
    """The margin check has teeth: an int8 head whose scales are 10 % off,
    or whose clip cuts the largest 20 % of the range, errs past the
    rounding bound (``serving.lm.head_error_bound``) on the example's
    model, prompt and decode, and ``on_margins`` fails it; the right head
    stays within the bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import lm
    cfg = get_config("stablelm-1.6b").reduced()
    params = tfm.init_lm(0, cfg, torch.device("cpu"))
    w = tfm.logits_head_weight(params, cfg).to(torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    dense = lm.decode_loop(params, cfg, tokens, 8)
    amax = float(w.abs().max())
    right = kops.pack_for_kernel(w, 8, amax)
    wrong = {"scales_x1.1": (right[0], right[1] * 1.1),
             "clip_0.8": kops.pack_for_kernel(w, 8, 0.8 * amax)}[fault]
    held = {}
    for name, (packed, scales) in (("right", right), ("wrong", wrong)):
        rec = lm.RecordingHead(lm.QuantHead(packed, scales, 8))
        quant = lm.decode_loop(params, cfg, tokens, 8, head_fn=rec)
        held[name] = rec.on_margins(
            w, lambda h: tfm.logits_head(params, cfg, h), dense, quant)
    assert held["right"]["ok"] and held["right"]["max_error_share"] <= 1.0
    assert not held["wrong"]["ok"], held["wrong"]
    assert held["wrong"]["max_error_share"] > 1.0


def test_examples_need_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_quickstart").main([])


def test_mohaq_serving_prices_a_dry_run_cell(tmp_path):
    """The default mode on a cell written by ``run_cell(reduced=True)``:
    the H100's rate and capacity price it, and every front member carries
    its violation of the 80 GB."""
    import json
    from repro_torch.launch import dryrun
    cell = dryrun.run_cell("deepseek-67b", "decode_32k", verbose=False,
                           kv_cache_int8=True, reduced=True)
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(cell))
    mod = _load("torch_mohaq_serving")
    out = mod.main(["--artifact", str(path), "--reduced", "--device", "cpu"])
    assert out["mode"] == "roofline" and out["n_devices"] == 1
    assert out["front"] and out["fits"] == len(out["front"])
    assert all(m["violation_gb"] == 0.0 for m in out["front"])
    with pytest.raises(SystemExit, match="repro_torch.launch.dryrun"):
        mod.main(["--artifact", str(tmp_path / "missing.json"),
                  "--device", "cpu"])
    assert "pod" in mod.ARTIFACT and "--mesh pod" in mod.DRYRUN


def test_mohaq_serving_prices_a_pod_cell_per_card(tmp_path):
    """The default mode's cell, on the (16, 16) mesh (a reduced cell
    written in a child: a mesh cell runs under a fake process group): the
    search is per card, over the cell's 256 devices, and front members
    fit a card."""
    import json
    import os
    import subprocess
    import sys
    code = ("import json\n"
            "from repro_torch.launch import dryrun as D\n"
            "print(json.dumps(D.run_cell('deepseek-67b', 'decode_32k', "
            "'pod', verbose=False, kv_cache_int8=True, reduced=True)))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": "src"},
                          cwd=str(Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    cell = json.loads(proc.stdout.strip().splitlines()[-1])
    assert cell["n_devices"] == 256 and cell["fits"]
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(cell))
    out = _load("torch_mohaq_serving").main(
        ["--artifact", str(path), "--reduced", "--device", "cpu"])
    assert out["n_devices"] == 256 and out["front"]
    assert out["fits"] == len(out["front"]) > 0
    assert out["cache_bytes"] < cell["memory_analysis"]["argument_bytes"]


def test_mohaq_serving_sharded_demo():
    out = _load("torch_mohaq_serving").main(
        ["--sharded-demo", "--shards", "4", "--train-steps", "5",
         "--device", "cpu"])
    assert out["front_equal"] and out["shards"] == 4
    assert out["physical_devices"] == 1


def test_mohaq_serving_serve_demo():
    out = _load("torch_mohaq_serving").main(
        ["--serve-demo", "--train-steps", "5", "--device", "cpu"])
    assert out["bitwise"] and out["served"]["n_completed"] == 9


def test_mohaq_serving_needs_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_mohaq_serving").main([])
