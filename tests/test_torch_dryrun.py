"""The port's dry run (``repro_torch/launch/dryrun.py``) and its tables
(``repro_torch/roofline/tables.py``) on reduced cells: spec trees with the
real init's shapes and dtypes for every family, ``run_cell`` artifacts in
the reference's JSON schema, the reference's weight-quantized decode of the
hybrid (the whole tree dequantized first) against the reference's own,
the reference's markdown from the same JSON, and the mesh cells (``--mesh
pod|multi|both``, ``--rules``, ``--bf16-partials``, run in subprocesses:
the fake process group of a mesh cell must not outlive the call)."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import quantization as RQ
from repro.models import common as RC
from repro.models import transformer as RT
from repro.roofline import report as RR
from repro.roofline import tables as RTAB
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, reduced_shape
from repro_torch.configs.base import SHAPES_BY_NAME as SHAPES_BY_NAME_PORT
from repro_torch.core import quantization as Q
from repro_torch.launch import dryrun as D
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.roofline import tables as TTAB

REPO = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "stablelm-1.6b", "moe": "granite-moe-1b-a400m",
            "ssm": "xlstm-350m", "hybrid": "jamba-1.5-large-398b",
            "audio": "seamless-m4t-medium", "vlm": "internvl2-26b"}
# the reference's run_cell keys (its dryrun.py:222-237)
REF_KEYS = {"arch", "shape", "mesh", "status", "fsdp", "accum_steps",
            "lower_s", "compile_s", "analyze_s", "memory_analysis",
            "cost_analysis", "roofline"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: with six test workers on eight cores a
    multithreaded op waits on its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), tree.dtype, tree.device.type)}
    return {prefix: tree}


def _same_specs(spec, real):
    s, r = _leaves(spec), _leaves(real)
    assert s.keys() == r.keys()
    for k in s:
        if isinstance(s[k], tuple):
            assert s[k][:2] == r[k][:2], k
            assert s[k][2] == "meta", k
        else:
            assert s[k] == r[k], k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spec_trees_equal_the_real_init(family):
    cfg = get_config(FAMILIES[family]).reduced()
    model = D.get_model(cfg, device="cpu")
    params = model.init(0)
    _same_specs(D.param_specs(model), params)
    _same_specs(D.train_state_specs(model), D.ts.init_train_state(model))
    _same_specs(D.cache_specs(model, 2, 8), model.init_cache(2, 8))
    for bits in (8, 4):
        _same_specs(D.quant_specs(D.param_specs(model), bits),
                    Q.quantize_tree(params, bits))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_cell_gives_the_reference_schema(family):
    ref_fields = {f.name for f in dataclasses.fields(RR.RooflineReport)}
    for sh in SHAPES:
        out = D.run_cell(FAMILIES[family], sh.name, verbose=False,
                         reduced=True)
        if sh.name == "long_500k" and family not in ("ssm", "hybrid"):
            assert out["status"] == "skip"
            continue
        assert out["status"] == "ok", out
        assert REF_KEYS <= out.keys()
        assert ref_fields <= out["roofline"].keys()
        assert set(out["memory_analysis"]) == {
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
        r = out["roofline"]
        assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["ici_bytes"] == 0
        assert out["n_devices"] == 1 and out["fits"] is True
        assert out["floor_s"] == pytest.approx(max(
            r["compute_s"], r["min_hbm_bytes"] / 3.35e12))
        assert r["step_time_lower_bound_s"] >= out["floor_s"] > 0
        assert out["reckoned_peak_bytes"] == (
            out["memory_analysis"]["argument_bytes"]
            + out["memory_analysis"]["temp_bytes"])
        json.dumps(out)


def test_run_on_card_lane_on_the_cpu():
    """``run_on_card`` on the CPU at a reduced cell: the timing and its
    share (the card's peak memory is read only on a card)."""
    cfg = get_config("xlstm-350m").reduced()
    got = D.run_on_card(cfg, reduced_shape(SHAPES[2]), device="cpu", reps=2)
    assert got["ms"] > 0 and got["max_memory_allocated"] is None


@pytest.mark.parametrize("bits", [8, 4])
def test_wbits_decode_of_the_hybrid_matches_the_reference(bits):
    """The reduced hybrid's weight-quantized decode (the reference's
    dryrun.py:161-165: ``quantize_tree``, then ``dequantize_tree`` of the
    whole tree inside the step), prompt and weights from the reference,
    within the decode tolerance of ``tests/test_torch_hybrid.py`` (atol
    0.15), at ``MOE_CAPACITY_FACTOR`` 8.0 in both packages and with the
    reference jitted, as there."""
    saved = RC.MOE_CAPACITY_FACTOR, TC.MOE_CAPACITY_FACTOR
    RC.MOE_CAPACITY_FACTOR = TC.MOE_CAPACITY_FACTOR = 8.0
    try:
        arch = FAMILIES["hybrid"]
        rcfg, tcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
        rparams = jax.jit(RT.init_lm, static_argnums=(1,))(
            jax.random.PRNGKey(0), rcfg)
        tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                       "cpu")
        # tests/test_torch_hybrid.py's prompt (B 2, 8 + 4 tokens); another
        # draw, rng(1) of (2, 9), parted the dense prefill by 0.80 while the
        # port's norms read the bf16 residual sum (ROADMAP fault 11, fixed)
        tokens = np.random.default_rng(1).integers(
            0, rcfg.vocab_size, (2, 12)).astype(np.int32)[:, :9]
        rq = RQ.quantize_tree(rparams, bits)
        rdeq = RQ.dequantize_tree(rq, jax.eval_shape(lambda: rparams), bits)
        _, rc = jax.jit(RT.prefill, static_argnums=(1,),
                        static_argnames=("max_len",))(
            rdeq, rcfg, jnp.asarray(tokens[:, :8]), max_len=9)
        want, _ = jax.jit(RT.decode_step, static_argnums=(1,))(
            rdeq, rcfg, rc, jnp.asarray(tokens[:, 8:]))
        model = D.get_model(tcfg, device="cpu")
        tq = Q.quantize_tree(tparams, bits)
        spec = Q.tree_spec(tparams)
        _, tcache = TT.prefill(Q.dequantize_tree(tq, spec, bits), tcfg,
                               torch.from_numpy(tokens[:, :8]), max_len=9)
        step = D.make_wbits_decode(model, spec, bits)
        got, _ = step(tq, tcache, {"token": torch.from_numpy(tokens[:, 8:])})
    finally:
        RC.MOE_CAPACITY_FACTOR, TC.MOE_CAPACITY_FACTOR = saved
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.15)


def test_wbits_decode_cell_counts_the_dequantization():
    dense = D.run_cell("jamba-1.5-large-398b", "decode_32k", verbose=False,
                       reduced=True)
    for bits in (8, 4):
        q = D.run_cell("jamba-1.5-large-398b", "decode_32k", verbose=False,
                       reduced=True, serve_wbits=bits)
        assert q["roofline"]["flops"] == dense["roofline"]["flops"]
        assert q["memory_analysis"]["argument_bytes"] < \
            dense["memory_analysis"]["argument_bytes"]
        assert q["roofline"]["hbm_bytes"] > dense["roofline"]["hbm_bytes"]


def test_tables_render_the_reference_markdown(tmp_path):
    for arch in ("stablelm-1.6b", "xlstm-350m"):
        for sh in SHAPES:
            out = D.run_cell(arch, sh.name, verbose=False, reduced=True)
            (tmp_path / f"{arch}_{sh.name}_single.json").write_text(
                json.dumps(out))
    cells = TTAB.load_cells(str(tmp_path))
    assert cells == RTAB.load_cells(str(tmp_path))
    assert len(cells) == 8
    assert TTAB.roofline_md(cells) == RTAB.roofline_md(cells)
    assert TTAB.dryrun_md(cells) == RTAB.dryrun_md(cells)
    h100 = TTAB.h100_md(cells).splitlines()
    assert len(h100) == 2 + 8 and "fits" in h100[0]
    assert sum("| yes |" in row for row in h100) == 7     # one skip


def test_gen_tool_writes_only_its_blocks(tmp_path):
    out = D.run_cell("stablelm-1.6b", "decode_32k", verbose=False,
                     reduced=True)
    (tmp_path / "stablelm-1.6b_decode_32k_single.json").write_text(
        json.dumps(out))
    md = tmp_path / "E.md"
    md.write_text("<!-- BEGIN ROOFLINE_SINGLE -->\nkept\n"
                  "<!-- END ROOFLINE_SINGLE -->\n")
    cmd = [sys.executable, str(REPO / "tools" / "torch_gen_experiments.py"),
           "--dir", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "TORCH_H100_SINGLE" in proc.stdout
    assert md.read_text().count("kept") == 1 and "TORCH" not in \
        md.read_text()
    subprocess.run(cmd + ["--out", str(md)], check=True, timeout=120)
    text = md.read_text()
    assert "kept" in text and "<!-- END TORCH_H100_SINGLE -->" in text
    assert "stablelm-1.6b | decode_32k" in text


@pytest.mark.parametrize("argv", [["--rules", "{}"], ["--bf16-partials"],
                                  ["--mesh", "single", "--rules", "{}"],
                                  ["--mesh", "single", "--bf16-partials"]])
def test_unported_levers_raise(argv, tmp_path, capsys):
    """The sharding levers act on a mesh's cells: with one card (``--mesh
    single``, the default) they exit 2 and ``run_cell`` raises."""
    assert D.main(argv + ["--arch", "stablelm-1.6b", "--shape",
                          "decode_32k", "--out", str(tmp_path)]) == 2
    assert "act on a mesh" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="act on a mesh"):
        D.run_cell("stablelm-1.6b", "decode_32k", "single",
                   rules_override={"mlp": None})


def _dryrun(argv, out, timeout=600):
    """The dry run's CLI in a subprocess (its fake process group must not
    outlive the call in this worker); returns the cells it wrote."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out)] + argv, capture_output=True, text=True, timeout=timeout,
        cwd=REPO, env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}


@pytest.mark.parametrize("argv,meshes", [
    (["--mesh", "pod"], ["pod"]), (["--mesh", "multi"], ["multi"]),
    (["--mesh", "both"], ["pod", "multi"]),
    (["--mesh", "pod", "--rules", '{"mlp": null}'], ["pod"]),
    (["--mesh", "multi", "--bf16-partials"], ["multi"])])
def test_mesh_levers(argv, meshes, tmp_path):
    """``--mesh pod|multi|both``, ``--rules`` and ``--bf16-partials`` on
    stablelm-1.6b's decode_32k at full size: one cell a mesh, each on its
    256 or 512 devices with per-device memory that fits a card and a
    collective term."""
    cells = _dryrun(argv + ["--arch", "stablelm-1.6b", "--shape",
                            "decode_32k"], tmp_path)
    assert sorted(cells) == sorted(f"stablelm-1.6b_decode_32k_{m}"
                                   for m in meshes)
    for m in meshes:
        c = cells[f"stablelm-1.6b_decode_32k_{m}"]
        assert c["status"] == "ok" and c["fits"]
        assert c["n_devices"] == {"pod": 256, "multi": 512}[m]
        assert c["mesh_shape"] == {"pod": {"data": 16, "model": 16},
                                   "multi": {"pod": 2, "data": 16,
                                             "model": 16}}[m]
        r = c["roofline"]
        assert r["n_collectives"] > 0 and r["collective_s"] > 0
        assert "NVLink domain" in r["collective_note"]
        assert c["bf16_partials"] == ("--bf16-partials" in argv)
        assert c["rules"] == ({"mlp": None} if "--rules" in argv else None)
    if len(meshes) == 2:      # the tables of both meshes, beside one card's
        proc = subprocess.run(
            [sys.executable, str(REPO / "tools" / "torch_gen_experiments.py"),
             "--dir", str(tmp_path)], capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0
        for key in ("TORCH_H100_POD", "TORCH_DRYRUN_POD", "TORCH_H100_MULTI",
                    "TORCH_DRYRUN_MULTI", "TORCH_H100_SINGLE"):
            assert f"## {key}" in proc.stdout
        assert "| stablelm-1.6b | decode_32k | multi | N |" in proc.stdout


def _local_bytes(mesh, axes, shapes, rules=None, ensure_model=False):
    """The bytes of one device's shards of a tree under the reference's
    specs (``fix_spec`` / ``_ensure_axis`` on duck-typed mesh axes)."""
    from repro.distributed import sharding as rsh
    total = 0
    with rsh.axis_rules(mesh, rules):
        def visit(ax, sd):
            nonlocal total
            if ax is None or not hasattr(sd, "shape") and not isinstance(
                    ax, dict):
                return
            if isinstance(ax, dict):
                for k in ax:
                    visit(ax[k], sd[k])
                return
            shape = tuple(sd.shape)
            spec = rsh.fix_spec(mesh, rsh.logical_to_spec(ax), shape)
            if ensure_model and len(shape) >= 2:
                spec = rsh._ensure_axis(mesh, spec, shape, "model")
            n = 1
            for i, d in enumerate(shape):
                p = spec[i] if i < len(spec) else None
                n *= d // rsh._axis_size(mesh, p)
            total += n * jnp.dtype(sd.dtype).itemsize
        visit(axes, shapes)
    return total


class _AxesMesh:
    def __init__(self, **axes):
        self.shape, self.axis_names = dict(axes), tuple(axes)


def test_multi_mesh_reduced_cell_counts(tmp_path):
    """The reduced stablelm-1.6b decode_32k cell on the (2, 16, 16) mesh,
    in a subprocess: the per-device argument bytes are the sum of the
    local shards of the params, the int8 cache and the batch under the
    reference's specs (beside what the step closes over, the RoPE
    frequency table); collectives are counted; ``--bf16-partials`` moves
    the row-parallel partial sums from float32 to bfloat16 all-reduces at
    half the bytes."""
    from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
    from repro.models import registry as RREG
    code = ("import json, torch\n"
            "from repro_torch.launch import dryrun as D\n"
            "kw = dict(verbose=False, reduced=True, kv_cache_int8=True)\n"
            "a = D.run_cell('stablelm-1.6b', 'decode_32k', 'multi', **kw)\n"
            "b = D.run_cell('stablelm-1.6b', 'decode_32k', 'multi', "
            "bf16_partials=True, **kw)\n"
            "print(json.dumps([a, b]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=REPO,
                          env={**__import__("os").environ,
                               "PYTHONPATH": "src"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    f32, bf16 = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = _AxesMesh(pod=2, data=16, model=16)
    rcfg = ref_get_config("stablelm-1.6b").reduced()
    shape = reduced_shape(SHAPES_BY_NAME_PORT["decode_32k"])
    rshape = dataclasses.replace(REF_SHAPES["decode_32k"],
                                 seq_len=shape.seq_len,
                                 global_batch=shape.global_batch)
    rm = RREG.get_model(rcfg)
    key = jax.random.PRNGKey(0)
    old = RT.KV_CACHE_DTYPE
    RT.KV_CACHE_DTYPE = jnp.int8
    try:
        rc = jax.eval_shape(lambda: rm.init_cache(shape.global_batch,
                                                  shape.seq_len))
    finally:
        RT.KV_CACHE_DTYPE = old
    crules = D.cache_rules(get_config("stablelm-1.6b").reduced(), shape,
                           mesh)
    want = (_local_bytes(mesh, rm.axes(), jax.eval_shape(
                lambda: rm.init(key)), ensure_model=True)
            + _local_bytes(mesh, {k: v for k, v in rm.cache_axes().items()
                                  if k != "cur"}, rc, rules=crules)
            + _local_bytes(mesh, RREG.batch_axes(rcfg, rshape),
                           RREG.input_specs(rcfg, rshape)))
    # what the step closes over: the RoPE frequency table (head_dim / 2 f32)
    assert f32["closure_bytes"] == 4 * get_config(
        "stablelm-1.6b").reduced().head_dim // 2
    assert f32["memory_analysis"]["argument_bytes"] - f32["closure_bytes"] \
        == want
    assert f32["n_devices"] == 512 and f32["fits"]
    r32, r16 = f32["roofline"], bf16["roofline"]
    assert r32["n_collectives"] > 0 and r32["ici_bytes"] > 0
    d32, d16 = r32["collective_bytes_by_dtype"], r16["collective_bytes_by_dtype"]
    moved = d32["all-reduce/float32"] - d16.get("all-reduce/float32", 0.0)
    assert moved > 0
    assert d16["all-reduce/bfloat16"] - d32.get("all-reduce/bfloat16", 0.0) \
        == moved / 2
    assert r16["collective_bytes_by_type"]["all-reduce"] == \
        r32["collective_bytes_by_type"]["all-reduce"] - moved / 2


def test_every_arch_has_a_port_config():
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch
