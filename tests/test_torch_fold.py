"""Folded loops under the roofline counter (``roofline/counter.py::trips``):
a step counted with its layer, token and chunk loops folded gives the
counts of the same step run in full, on every family's reduced config
(deep enough that each loop folds: more than four layers, pairs or
groups; the sLSTM's 32 steps and the Mamba scan's four chunks of eight).

Folded and unfolded must agree on FLOPs by dtype, the eager-stream bytes,
``min_hbm_bytes``, the kernel launches, the collective bytes and their
count, and the reckoned peak with its parts: in the train step at
``accum_steps`` 1 and 2 (the backward pass of a folded loop runs later,
in autograd), in prefill and in decode; unsharded here, and on fake
(1, 2) and (2, 1, 2) meshes in a subprocess (the fake process group must
not outlive the call in this worker; a first folded count there fills
DTensor's sharding caches, whose misses run a few index ops of their
own). Outside a counter ``trips`` is ``range``, so a real step is the
unfolded program bit for bit."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES_BY_NAME, reduced_shape
from repro_torch.launch import dryrun as D
from repro_torch.models import common as cm
from repro_torch.models import xlstm as X
from repro_torch.roofline import counter as C
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

REPO = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "stablelm-1.6b", "moe": "granite-moe-1b-a400m",
            "ssm": "xlstm-350m", "hybrid": "jamba-1.5-large-398b",
            "audio": "seamless-m4t-medium", "vlm": "internvl2-26b"}
# layers that fold every family's loop (more than four trips): 5 blocks,
# 5 xLSTM pairs, 5 hybrid groups of (Mamba, attention), 5 + 5 encoder and
# decoder blocks
LAYERS = {"dense": 5, "moe": 5, "ssm": 10, "hybrid": 10, "audio": 5,
          "vlm": 5}
FIELDS = ("flops", "flops_by_dtype", "hbm_bytes", "elementwise_flops",
          "min_hbm_bytes", "launches", "ici_bytes",
          "collective_bytes_by_type", "collective_bytes_by_dtype",
          "n_collectives", "argument_bytes", "closure_bytes", "temp_bytes",
          "output_bytes", "alias_bytes", "reckoned_peak_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: with six test workers on eight cores a
    multithreaded op waits on its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deep_config(family: str):
    cfg = get_config(FAMILIES[family]).reduced()
    return dataclasses.replace(cfg, n_layers=LAYERS[family],
                               n_dec_layers=5 if cfg.is_encdec else 0)


def cell(family: str, kind: str, accum: int = 1):
    """The reduced cell's step and its meta arguments (a train batch of 4
    rows, so that two microbatches split it on two data shards)."""
    cfg = deep_config(family)
    shape = reduced_shape(SHAPES_BY_NAME[{"train": "train_4k",
                                          "prefill": "prefill_32k",
                                          "decode": "decode_32k"}[kind]])
    if kind == "train":
        shape = dataclasses.replace(shape, global_batch=4)
    step, args, _ = D.build_step(cfg, shape, accum_steps=accum)
    if kind == "train":
        step = ts.make_train_step(D.get_model(cfg, device="cpu"),
                                  opt.AdamWConfig(), accum_steps=accum)
    cm._rope_freqs(cfg.head_dim // 2, float(cfg.rope_theta),
                   torch.device("meta"))      # the step's cached table
    return step, args


def both(step, args):
    """(folded, unfolded) counts as dicts of ``FIELDS``."""
    out = []
    for fold in (True, False):
        counts = C.count(step, *args, fold_trips=fold).as_dict()
        out.append({k: counts[k] for k in FIELDS})
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("accum", [1, 2])
def test_folded_train_step_counts_the_unfolded_one(family, accum):
    folded, unfolded = both(*cell(family, "train", accum))
    assert folded == unfolded
    assert folded["reckoned_peak_bytes"] > folded["argument_bytes"] > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_folded_prefill_and_decode_count_the_unfolded_ones(family):
    for kind in ("prefill", "decode"):
        folded, unfolded = both(*cell(family, kind))
        assert folded == unfolded, kind


def test_folded_loops_run_four_trips():
    """A folded loop of n > 4 trips runs indices 0, 1, 2 and n - 1, the
    third counted n - 3 times; ``fill_trips`` gives back the n values
    (the middle one repeated, detached)."""
    a, b = torch.randn(8, 16, requires_grad=True), torch.randn(16, 4)
    seen, filled = [], []

    def loop(a, b):
        out = []
        for i in C.trips(7):
            seen.append(i)
            out.append(a @ b)
        filled[:] = C.fill_trips(out, 7)
        return torch.stack(filled).sum()
    folded = C.count(loop, a, b)
    assert seen == [0, 1, 2, 6] and len(filled) == 7
    assert filled[2].requires_grad and not filled[3].requires_grad
    assert torch.equal(filled[3], filled[2])
    unfolded = C.count(loop, a, b, fold_trips=False)
    assert seen[4:] == list(range(7))
    assert folded.flops == unfolded.flops == 7 * C.count(
        torch.matmul, a, b).flops


def test_trips_is_range_outside_a_counter():
    """No counter, or one that does not fold: ``trips`` is ``range`` and
    ``fill_trips`` returns its list, so a real train step runs the same
    program (its loss and gradients the same bits) counted or not."""
    for n in (0, 1, 4, 5, 12):
        assert C.trips(n) == range(n)
        assert C.fill_trips(list(range(n)), n) == list(range(n))
    cfg = deep_config("ssm")
    model = D.get_model(cfg, device="cpu")
    state = ts.init_train_state(model, 0)
    tokens = torch.from_numpy(__import__("numpy").random.default_rng(
        0).integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = ts.make_train_step(model, opt.AdamWConfig(), accum_steps=2)
    _, plain = step(state, batch)
    counter = C.Counter(fold_trips=False)
    with counter:
        assert C.trips(12) == range(12)
        _, counted = step(state, batch)
    assert torch.equal(plain["loss"], counted["loss"])
    assert torch.equal(plain["grad_norm"], counted["grad_norm"])


def test_mlstm_chunk_loop_folds():
    """The mLSTM's chunk loop (128-step chunks at full size; 8 here, over
    48 steps: six chunks) folded and unfolded, in the forward pass and
    with its gradient; the first chunk's skipped read-out and the last
    chunk's skipped update (ROADMAP fault 12) run as they do unfolded."""
    cfg = deep_config("ssm")
    p = {k: torch.empty_like(v, device="meta") for k, v in
         X.init_mlstm(torch.Generator().manual_seed(0), cfg).items()}
    x = torch.empty((2, 48, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")

    def fwd(p, x):
        return X.mlstm_fwd(p, cfg, x, chunk=8)

    def grad(p, x):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            y = X.mlstm_fwd(leaves, cfg, x, chunk=8)
            return torch.autograd.grad(y.float().sum(),
                                       list(leaves.values()))
    for fn in (fwd, grad):
        folded, unfolded = both(fn, (p, x))
        assert folded == unfolded, fn.__name__


MESH_CASES = [("1x2", "dense", "train", 2), ("1x2", "moe", "decode", 0),
              ("1x2", "ssm", "train", 1), ("1x2", "hybrid", "prefill", 0),
              ("1x2", "audio", "decode", 0), ("1x2", "vlm", "decode", 0),
              ("2x1x2", "dense", "decode", 0),
              ("2x1x2", "audio", "prefill", 0)]

_MESH_CODE = """
import json, sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
import test_torch_fold as T
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun as D, mesh as lmesh
from repro_torch.roofline import counter as C
from repro_torch.configs.base import SHAPES_BY_NAME, reduced_shape
import dataclasses
lmesh.init_fake_group(4)
meshes = {{"1x2": lmesh._grid((1, 2), ("data", "model")),
          "2x1x2": lmesh._grid((2, 1, 2), ("pod", "data", "model"))}}
out = {{}}
for m, family, kind, accum in T.MESH_CASES:
    mesh = meshes[m]
    cfg = T.deep_config(family)
    shape = reduced_shape(SHAPES_BY_NAME[{{"train": "train_4k",
        "prefill": "prefill_32k", "decode": "decode_32k"}}[kind]])
    if kind == "train":
        shape = dataclasses.replace(shape, global_batch=4)
    got = []
    for fold in (True, True, False):   # the first fills DTensor's caches
        step, args, _, _ = D.build_mesh_step(cfg, shape, mesh,
                                             accum_steps=max(accum, 1))
        if kind == "train":
            step = T.ts.make_train_step(D.get_model(cfg, device="cpu"),
                                        T.opt.AdamWConfig(), accum_steps=accum)
        T.cm._rope_freqs(cfg.head_dim // 2, float(cfg.rope_theta),
                         torch.device("meta"))
        with sh.axis_rules(mesh):
            c = C.count(step, *args, fold_trips=fold).as_dict()
        got.append({{k: c[k] for k in T.FIELDS}})
    out["/".join(map(str, (m, family, kind, accum)))] = got[1:]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_counts():
    proc = subprocess.run(
        [sys.executable, "-c", _MESH_CODE.format(tests=str(REPO / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "PYTHONPATH": "src"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh,family,kind,accum", MESH_CASES)
def test_folded_mesh_cell_counts_the_unfolded_one(mesh_counts, mesh, family,
                                                  kind, accum):
    folded, unfolded = mesh_counts["/".join(map(str, (mesh, family, kind,
                                                      accum)))]
    assert folded == unfolded
    assert folded["n_collectives"] > 0 and folded["ici_bytes"] > 0
