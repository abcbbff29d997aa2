"""Dry run of every (arch x shape) cell on one H100: build the cell's step
on meta tensors, reckon whether it fits the card, and price it.

Counterpart of the reference package's ``launch/dryrun.py``, which lowers
and compiles each cell for a TPU mesh, reads XLA's memory analysis and
prices the HLO. Here the step is the port's own (``make_train_step`` with
the reference's ``_auto_accum`` rule, ``make_serve_prefill`` or
``make_serve_decode``; with ``--serve-wbits`` the decode step dequantizes
the whole ``quantize_tree`` tree first, as the reference does), run once
on meta tensors under ``roofline/counter.py``: the FLOPs, bytes and kernel
launches it dispatches, and the bytes it holds alive, in place of the
compiler's analyses. Nothing compiles: ``lower_s`` is the seconds the spec
trees took to build, ``compile_s`` is 0, ``analyze_s`` the count's
(``analyze_cpu_s`` its CPU seconds). The count folds the step's layer,
token, chunk and microbatch loops (``counter.trips``): each runs four
trips, whatever its length, and counts as all of them.

    python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out experiments/torch_dryrun]
    python -m repro_torch.launch.dryrun --arch xlstm-350m --shape decode_32k \\
        --run-on-card [--serve-wbits 8]
    python -m repro_torch.launch.dryrun --arch deepseek-67b \\
        --shape decode_32k --mesh multi --kv-cache-int8

``--mesh single`` is one H100 here. ``--mesh pod`` is the reference's
``single``, a (16, 16) ("data", "model") mesh, ``--mesh multi`` its (2,
16, 16) ("pod", "data", "model") mesh, ``--mesh both`` the two
(``launch/mesh.py::make_production_mesh``). A mesh cell runs on meta
tensors under a fake process group of the mesh's size, made at start (as
the reference sets ``XLA_FLAGS`` first): the state is placed on the
logical-axes trees (``tree_shardings``, ``ensure_model=True``, FSDP when
the state over the model axis passes ``FSDP_BUDGET_GIB``), the batch on
``batch_axes`` and a decode cache on ``cache_axes`` with the reference's
cache rules, ``--rules`` overrides the logical rules (JSON) and
``--bf16-partials`` reduces row-parallel partial sums in bf16
(``models/common.py::BF16_PARTIALS``). The counts are one device's (its
local shards), with DTensor's collectives priced by the ring model, and
``fits`` holds that device to one card's 80 GB. A cell that does not fit
is a finding, not a failure: its status stays ``ok`` with ``fits``
false. ``--run-on-card`` (one card) also runs one
real step of each cell that fits on the card, at full size on seeded
weights: the median of 5 timed steps after one warm-up,
``torch.cuda.max_memory_allocated`` beside the reckoned peak, and
``floor_s`` over the measured time.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
import traceback

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, \
    reduced_shape, shape_applicable
from repro_torch.core import quantization as Q
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as lmesh
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import batch_axes, get_model, \
    input_specs, make_dummy_batch
from repro_torch.roofline import counter
from repro_torch.roofline.report import H100_HBM_CAPACITY_BYTES, \
    RooflineReport, model_flops_for
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

MESHES = {"pod": dict(multi_pod=False), "multi": dict(multi_pod=True)}
MESH_DEVICES = {"pod": 256, "multi": 512}
# Activation budget of _auto_accum: the remat-saved layer inputs of one
# microbatch. The reference allows 6 GiB of a 16 GiB TPU chip; the same
# share of an 80 GB card is 30 GiB, which leaves the rest for the
# parameters, the optimizer state and one block's recomputation.
ACT_BUDGET_GIB = 6.0 * 80 / 16
# The FSDP switch: the reference shards the state over data too when the
# state over the model axis would pass 12 GiB of a 16 GiB chip; the same
# share of an 80 GB card
FSDP_BUDGET_GIB = 12.0 * 80 / 16


class _OnMeta(TorchFunctionMode):
    """Every factory call made on meta and every random draw dropped: the
    port's ``init_*`` take a ``torch.Generator`` and a device, and a meta
    generator does not exist."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.device.type != "meta":
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def on_meta(fn, *args):
    """``fn(*args)`` with every tensor it makes on meta (no storage, no
    random number drawn); the counterpart of ``jax.eval_shape``."""
    with _OnMeta():
        return _to_meta(fn(*args))


def param_specs(model):
    return on_meta(model.init, 0)


def train_state_specs(model):
    return on_meta(ts.init_train_state, model)


def cache_specs(model, batch: int, max_len: int):
    return on_meta(model.init_cache, batch, max_len)


def quant_specs(pspecs, bits: int):
    """``quantize_tree`` of the param specs: int8 codes (int4 packed) and
    f32 scales, on meta."""
    return on_meta(Q.quantize_tree, pspecs, bits)


def _auto_accum(cfg, shape, start: int, budget_gib: float = ACT_BUDGET_GIB,
                dp: int = 1) -> int:
    """The reference's rule: grad-accumulation so that remat-saved layer
    inputs (L x B_micro/dev x S x D bf16) fit the activation budget, with
    ``dp`` data-parallel devices (1 on one card); the microbatch stays
    >= 1 a device."""
    accum = max(1, start)
    layers = cfg.n_layers + getattr(cfg, "n_dec_layers", 0)
    while True:
        b_dev = max(shape.global_batch // (dp * accum), 1)
        resid_gib = layers * b_dev * shape.seq_len * cfg.d_model * 2 / 2**30
        if resid_gib <= budget_gib:
            return accum
        if shape.global_batch // (dp * accum * 2) < 1 or \
                shape.global_batch % (dp * accum * 2) != 0:
            return accum
        accum *= 2


def _tree_gib(tree) -> float:
    return sum(t.numel() * t.element_size() for t in opt.tree_leaves(tree)
               if isinstance(t, torch.Tensor)) / 2**30


def cache_rules(cfg, shape, mesh):
    """The reference's decode cache rules (its dryrun.py:146-165): a batch
    smaller than the data axes shards the cache's sequence over "data"
    (and its head dim over "model" where the kv heads do not divide it);
    kv heads that the model axis does not divide shard the sequence over
    "model" (else the head dim), so the cache is not replicated across
    the model axis."""
    crules = {}
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    mp = mesh.shape.get("model", 1)
    if shape.global_batch < dp:
        crules.update(cache_batch=None, cache_seq=("data",))
        if cfg.n_kv_heads % mp != 0 and cfg.head_dim % mp == 0:
            crules["cache_hd"] = ("model",)
    elif cfg.n_kv_heads % mp != 0:
        if shape.seq_len % mp == 0:
            crules["cache_seq"] = ("model",)
        elif cfg.head_dim % mp == 0:
            crules["cache_hd"] = ("model",)
    return crules or None


def build_mesh_step(cfg, shape, mesh, *, accum_steps: int = 2,
                    serve_wbits: int = 0, rules=None):
    """The cell's step on ``mesh`` and its arguments as DTensors of meta
    local shards, placed as the reference's dry run shards them. Returns
    (step, args, accum_steps or None, fsdp)."""
    model = get_model(cfg, device="cpu")
    specs = input_specs(cfg, shape)
    static = {}
    if "max_len" in specs:
        static["max_len"] = specs.pop("max_len")
    baxes = batch_axes(cfg, shape)
    baxes.pop("max_len", None)
    batch = sh.place_tree(specs, sh.tree_shardings(mesh, baxes, specs,
                                                   rules=rules))
    model_axis = mesh.shape.get("model", 1)

    def placed(tree, axes):
        fsdp = _tree_gib(tree) / model_axis > FSDP_BUDGET_GIB
        return sh.place_tree(tree, sh.tree_shardings(
            mesh, axes, tree, rules=rules, fsdp=fsdp,
            ensure_model=True)), fsdp

    if shape.kind == "train":
        dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        accum = _auto_accum(cfg, shape, accum_steps, dp=dp)
        state, fsdp = placed(train_state_specs(model),
                             ts.train_state_axes(model))
        step = ts.make_train_step(model, opt.AdamWConfig(),
                                  accum_steps=accum)
        return step, (state, batch), accum, fsdp
    pspecs = param_specs(model)
    if shape.kind == "prefill":
        params, fsdp = placed(pspecs, model.axes())
        return ts.make_serve_prefill(model, static), (params, batch), None, \
            fsdp
    if serve_wbits:
        step = make_wbits_decode(model, pspecs, serve_wbits)
        params, fsdp = placed(quant_specs(pspecs, serve_wbits),
                              Q.quant_tree_axes(model.axes(), pspecs))
    else:
        step = ts.make_serve_decode(model)
        params, fsdp = placed(pspecs, model.axes())
    # the cache rules alone over the defaults, as in the reference
    cache = cache_specs(model, shape.global_batch, shape.seq_len)
    cache = sh.place_tree(cache, sh.tree_shardings(
        mesh, model.cache_axes(), cache,
        rules=cache_rules(cfg, shape, mesh)))
    return step, (params, cache, batch), None, fsdp


def build_step(cfg, shape, *, accum_steps: int = 2, serve_wbits: int = 0,
               device=None):
    """The cell's step and its arguments: on meta tensors (``device``
    None), or drawn on ``device`` from seed 0. Returns (step, args,
    accum_steps or None)."""
    real = device is not None
    model = get_model(cfg, device=device if real else "cpu")
    specs = input_specs(cfg, shape)
    static = {}
    if "max_len" in specs:
        static["max_len"] = specs.pop("max_len")
    batch = make_dummy_batch(cfg, shape, device=device) if real else specs
    batch.pop("max_len", None)
    if shape.kind == "train":
        accum = _auto_accum(cfg, shape, accum_steps)
        state = ts.init_train_state(model) if real \
            else train_state_specs(model)
        step = ts.make_train_step(model, opt.AdamWConfig(),
                                  accum_steps=accum)
        return step, (state, batch), accum
    params = model.init(0) if real else param_specs(model)
    if shape.kind == "prefill":
        return ts.make_serve_prefill(model, static), (params, batch), None
    cache = model.init_cache(shape.global_batch, shape.seq_len) if real \
        else cache_specs(model, shape.global_batch, shape.seq_len)
    if not serve_wbits:
        return ts.make_serve_decode(model), (params, cache, batch), None
    step = make_wbits_decode(model, Q.tree_spec(params), serve_wbits)
    qparams = Q.quantize_tree(params, serve_wbits) if real \
        else quant_specs(params, serve_wbits)
    del params
    return step, (qparams, cache, batch), None


def make_wbits_decode(model, pspecs, bits: int):
    """The reference's weight-quantized decode step (its dryrun.py:
    161-165): ``step(qparams, cache, batch)`` dequantizes the whole
    ``quantize_tree`` tree (``pspecs``: the params' shapes and dtypes) and
    runs the decode step on it, for every family (the hybrid's nested
    Mamba stacks included)."""
    base_step = ts.make_serve_decode(model)

    def step(qparams, cache, batch):
        return base_step(Q.dequantize_tree(qparams, pspecs, bits), cache,
                         batch)
    return step


def _levers(moe_group: int, moe_dispatch: str, kv_cache_int8: bool,
            bf16_partials: bool = False):
    """Set the reference's perf levers; returns their old values."""
    old = (cm.MOE_GROUP_SIZE, cm.MOE_DISPATCH, tfm.KV_CACHE_DTYPE,
           cm.BF16_PARTIALS)
    if moe_group:
        cm.MOE_GROUP_SIZE = moe_group
    if moe_dispatch:
        cm.MOE_DISPATCH = moe_dispatch
    if kv_cache_int8:
        tfm.KV_CACHE_DTYPE = torch.int8
    if bf16_partials:
        cm.BF16_PARTIALS = True
    return old


def _restore(old) -> None:
    (cm.MOE_GROUP_SIZE, cm.MOE_DISPATCH, tfm.KV_CACHE_DTYPE,
     cm.BF16_PARTIALS) = old


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_on_card(cfg, shape, *, accum_steps: int = 2, serve_wbits: int = 0,
                device="cuda", reps: int = 5) -> dict:
    """One real step of the cell on ``device`` at full size, on weights
    drawn from seed 0: the median and range of ``reps`` timed steps after
    one warm-up; on a card the bytes its arguments hold and the peak of
    allocated memory over the steps, both net of what was allocated
    before the arguments were made."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    base = torch.cuda.memory_allocated(dev) if cuda else None
    step, args, _ = build_step(cfg, shape, accum_steps=accum_steps,
                               serve_wbits=serve_wbits, device=dev)
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) - base if cuda else None
    step(*args)
    _sync(dev)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(*args)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"ms": statistics.median(ms), "ms_min": min(ms), "ms_max": max(ms),
           "reps": reps, "argument_bytes": held,
           "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                    - base if cuda else None)}
    del step, args
    return out


def production_mesh(mesh_kind: str):
    """The ``pod`` or ``multi`` mesh over a fake process group (made here
    if no group of that size is up)."""
    lmesh.init_fake_group(MESH_DEVICES[mesh_kind])
    quick_redistribute_planning()
    return lmesh.make_production_mesh(**MESHES[mesh_kind])


def quick_redistribute_planning() -> None:
    """Make DTensor's graph-based redistribute planner cheaper without
    changing a plan. Where a placement is a strided shard or a tensor dim
    is split over mesh dims out of order, DTensor plans a redistribution
    by Dijkstra over sharding states, and its sharding propagation prices
    every candidate strategy of every new op that way. Each step's price
    builds two ``DTensorSpec``s, and each search expands its states anew:
    on the (2, 16, 16) mesh a train cell spends most of its count there
    (PERF.md §6). The planner's step price is computed here from the same
    numbers in the same order (the tensor's bytes over the mesh sizes of
    its sharded dims, ``_compute_placement_transition_cost``), and a
    planner keeps the states it expanded, keyed with the target
    placements that decide them: the same costs and the same paths, so
    the same collectives are counted. A PyTorch without these internals
    keeps its own planner."""
    try:
        from torch.distributed.tensor import _collective_utils as cu
        from torch.distributed.tensor import _redistribute as rd
        from torch.distributed.tensor.placement_types import _is_shard_like
        planner = rd.DTensorRedistributePlanner
        step_cost = cu._compute_placement_transition_cost
        topo_of = cu.MeshTopoInfo.build_from_mesh
        setup, expand = planner.setup_cost_callbacks, planner.get_next_state
    except (ImportError, AttributeError):
        return
    if getattr(planner, "_quick", False):
        return

    def setup_cost_callbacks(self):
        setup(self)
        meta, mesh = self.dtensor_meta, self.device_mesh
        nbytes = meta.dtype.itemsize * math.prod(meta.shape)
        sizes = [mesh.size(i) for i in range(mesh.ndim)]
        topo = topo_of(mesh)

        def cost_function(src_state, dst_state):
            cur, tgt = src_state.placements, dst_state.placements
            if cur == tgt:
                return 0.0
            dim = -1
            for i, (a, b) in enumerate(zip(cur, tgt)):
                if a != b:
                    if dim != -1:
                        raise ValueError("one_step_redistribute_cost "
                                         "expects specs that differ by "
                                         "exactly one placement")
                    dim = i
            shards = 1
            for i, p in enumerate(cur):
                if _is_shard_like(p):
                    shards *= sizes[i]
            comm_bytes_gb = nbytes / shards / 1024 / 1024 / 1024
            return step_cost(cur[dim], tgt[dim], topo, dim, comm_bytes_gb)[0]
        self.cost_function = cost_function

    def get_next_state(self, placements, tensor_mesh_dim_tuple):
        key = (placements, tensor_mesh_dim_tuple,
               frozenset(self.strided_shard_placements_in_target),
               frozenset(self.partial_reduce_ops_in_target))
        seen = self.__dict__.setdefault("_expanded", {})
        if key not in seen:
            seen[key] = expand(self, placements, tensor_mesh_dim_tuple)
        return seen[key]

    planner.setup_cost_callbacks = setup_cost_callbacks
    planner.get_next_state = get_next_state
    planner._quick = True
    getattr(rd, "clear_redistribute_planner_cache", lambda: None)()


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             rules_override=None, verbose: bool = True, accum_steps: int = 2,
             bf16_partials: bool = False,
             moe_group: int = 0, moe_dispatch: str = "",
             serve_wbits: int = 0, kv_cache_int8: bool = False,
             run_card: bool = False, reduced: bool = False) -> dict:
    """One cell: its JSON artifact as a dict (``reduced``: the config's
    and the shape's CPU-test sizes, ``reduced()`` and ``reduced_shape``)."""
    if mesh_kind not in ("single",) + tuple(MESHES):
        raise ValueError(f"unknown mesh {mesh_kind!r}")
    if mesh_kind == "single" and (rules_override or bf16_partials):
        raise ValueError("--rules and --bf16-partials act on a mesh: "
                         "--mesh pod|multi|both")
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    skip = shape_applicable(cfg, shape)
    if reduced:
        cfg, shape = cfg.reduced(), reduced_shape(shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skip", "reason": skip}
    old = _levers(moe_group, moe_dispatch, kv_cache_int8, bf16_partials)
    wbits = serve_wbits if shape.kind == "decode" else 0
    mesh, fsdp, rules = None, False, None
    try:
        t0 = time.time()
        if mesh_kind == "single":
            step, args, accum = build_step(cfg, shape,
                                           accum_steps=accum_steps,
                                           serve_wbits=wbits)
            ctx = sh.axis_rules(None)
        else:
            mesh = production_mesh(mesh_kind)
            rules = _rules(rules_override)
            step, args, accum, fsdp = build_mesh_step(
                cfg, shape, mesh, accum_steps=accum_steps,
                serve_wbits=wbits, rules=rules)
            ctx = sh.axis_rules(mesh, rules)
        t_lower = time.time() - t0
        t0, c0 = time.time(), time.process_time()
        with ctx:
            counts = counter.count(step, *args)
        t_analyze, c_analyze = time.time() - t0, time.process_time() - c0
        del step, args
        card = None
        fits = counts.reckoned_peak_bytes < H100_HBM_CAPACITY_BYTES
        if run_card and fits and mesh is None:
            card = run_on_card(cfg, shape, accum_steps=accum_steps,
                               serve_wbits=wbits)
    finally:
        _restore(old)
    n_dev = mesh.size if mesh is not None else 1
    rep = RooflineReport.build(
        arch=arch, shape=shape_name, mesh=mesh_kind, n_devices=n_dev,
        counts=counts, model_flops=model_flops_for(cfg, shape),
        group_sizes=mesh.shape if mesh is not None else None)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok", "fsdp": bool(fsdp),
           "accum_steps": accum if shape.kind == "train" else None,
           "lower_s": round(t_lower, 2), "compile_s": 0.0,
           "analyze_s": round(t_analyze, 2),
           "analyze_cpu_s": round(c_analyze, 2),
           "memory_analysis": {
               "argument_bytes": counts.argument_bytes,
               "output_bytes": counts.output_bytes,
               "temp_bytes": counts.temp_bytes,
               "alias_bytes": counts.alias_bytes,
           },
           "cost_analysis": {},
           "roofline": json.loads(rep.to_json()),
           "n_devices": n_dev, "fits": bool(fits),
           "reckoned_peak_bytes": counts.reckoned_peak_bytes,
           "closure_bytes": counts.closure_bytes,
           "floor_s": rep.floor_s, "serve_wbits": serve_wbits,
           "kv_cache_int8": kv_cache_int8}
    if mesh is not None:
        out.update(mesh_shape=mesh.shape, rules=rules,
                   bf16_partials=bf16_partials)
    if card is not None:
        card["floor_over_measured"] = rep.floor_s * 1e3 / card["ms"]
        card["reckoned_peak_bytes"] = counts.reckoned_peak_bytes
        out["card"] = card
    if verbose:
        print("  " + rep.summary_row())
        where = "/device" if mesh is not None else ""
        print(f"  mem{where}: args={counts.argument_bytes/2**30:.2f}GiB "
              f"temp={counts.temp_bytes/2**30:.2f}GiB "
              f"out={counts.output_bytes/2**30:.2f}GiB fits={fits} "
              f"(specs {t_lower:.1f}s count {t_analyze:.1f}s)")
        if card is not None:
            print(f"  card: {card['ms']:.3f} ms, peak "
                  f"{card['max_memory_allocated']/2**30:.2f}GiB, floor/measured "
                  f"{card['floor_over_measured']:.3f}")
    return out


def _rules(rules):
    """``--rules`` JSON (lists become tuples of mesh axes)."""
    if not rules:
        return None
    if isinstance(rules, str):
        rules = json.loads(rules)
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in rules.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "pod", "multi", "both"],
                    help="single: one H100; pod: (16, 16) data x model; "
                         "multi: (2, 16, 16) pod x data x model; both: "
                         "pod and multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/torch_dryrun")
    ap.add_argument("--rules", default=None,
                    help="JSON logical-rule overrides, e.g. "
                         "'{\"mlp\": null}' (a mesh's cells)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--accum", type=int, default=2,
                    help="grad-accumulation microbatches for train shapes")
    ap.add_argument("--bf16-partials", action="store_true",
                    help="perf lever: bf16 cross-shard partial sums (a "
                         "mesh's cells)")
    ap.add_argument("--moe-group", type=int, default=0,
                    help="perf lever: MoE token-group size")
    ap.add_argument("--moe-dispatch", default="",
                    choices=["", "einsum", "gather"],
                    help="perf lever: MoE dispatch algorithm")
    ap.add_argument("--serve-wbits", type=int, default=0, choices=[0, 4, 8],
                    help="perf lever: weight-quantized serving (decode)")
    ap.add_argument("--kv-cache-int8", action="store_true",
                    help="perf lever: int8 KV cache (decode)")
    ap.add_argument("--run-on-card", action="store_true",
                    help="also run one real step of each cell that fits on "
                         "the card")
    args = ap.parse_args(argv)
    meshes = ["pod", "multi"] if args.mesh == "both" else [args.mesh]
    if meshes == ["single"] and (args.rules or args.bf16_partials):
        print("[dryrun] --rules and --bf16-partials act on a mesh: pass "
              "--mesh pod|multi|both", file=sys.stderr)
        return 2
    if meshes != ["single"]:          # the fake group first, of the largest
        lmesh.init_fake_group(max(MESH_DEVICES[m] for m in meshes))

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}_{shape}_{mesh_kind}" + \
                    (f"_{args.tag}" if args.tag else "")
                print(f"[dryrun] {tag}", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind, args.rules,
                                   accum_steps=args.accum,
                                   bf16_partials=args.bf16_partials,
                                   moe_group=args.moe_group,
                                   moe_dispatch=args.moe_dispatch,
                                   serve_wbits=args.serve_wbits,
                                   kv_cache_int8=args.kv_cache_int8,
                                   run_card=args.run_on_card)
                except Exception as e:
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                if res["status"] == "skip":
                    print(f"  SKIP: {res['reason']}")
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
    print(f"[dryrun] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
