"""The LM trainer: train a config of ``configs/`` on the bigram token task.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 200 --batch 8 --seq 64 --ckpt-dir ckpt --device cpu

Port of the reference package's ``launch/train.py``. The state lives on a
(data, model) mesh of the process group's ranks (``launch/mesh.py``)
with ``--model-parallel`` ranks on the model axis: each leaf a DTensor on
``tree_shardings(train_state_axes, ensure_model=True)``, every batch
split over "data". Under ``torchrun`` the group is the launched one (NCCL
when each rank has a card), and a caller may initialise one itself; a
group of one rank gives a 1 x 1 mesh, whose steps give the bits of the
unsharded step. A run with no group and ``--model-parallel 1`` makes none
and trains on plain tensors (DTensor dispatch on a 1 x 1 mesh costs
host time and changes no bit). Every rank draws the same data and the
same initial state, and keeps its own shards; checkpoints hold whole
tensors (rank 0 writes them) and restore onto any mesh.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced \
        --model-parallel 2 --device cpu

Deterministic data (``synthetic.lm_batches`` from the start step), resume
from the newest checkpoint in ``--ckpt-dir``, async saves every
``--ckpt-every`` steps and at the end, gradient accumulation over
``--accum`` microbatches, optional int8 error-feedback gradient compression
(the error buffers start at zero on a resume, as in the reference),
cosine / WSD / constant schedules (minicpm-2b always trains with WSD).
Each block is recomputed in the backward pass, as in the reference
(``transformer.forward(remat=True)``). A resumed run gives the bits of an
uninterrupted one. ``--device`` defaults
to ``cuda`` and raises where there is none. ``main`` returns the final
loss.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.durable_io import host_tree
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import init_process_group, make_mesh_for
from repro_torch.models.registry import get_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import grad_compress as gc
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns the final loss (None when there was nothing to do)."""
    losses = run(parse_args(argv))
    return losses[-1] if losses else None


def run(args):
    """The training loop of ``main``; returns every step's loss run here,
    in order."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit("use examples/train_sru_speech.py for audio/sru")
    if args.schedule == "wsd" or cfg.name == "minicpm-2b":
        args.schedule = "wsd"          # MiniCPM trains with WSD
    dev = resolve_device(args.device)
    model = get_model(cfg, dev)
    ocfg = opt.AdamWConfig(lr=args.lr, schedule=args.schedule,
                           warmup_steps=max(args.steps // 20, 1),
                           total_steps=args.steps)
    import torch.distributed as dist
    if args.model_parallel == 1 and not dist.is_initialized() and \
            int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return _train(args, cfg, dev, model, ocfg, None, 0)
    made = init_process_group(dev)
    try:
        mesh = make_mesh_for(model_parallel=args.model_parallel,
                             device_type=dev.type)
        with sh.axis_rules(mesh):
            return _train(args, cfg, dev, model, ocfg, mesh, dist.get_rank())
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, cfg, dev, model, ocfg, mesh, rank):
    """The loop on ``mesh`` (None: plain tensors, no group)."""
    state = ts.init_train_state(model, 0)
    sshard = None
    if mesh is not None:
        sshard = sh.tree_shardings(mesh, ts.train_state_axes(model), state,
                                   ensure_model=True)
        state = sh.place_tree(state, sshard)
    base_step = ts.make_train_step(model, ocfg, accum_steps=args.accum)
    if args.compress_grads:
        def step(carry, batch):
            st, err = carry
            loss, grads = opt.value_and_grad(model.loss, st["params"], batch)
            grads, err = gc.compress_grads(grads, err)
            new_p, new_o, metrics = opt.adamw_update(
                ocfg, st["params"], grads, st["opt"])
            metrics["loss"] = loss
            metrics = {k: sh.full(v) for k, v in metrics.items()}
            return ({"params": new_p, "opt": new_o,
                     "step": st["step"] + 1}, err), metrics
    else:
        step = base_step

    start = 0
    saver = None
    if args.ckpt_dir:
        if rank == 0:
            saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
        if ckpt.latest_step(args.ckpt_dir) is not None:
            state, start = ckpt.restore(args.ckpt_dir, state,
                                        shardings=sshard)
            if rank == 0:
                print(f"[train] resumed from step {start}")
    carry = state
    if args.compress_grads:
        err = gc.init_error_state(state["params"])
        carry = (state, err if mesh is None else
                 sh.place_tree(err, sshard["params"]))

    def canonical(c):
        """The state back on its shardings: a step leaves some leaves
        with pending cross-shard sums, which a checkpoint would reduce;
        reducing them here keeps a resumed run on the same bits."""
        if mesh is None:
            return c
        if args.compress_grads:
            return (sh.place_tree(c[0], sshard),
                    sh.place_tree(c[1], sshard["params"]))
        return sh.place_tree(c, sshard)

    def save(step_no):
        # every rank gathers its shards; rank 0 writes
        snap = host_tree(carry[0] if args.compress_grads else carry)
        if saver:
            saver.save(step_no, snap, extra={"arch": cfg.name})

    bshard = None
    data = synthetic.lm_batches(cfg.vocab_size, args.batch, args.seq,
                                start_step=start, device=dev)
    metrics, saved, losses = None, None, []
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            batch = next(data)
            if cfg.family == "vlm":
                n_p = min(cfg.frontend_tokens, args.seq // 2)
                batch = {"tokens": batch["tokens"][:, n_p:],
                         "patch_embeds": torch.zeros(
                             (args.batch, n_p, cfg.d_model),
                             dtype=torch.bfloat16, device=dev),
                         "labels": batch["labels"][:, n_p:]}
            if mesh is not None:
                if bshard is None:
                    bshard = sh.tree_shardings(mesh, {
                        k: ("batch",) + (None,) * (v.ndim - 1)
                        for k, v in batch.items()}, batch)
                batch = sh.place_tree(batch, bshard)
            carry, metrics = step(carry, batch)
            carry = canonical(carry)
            losses.append(metrics["loss"])
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                dt = (time.time() - t0) / args.log_every
                loss = float(losses[-1])
                if rank == 0:
                    print(f"[train] step {i+1}/{args.steps} "
                          f"loss={loss:.4f} "
                          f"lr={float(metrics['lr']):.2e} "
                          f"{dt*1e3:.0f}ms/step", flush=True)
                t0 = time.time()
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save(i + 1)
                saved = i + 1
        if args.ckpt_dir and saved != args.steps:
            save(args.steps)
    finally:
        if saver:
            saver.wait()        # an interrupted run still finishes its save
    if saver:
        print(f"[train] checkpoints: {saver.saved_steps}")
    if metrics is None:
        if rank == 0:
            print(f"[train] nothing to do: at step {start} of {args.steps}")
        return []
    losses = [float(x) for x in losses]
    if rank == 0:
        print(f"[train] done, final loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
