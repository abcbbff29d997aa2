"""The LM trainer: train a config of ``configs/`` on the bigram token task.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 200 --batch 8 --seq 64 --ckpt-dir ckpt --device cpu

Port of the reference package's ``launch/train.py`` for one device (no
mesh; ``--model-parallel`` waits for ROADMAP.md queue 1, item 9).
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
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
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
    state = ts.init_train_state(model, 0)
    base_step = ts.make_train_step(model, ocfg, accum_steps=args.accum)
    if args.compress_grads:
        def step(carry, batch):
            st, err = carry
            loss, grads = opt.value_and_grad(model.loss, st["params"], batch)
            grads, err = gc.compress_grads(grads, err)
            new_p, new_o, metrics = opt.adamw_update(
                ocfg, st["params"], grads, st["opt"])
            metrics["loss"] = loss
            return ({"params": new_p, "opt": new_o,
                     "step": st["step"] + 1}, err), metrics
    else:
        step = base_step

    start = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
        if ckpt.latest_step(args.ckpt_dir) is not None:
            state, start = ckpt.restore(args.ckpt_dir, state)
            print(f"[train] resumed from step {start}")
    carry = ((state, gc.init_error_state(state["params"]))
             if args.compress_grads else state)

    def train_state():
        return carry[0] if args.compress_grads else carry

    data = synthetic.lm_batches(cfg.vocab_size, args.batch, args.seq,
                                start_step=start, device=dev)
    metrics, saved = None, None
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
            carry, metrics = step(carry, batch)
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                loss = float(metrics["loss"])
                dt = (time.time() - t0) / args.log_every
                print(f"[train] step {i+1}/{args.steps} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms/step",
                      flush=True)
                t0 = time.time()
            if saver and (i + 1) % args.ckpt_every == 0:
                saver.save(i + 1, train_state(), extra={"arch": cfg.name})
                saved = i + 1
        if saver and saved != args.steps:
            saver.save(args.steps, train_state(), extra={"arch": cfg.name})
    finally:
        if saver:
            saver.wait()        # an interrupted run still finishes its save
    if saver:
        print(f"[train] checkpoints: {saver.saved_steps}")
    if metrics is None:
        print(f"[train] nothing to do: at step {start} of {args.steps}")
        return None
    final_loss = float(metrics["loss"])
    print(f"[train] done, final loss {final_loss:.4f}")
    return final_loss


if __name__ == "__main__":
    main()
