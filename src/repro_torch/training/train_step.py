"""Train and serve steps of the LM trainer (``launch/train.py``).

Port of the reference package's ``training/train_step.py``. The train
state is a plain dict: ``{"params", "opt", "step"}``; a step takes the loss
and its gradient (``optimizer.value_and_grad``) and applies
``optimizer.adamw_update``. With ``accum_steps > 1`` the batch splits into
that many microbatches along its first axis; their losses and float32
gradients are summed in order and divided by ``accum_steps``, as the
reference's scan does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.registry import Model
from repro_torch.training import optimizer as opt


def init_train_state(model: Model, seed: int = 0):
    params = model.init(seed)
    leaf = opt.tree_leaves(params)[0]
    return {"params": params, "opt": opt.init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def make_train_step(model: Model, ocfg: opt.AdamWConfig,
                    accum_steps: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``; metrics hold the
    loss, the gradient norm and the learning rate."""

    def step(state, batch):
        params = state["params"]
        if accum_steps > 1:
            loss, grads = None, None
            for j in range(accum_steps):
                mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + tuple(v.shape[1:]))[j]
                      for k, v in batch.items()}
                l, g = opt.value_and_grad(model.loss, params, mb)
                g = opt.tree_leaves(g)
                if grads is None:
                    loss = l
                    grads = [x.to(torch.float32) for x in g]
                else:
                    loss = loss + l
                    grads = [a + b for a, b in zip(grads, g)]
            n = torch.tensor(accum_steps, dtype=torch.float32,
                             device=loss.device)
            loss = loss / n
            grads = opt.tree_unflatten(params, [g / n for g in grads])
        else:
            loss, grads = opt.value_and_grad(model.loss, params, batch)
        new_params, new_opt, metrics = opt.adamw_update(
            ocfg, params, grads, state["opt"])
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return step


def make_serve_decode(model: Model):
    def step(params, cache, batch):
        return model.decode(params, cache, batch)
    return step


def make_serve_prefill(model: Model, static_kwargs: Optional[dict] = None):
    static_kwargs = static_kwargs or {}

    def step(params, batch):
        return model.prefill(params, {**batch, **static_kwargs})
    return step
