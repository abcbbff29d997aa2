"""AdamW and its learning-rate schedules (constant, cosine, WSD), in
PyTorch.

Port of the reference package's ``training/optimizer.py``: plain functions
over a nested dict of float32 tensors. Leaves are visited in sorted-key
order, the order of ``jax.tree.leaves``, so the global gradient norm sums
in the reference's order. Every division by a host constant divides by a
float32 tensor on the operand's device: a CUDA division by a Python scalar
multiplies by its reciprocal instead, which can round differently.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    decay_frac: float = 0.1           # WSD: last 10% decays


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor, counted from 1 by
    ``adamw_update``), as a float32 tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM): stable plateau, then 1-sqrt decay
        decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
        frac = torch.clamp(
            (step - decay_start)
            / _f32(max(cfg.total_steps - decay_start, 1), step), 0.0, 1.0)
        return cfg.lr * warm * (1.0 - (1.0 - 0.1) * torch.sqrt(frac))
    # cosine
    frac = torch.clamp(step / _f32(cfg.total_steps, step), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> Dict:
    """A nested dict shaped like ``like`` holding ``leaves`` in
    ``tree_leaves`` order."""
    return _build(like, iter(leaves))


def _build(node, it):
    # module level, not a closure: a recursive closure is a reference cycle
    # that would hold ``leaves`` (whole param and optimizer trees on the
    # card) until the garbage collector runs
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def init_opt_state(params) -> Dict:
    def zeros(tree):
        return tree_unflatten(tree, [torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device)
                                     for p in tree_leaves(tree)])
    leaf = tree_leaves(params)[0]
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def opt_state_axes(param_axes):
    return {"m": param_axes, "v": param_axes, "count": ()}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (new_params, new_opt_state, metrics). The count is
    incremented before the rate is read; weight decay applies only to
    leaves with ``ndim >= 2``."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(_f32(cfg.grad_clip, gnorm)
                         / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = schedule_lr(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        pf = p.to(torch.float32)
        return (pf - lr * (step + decay * pf)).to(p.dtype), m_new, v_new

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}


def value_and_grad(loss_fn: Callable, params, *args
                   ) -> Tuple[torch.Tensor, Dict]:
    """``loss_fn(params, *args)`` and its gradient with respect to every
    leaf of ``params``, as a tree shaped like ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def adamw_step(cfg: AdamWConfig, loss_fn: Callable, params, opt_state, *args):
    """One step: the loss and its gradient, then ``adamw_update``. Returns
    (new_params, new_opt_state, loss)."""
    loss, grads = value_and_grad(loss_fn, params, *args)
    new_p, new_o, _ = adamw_update(cfg, params, grads, opt_state)
    return new_p, new_o, loss
