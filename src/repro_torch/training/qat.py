"""Binary-connect QAT for beacon retraining (paper §4.3), in PyTorch.

Port of ``retrain_sru`` from the reference package's ``training/qat.py``.
Quantized weights are used in the forward and backward passes (STE), and
the update applies to the full-precision master copy, so the retrained
floating-point parameters can serve any neighbouring quantization
configuration: that is what makes them usable as a *beacon*.
"""
from __future__ import annotations

from typing import Iterator

import torch

from repro_torch.core.mohaq import Alloc
from repro_torch.models import sru
from repro_torch.training import optimizer as opt


def frame_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-probability of the gold label over every frame,
    from a float32 log-softmax."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[..., None]))


def retrain_sru(params, cfg, alloc: Alloc, batches: Iterator[dict], *,
                steps: int = 60, lr: float = 3e-4, act_ranges=None,
                wclips=None):
    """Retrain the SRU model under the quantization config ``alloc`` for
    ``steps`` AdamW steps (constant rate after 5 warm-up steps, no weight
    decay, gradients clipped at norm 1) on successive ``batches``. Returns
    new full-precision params (the beacon)."""
    ocfg = opt.AdamWConfig(lr=lr, schedule="constant", warmup_steps=5,
                           weight_decay=0.0, total_steps=steps)
    opt_state = opt.init_opt_state(params)

    def loss_fn(p, feats, labels):
        return frame_nll(sru.forward_train(p, cfg, feats, qspec=alloc,
                                           wclips=wclips,
                                           act_ranges=act_ranges), labels)

    for _ in range(steps):
        batch = next(batches)
        params, opt_state, _ = opt.adamw_step(ocfg, loss_fn, params,
                                              opt_state, batch["feats"],
                                              batch["labels"])
    return params
