"""Binary-connect QAT for beacon retraining (paper §4.3), in PyTorch.

Port of ``retrain_sru`` and ``retrain_xlstm`` from the reference
package's ``training/qat.py``. Quantized weights are used in the forward and backward passes (STE), and
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


def retrain_xlstm(params, cfg, alloc: Alloc, batches: Iterator[dict], *,
                  steps: int = 60, lr: float = 1e-3, act_ranges=None,
                  wclips=None):
    """Binary-connect retrain of the registry xLSTM under ``alloc``, the
    recipe of ``retrain_sru`` through the xLSTM target's quantization
    hooks: the forward sees ``ste_quantize_weight`` of the live
    full-precision leaves and STE fake-quantized block inputs, and AdamW
    (constant rate after 5 warm-up steps, no weight decay) updates the
    full-precision copy. ``wclips``: the clip of every sub-16-bit layer;
    ``act_ranges``: the target's calibrated ranges (host floats, so the
    grids are Python floats as in the reference). ``batches`` yield
    ``{"tokens": (B, T + 1)}``; inputs and labels are the shift pair.
    Returns new full-precision params (the beacon)."""
    from repro_torch.core import quantization as Q
    from repro_torch.core import xlstm_target as XT

    wclips = wclips or {}
    act_ranges = act_ranges or {}
    ocfg = opt.AdamWConfig(lr=lr, schedule="constant", warmup_steps=5,
                           weight_decay=0.0, total_steps=steps)
    opt_state = opt.init_opt_state(params)
    wq = {n: (int(alloc[n][0]), float(wclips.get(n, 0.0))) for n in alloc}
    aq = {n: (int(alloc[n][1]), float(act_ranges[n])) for n in alloc}

    def loss_fn(p, toks, labels):
        def get_w(name):
            bits, clip = wq[name]
            return {k: Q.ste_quantize_weight(w, bits, clip)
                    for k, w in XT._layer_leaves(p, cfg, name).items()}

        def q_act(name, x):
            bits, rng = aq[name]
            return Q.quantize_activation(x, bits, rng)

        return frame_nll(XT.forward(p, cfg, toks, get_w, q_act), labels)

    for _ in range(steps):
        toks = next(batches)["tokens"]
        params, opt_state, _ = opt.adamw_step(
            ocfg, loss_fn, params, opt_state, toks[:, :-1], toks[:, 1:])
    return params
