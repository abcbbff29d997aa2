"""Model API: ``get_model(cfg)`` returns a ``Model`` with init, loss and
serving entry points.

Port of the reference package's ``models/registry.py`` for the LM family
and the ssm family (the xLSTM, ``models/xlstm.py``; its ``Model`` has no
serving entry points yet). The encoder-decoder family waits for ROADMAP.md
queue 1, item 10; ``get_model`` raises ``NotImplementedError`` for it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer, xlstm


def cross_entropy(logits, labels, ignore: int = -1):
    """Mean cross-entropy over valid positions; logits (B, T, V) bf16, f32
    math, as the reference computes it."""
    lmax = torch.max(logits, dim=-1, keepdim=True).values.detach()
    shifted = (logits - lmax).to(torch.float32)
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    gold = torch.gather(shifted, -1, labels.clamp_min(0)[..., None].long())[..., 0]
    valid = (labels != ignore).to(torch.float32)
    return torch.sum((lse - gold) * valid) / torch.clamp(valid.sum(), min=1.0)


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[[int], Any]                          # seed -> params
    loss: Callable[[Any, Dict[str, Any]], Any]          # (params, batch) -> scalar
    prefill: Optional[Callable] = None                  # (params, batch) -> (logits, cache)
    decode: Optional[Callable] = None                   # (params, cache, batch) -> (logits, cache)
    init_cache: Optional[Callable] = None               # (batch, max_len) -> cache


def _lm_model(cfg: ArchConfig, device) -> Model:
    def loss(params, batch):
        extra = batch.get("patch_embeds")
        logits = transformer.forward(params, cfg, batch["tokens"], extra)
        if extra is not None:
            logits = logits[:, extra.shape[1]:]
        return cross_entropy(logits, batch["labels"])

    def prefill_fn(params, batch):
        return transformer.prefill(params, cfg, batch["tokens"],
                                   max_len=batch.get("max_len"))

    def decode_fn(params, cache, batch):
        return transformer.decode_step(params, cfg, cache, batch["token"])

    return Model(
        cfg=cfg,
        init=lambda seed: transformer.init_lm(seed, cfg, device),
        loss=loss,
        prefill=prefill_fn,
        decode=decode_fn,
        init_cache=lambda batch, max_len: transformer.init_cache(
            cfg, batch, max_len, device),
    )


def _xlstm_model(cfg: ArchConfig, device) -> Model:
    def loss(params, batch):
        logits = xlstm.forward(params, cfg, batch["tokens"])
        return cross_entropy(logits, batch["labels"])

    return Model(cfg=cfg, init=lambda seed: xlstm.init_lm(seed, cfg, device),
                 loss=loss)


def get_model(cfg: ArchConfig, device="cuda") -> Model:
    if cfg.family in ("dense", "moe", "hybrid", "vlm"):
        return _lm_model(cfg, device)   # moe/hybrid raise in transformer
    if cfg.family == "ssm":
        return _xlstm_model(cfg, device)
    if cfg.family == "audio":
        raise NotImplementedError("the audio family is not ported "
                                  "(ROADMAP.md queue 1, item 10)")
    raise KeyError(cfg.family)
