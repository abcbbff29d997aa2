"""Model API: ``get_model(cfg)`` returns a ``Model`` with init, loss and
serving entry points.

Port of the reference package's ``models/registry.py`` for every family:
the LM family (dense, MoE, VLM and hybrid; ``models/transformer.py``), the
ssm family (the xLSTM, ``models/xlstm.py``) and the audio family (the
encoder-decoder, ``models/encdec.py``), with ``input_specs`` and
``make_dummy_batch``. The modality frontends (VLM patches, audio frames)
are stubs, as there: the batch carries precomputed embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer, xlstm


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

    return Model(
        cfg=cfg,
        init=lambda seed: xlstm.init_lm(seed, cfg, device),
        loss=loss,
        prefill=lambda params, batch: xlstm.prefill(params, cfg,
                                                    batch["tokens"]),
        decode=lambda params, cache, batch: xlstm.decode_step(
            params, cfg, cache, batch["token"]),
        init_cache=lambda batch, max_len: xlstm.init_state(
            cfg, batch, max_len, device),
    )


def _encdec_model(cfg: ArchConfig, device) -> Model:
    def loss(params, batch):
        logits = encdec.forward(params, cfg, batch["frames"],
                                batch["dec_tokens"])
        return cross_entropy(logits, batch["labels"])

    @torch.no_grad()
    def prefill_fn(params, batch):
        """Encode the prompt audio, prime the cache with its output, and
        decode one BOS (token 0) at position 0."""
        enc_out = encdec.encode(params, cfg, batch["frames"])
        B, Te = enc_out.shape[:2]
        cache = encdec.init_cache(cfg, B, batch["max_len"], Te,
                                  enc_out.device)
        cache["enc_out"] = enc_out
        bos = torch.zeros((B, 1), dtype=torch.int32, device=enc_out.device)
        return encdec.decode_step(params, cfg, cache, bos)

    return Model(
        cfg=cfg,
        init=lambda seed: encdec.init_lm(seed, cfg, device),
        loss=loss,
        prefill=prefill_fn,
        decode=lambda params, cache, batch: encdec.decode_step(
            params, cfg, cache, batch["token"]),
        init_cache=lambda batch, max_len: encdec.init_cache(
            cfg, batch, max_len, max_len, device),
    )


def get_model(cfg: ArchConfig, device="cuda") -> Model:
    if cfg.family in ("dense", "moe", "hybrid", "vlm"):
        return _lm_model(cfg, device)
    if cfg.family == "ssm":
        return _xlstm_model(cfg, device)
    if cfg.family == "audio":
        return _encdec_model(cfg, device)
    raise KeyError(cfg.family)


# -------------------------------------------------------------- input specs

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Every model input of the (arch, shape) cell as a meta tensor (shape
    and dtype, no storage). Tokens are int32, as in the reference. The
    audio family's prefill also names its cache length, ``max_len``, an
    int."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.family == "audio":
        frames = spec((B, S, cfg.frontend_dim), torch.bfloat16)
        if shape.kind == "train":
            return {"frames": frames, "dec_tokens": spec((B, S)),
                    "labels": spec((B, S))}
        if shape.kind == "prefill":
            return {"frames": frames, "max_len": S}
        return {"token": spec((B, 1))}

    if cfg.family == "vlm" and shape.kind == "train":
        n_p = min(cfg.frontend_tokens, S // 2)
        return {"tokens": spec((B, S - n_p)),
                "patch_embeds": spec((B, n_p, cfg.d_model), torch.bfloat16),
                "labels": spec((B, S - n_p))}
    if shape.kind == "train":
        return {"tokens": spec((B, S)), "labels": spec((B, S))}
    if shape.kind == "prefill":
        return {"tokens": spec((B, S))}
    return {"token": spec((B, 1))}


def make_dummy_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                     device="cuda") -> Dict[str, Any]:
    """A concrete batch matching ``input_specs``, drawn on ``device`` from
    a ``torch.Generator`` seeded with ``seed``: tokens uniform over the
    vocabulary, embeddings standard normal (the reference draws with
    ``jax.random``, so the values differ); ``max_len`` as it is."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    out: Dict[str, Any] = {}
    for k, s in input_specs(cfg, shape).items():
        if k == "max_len":
            out[k] = s
        elif s.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, s.shape, generator=g,
                                   dtype=torch.int32, device=dev)
        else:
            out[k] = torch.randn(s.shape, generator=g, dtype=torch.float32,
                                 device=dev).to(s.dtype)
    return out
