"""Encoder-decoder transformer (the audio family, seamless-m4t-medium).

Port of the reference package's ``models/encdec.py``. The audio frontend
is a stub, as there: the encoder reads precomputed frame embeddings (B,
T_enc, D). The encoder is a bidirectional self-attention stack; each
decoder block runs causal self-attention, cross-attention over the
encoder's output (its keys and values projected by ``xattn.wk`` / ``wv``
with no RoPE) and an MLP. Params keep the reference's layout (``enc``
(L, ...) and ``dec`` (L_dec, ...) stacks), so
``transformer.params_from_numpy`` carries its weights across.

Serving: ``init_cache`` holds the decoder's self-attention KV cache and
the encoder's output; ``decode_step`` updates the cache in place and, as
the reference does, recomputes every layer's cross K/V from the cached
``enc_out`` at each step.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

Params = Dict


def _ones(st, D, dev):
    return torch.ones(st + (D,), dtype=torch.float32, device=dev)


def init_enc_block(generator, cfg, stack=()) -> Params:
    st, dev = tuple(stack), generator.device
    return {"norm1": _ones(st, cfg.d_model, dev),
            "attn": cm.init_attn(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, stack=st),
            "norm2": _ones(st, cfg.d_model, dev),
            "ffn": cm.init_mlp(generator, cfg.d_model, cfg.d_ff, stack=st)}


def init_dec_block(generator, cfg, stack=()) -> Params:
    st, dev = tuple(stack), generator.device
    return {"norm1": _ones(st, cfg.d_model, dev),
            "attn": cm.init_attn(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, stack=st),
            "norm_x": _ones(st, cfg.d_model, dev),
            "xattn": cm.init_attn(generator, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.head_dim, stack=st),
            "norm2": _ones(st, cfg.d_model, dev),
            "ffn": cm.init_mlp(generator, cfg.d_model, cfg.d_ff, stack=st)}


def init_lm(seed: int, cfg, device="cuda") -> Params:
    """Random params in the reference layout, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (the values differ from the
    reference's ``init_lm``; tests carry its weights across instead)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    D, V = cfg.d_model, cfg.padded_vocab
    return {
        "embed": cm.normal_init(g, (V, D), 1.0 / math.sqrt(D)),
        "enc": init_enc_block(g, cfg, (cfg.n_layers,)),
        "dec": init_dec_block(g, cfg, (cfg.n_dec_layers,)),
        "enc_norm": _ones((), D, dev),
        "final_norm": _ones((), D, dev),
        "lm_head": cm.normal_init(g, (D, V), 1.0 / math.sqrt(D)),
    }


def _enc_block(bp, cfg, h, positions):
    hn = cm.rms_norm(h, bp["norm1"], cfg.norm_eps)
    q, k, v = cm.attn_qkv(bp["attn"], hn, positions, cfg.rope_theta)
    o = cm.gqa_attention(q, k, v, causal=False)
    h = h + cm.attn_out(bp["attn"], o)
    hn = cm.rms_norm(h, bp["norm2"], cfg.norm_eps)
    return h + cm.mlp(bp["ffn"], hn)


def encode(params, cfg, frames):
    """frames: (B, T_enc, D) stub audio embeddings -> the encoder's output
    (B, T_enc, D) bf16. Every block is recomputed in the backward pass, as
    in the reference."""
    x = frames.to(torch.bfloat16)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x = tfm.run_block(torch.is_grad_enabled(), _enc_block,
                          tfm.layer(params["enc"], i), cfg, x, positions)
    return cm.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(bp, cfg, h, enc_out, positions, self_k=None, self_v=None,
               cur: int = 0):
    """One decoder block. Over a whole sequence (``self_k`` None) the
    self-attention is causal over ``positions``; in decode (h: (B, 1, D))
    the step's k and v are written into ``self_k`` / ``self_v`` (this
    layer's (B, S, KV, hd) cache) at ``cur`` and the query attends over the
    first ``cur + 1`` rows."""
    hn = cm.rms_norm(h, bp["norm1"], cfg.norm_eps)
    if self_k is None:
        q, k, v = cm.attn_qkv(bp["attn"], hn, positions, cfg.rope_theta)
        o = cm.gqa_attention(q, k, v, causal=True)
    else:
        pos = torch.full((h.shape[0], 1), cur, dtype=torch.int32,
                         device=h.device)
        q, k, v = cm.attn_qkv(bp["attn"], hn, pos, cfg.rope_theta)
        self_k[:, cur:cur + 1] = k.to(self_k.dtype)
        self_v[:, cur:cur + 1] = v.to(self_v.dtype)
        o = cm.gqa_attention(q, self_k, self_v, q_offset=cur,
                             kv_valid=cur + 1, chunk_q=1 << 30,
                             chunk_k=1 << 30)
    h = h + cm.attn_out(bp["attn"], o)
    # cross attention: no RoPE
    hn = cm.rms_norm(h, bp["norm_x"], cfg.norm_eps)
    qx = cm._proj_heads(hn, bp["xattn"]["wq"])
    kx = cm._proj_heads(enc_out, bp["xattn"]["wk"])
    vx = cm._proj_heads(enc_out, bp["xattn"]["wv"])
    ox = cm.gqa_attention(qx, kx, vx, causal=False)
    h = h + cm.attn_out(bp["xattn"], ox)
    hn = cm.rms_norm(h, bp["norm2"], cfg.norm_eps)
    return h + cm.mlp(bp["ffn"], hn)


def forward(params, cfg, frames, dec_tokens, remat: bool = True):
    """Training: encode the frames, decode the tokens teacher-forced.
    Returns the decoder's (B, T_dec, V) bf16 logits."""
    enc_out = encode(params, cfg, frames)
    x = tfm.embed_tokens(params, cfg, dec_tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = remat and torch.is_grad_enabled()
    for i in range(cfg.n_dec_layers):
        x = tfm.run_block(remat, _dec_block, tfm.layer(params["dec"], i),
                          cfg, x, enc_out, positions)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.logits_head(params, cfg, x)


def init_cache(cfg, batch: int, max_len: int, enc_len: int, device="cuda"):
    dev = resolve_device(device)
    shape = (cfg.n_dec_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"self": {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=dev),
                     "v": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=dev)},
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                   dtype=torch.bfloat16, device=dev),
            "cur": 0}


@torch.no_grad()
def decode_step(params, cfg, cache, token):
    """One decode step. token: (B, 1) integer. Returns (logits (B, 1, V),
    cache): the self-attention cache is updated in place and ``cur``
    advances by one."""
    x = tfm.embed_tokens(params, cfg, token)
    cur = int(cache["cur"])
    kc, vc = cache["self"]["k"], cache["self"]["v"]
    if cur >= kc.shape[2]:
        raise ValueError(f"KV cache full: position {cur} of {kc.shape[2]}")
    for i in range(cfg.n_dec_layers):
        x = _dec_block(tfm.layer(params["dec"], i), cfg, x, cache["enc_out"],
                       None, kc[i], vc[i], cur)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.logits_head(params, cfg, x), {**cache, "cur": cur + 1}
