"""Decoder-only LM (dense, MoE, VLM and hybrid families): init, forward,
prefill and decode with a KV cache.

Port of the reference package's ``models/transformer.py``. Layers are
stacked on a leading axis, as in the reference's params (``params["blocks"]["attn"]["wq"]`` is (L, D, H, hd),
``params["blocks"]["ffn"]["w_gate"]`` of an MoE is (L, E, D, F)), so
``params_from_numpy`` carries its weights across unchanged; a Python loop
over the stack takes the place of ``lax.scan``, and ``layer(blocks, i)``
reads one layer (a tree that dequantizes one layer at a time, such as
``core/quantization.py::DequantizedByLayer``, gives its own). Serving
keeps a stacked KV cache, (L, B, max_len, KV, hd), in ``KV_CACHE_DTYPE``
(bf16, or int8 at the fixed scale ``KV_CACHE_SCALE``), which
``decode_step`` updates in place (the reference returns a new one).
``head_fn(hidden) -> logits`` replaces the dense output head, e.g. with
the quantized head of ``serving/lm.py``.

The hybrid (Jamba) family groups its layers by ``cfg.attn_period`` = P:
each of the G = L / P groups runs P - 1 Mamba blocks (``models/mamba.py``)
and then one attention block, every block with its MLP or MoE FFN. Its
params keep the reference's stacks, ``params["mamba_blocks"]`` (G, P - 1,
...) and ``params["attn_blocks"]`` (G, ...) (``mamba_layer(blocks, g, j)``
reads one Mamba block), and its cache adds the Mamba states, ``ssm``:
``h`` (G, P - 1, B, d_inner, N) f32 and ``conv`` (G, P - 1, B, K - 1,
d_inner) bf16.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import mamba as mb

Params = Dict[str, Any]

# The KV cache's storage dtype (read when a cache is made), and the fixed
# symmetric scale of an int8 cache: the reference's decode lever, which
# halves the cache's bytes.
KV_CACHE_DTYPE = torch.bfloat16
KV_CACHE_SCALE = 1.0 / 16.0


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "hybrid"):
        raise ValueError(f"{cfg.name}: the {cfg.family} family is not a "
                         f"decoder-only LM (see models/registry.py)")


def _groups(cfg: ArchConfig):
    """The hybrid's (G, P): groups and layers a group."""
    return cfg.n_layers // cfg.attn_period, cfg.attn_period


def _cache_store(val, cache_dtype):
    """``val`` as the cache stores it: int8 codes at ``KV_CACHE_SCALE``
    (the scale is a power of two, so dividing by it is exact), else a
    cast."""
    if cache_dtype == torch.int8:
        return torch.clamp(torch.round(val.to(torch.float32) / KV_CACHE_SCALE),
                           -128, 127).to(torch.int8)
    return val.to(cache_dtype)


def _cache_load(val, like_dtype):
    if val.dtype == torch.int8:
        return (val.to(torch.float32) * KV_CACHE_SCALE).to(like_dtype)
    return val


# ------------------------------------------------------------------ blocks

def init_block(generator, cfg: ArchConfig, layers, kind: str = "attn"
               ) -> Params:
    """Stacked blocks (``layers``: their count, or the stack's shape): norms,
    the mixer (``kind`` "attn": attention; "mamba": a Mamba mixer), and an
    MLP or (``cfg.n_experts``) an MoE FFN."""
    st = (layers,) if isinstance(layers, int) else tuple(layers)
    ones = torch.ones(st + (cfg.d_model,), dtype=torch.float32,
                      device=generator.device)
    p = {"norm1": ones, "norm2": ones.clone()}
    if kind == "attn":
        p["attn"] = cm.init_attn(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, stack=st)
    elif kind == "mamba":
        p["mamba"] = mb.init_mamba(generator, cfg, stack=st)
    else:
        raise ValueError(kind)
    if cfg.n_experts:
        p["ffn"] = cm.init_moe(generator, cfg.d_model, cfg.moe_ff,
                               cfg.n_experts, cfg.n_shared_experts, stack=st)
    else:
        p["ffn"] = cm.init_mlp(generator, cfg.d_model, cfg.d_ff, stack=st)
    return p


def init_block_by_layer(generator, cfg: ArchConfig, stack, kind: str
                        ) -> Params:
    """``init_block`` over the stack ``stack``, drawn one layer at a time
    into tensors allocated once: ``normal_init`` draws f32 and casts, so a
    stacked draw would hold the whole stack's f32 copy (22.5 GB for
    jamba's 7 Mamba layers of experts at full width), this one a layer's."""
    stack = tuple(stack)
    out = None
    for idx in itertools.product(*map(range, stack)):
        one = init_block(generator, cfg, (), kind)
        if out is None:
            out = cm.tree_map(lambda t: torch.empty(
                stack + tuple(t.shape), dtype=t.dtype, device=t.device), one)
        _write_at(out, one, idx)
        del one
    return out


def _write_at(dst, src, idx) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _write_at(dst[k], v, idx)
        else:
            dst[k][idx].copy_(v)


def layer(blocks, i: int) -> Params:
    """Layer ``i``'s params: views into the stacked tensors, or what
    ``blocks.layer(i)`` gives where the stack provides it."""
    if hasattr(blocks, "layer"):
        return blocks.layer(i)
    return cm.tree_map(lambda t: t[i], blocks)


def mamba_layer(blocks, g: int, j: int) -> Params:
    """The hybrid's Mamba block ``j`` of group ``g`` (``blocks``:
    ``params["mamba_blocks"]``, stacked (G, P - 1, ...))."""
    return cm.tree_map(lambda t: t[g, j], blocks)


def apply_ffn(p, cfg: ArchConfig, x):
    if cfg.n_experts:
        return cm.moe_ffn(p, x, top_k=cfg.top_k)
    return cm.mlp(p, x)


def attn_block_fwd(p, cfg: ArchConfig, x, positions, kv=None):
    """One block over a whole sequence. ``kv`` (optional): a dict that
    receives the block's rotated k and its v, for the prefill cache."""
    h = cm.rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = cm.attn_qkv(p["attn"], h, positions, cfg.rope_theta)
    if kv is not None:
        kv["k"], kv["v"] = k, v
    o = cm.gqa_attention(q, k, v, causal=True)
    x = x + cm.attn_out(p["attn"], o)
    h = cm.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + apply_ffn(p["ffn"], cfg, h)


def run_block(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, only the inputs are kept and the block
    is recomputed in the backward pass (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), which changes no value."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def mamba_block_fwd(p, cfg: ArchConfig, x, state=None):
    """One hybrid Mamba block over a whole sequence: norm, Mamba, residual,
    norm, FFN, residual. ``state`` (optional): a dict that receives the
    Mamba's decode state after the last step, for the prefill cache."""
    h = cm.rms_norm(x, p["norm1"], cfg.norm_eps)
    if state is None:
        x = x + mb.mamba_fwd(p["mamba"], cfg, h)
    else:
        y, st = mb.mamba_fwd(p["mamba"], cfg, h, return_state=True)
        state.update(st)
        x = x + y
    h = cm.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + apply_ffn(p["ffn"], cfg, h)


def mamba_block_decode(p, cfg: ArchConfig, x, ssm_h, ssm_conv):
    """x: (B, 1, D); ssm_h (B, di, N) and ssm_conv (B, K - 1, di): this
    block's Mamba state, updated in place."""
    h = cm.rms_norm(x, p["norm1"], cfg.norm_eps)
    y, st = mb.mamba_step(p["mamba"], cfg, h, {"h": ssm_h, "conv": ssm_conv})
    ssm_h.copy_(st["h"])
    ssm_conv.copy_(st["conv"])
    x = x + y
    h = cm.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + apply_ffn(p["ffn"], cfg, h)


def attn_block_decode(p, cfg: ArchConfig, x, cache_k, cache_v, cur: int):
    """x: (B, 1, D); cache_k/v: this layer's (B, S, KV, hd), updated in place
    at position ``cur``. Attends over the whole cache with the first
    ``cur + 1`` rows valid, as the reference does."""
    h = cm.rms_norm(x, p["norm1"], cfg.norm_eps)
    pos = torch.full((x.shape[0], 1), cur, dtype=torch.int32, device=x.device)
    q, k, v = cm.attn_qkv(p["attn"], h, pos, cfg.rope_theta)
    cache_k[:, cur:cur + 1] = _cache_store(k, cache_k.dtype)
    cache_v[:, cur:cur + 1] = _cache_store(v, cache_v.dtype)
    o = cm.gqa_attention(q, _cache_load(cache_k, q.dtype),
                         _cache_load(cache_v, q.dtype), q_offset=cur,
                         kv_valid=cur + 1, chunk_q=1 << 30, chunk_k=1 << 30)
    x = x + cm.attn_out(p["attn"], o)
    h = cm.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + apply_ffn(p["ffn"], cfg, h)


# ------------------------------------------------------------------ stacks

def init_lm(seed: int, cfg: ArchConfig, device="cuda") -> Params:
    """Random params in the reference layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (on the card, so
    that the 1.6 B parameters of stablelm-1.6b take seconds, not a host
    ``randn`` of minutes). The values differ from the reference's
    ``init_lm`` (threefry draws), and a seed gives other values on the CPU
    than on a card. The hybrid's stacks are drawn a layer at a time
    (``init_block_by_layer``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    D, V = cfg.d_model, cfg.padded_vocab
    p: Params = {"embed": cm.normal_init(g, (V, D), 1.0 / math.sqrt(D)),
                 "final_norm": torch.ones((D,), dtype=torch.float32,
                                          device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.normal_init(g, (D, V), 1.0 / math.sqrt(D))
    if cfg.family == "hybrid":
        G, P = _groups(cfg)
        p["mamba_blocks"] = init_block_by_layer(g, cfg, (G, P - 1), "mamba")
        p["attn_blocks"] = init_block_by_layer(g, cfg, (G,), "attn")
    else:
        p["blocks"] = init_block(g, cfg, cfg.n_layers)
    return p


def params_from_numpy(tree, device="cuda") -> Params:
    """The reference's param pytree as nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``; bf16 leaves are
    ``ml_dtypes.bfloat16``) as the port's tensors, bitwise."""
    dev = resolve_device(device)
    return cm.tree_map(lambda a: cm.tensor_from_numpy(a, dev), tree)


def params_to_numpy(tree) -> Dict:
    """Inverse of ``params_from_numpy``."""
    return cm.tree_map(cm.tensor_to_numpy, tree)


def embed_tokens(p, cfg: ArchConfig, tokens, extra_embeds=None):
    x = p["embed"][tokens].to(torch.bfloat16)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def logits_head_weight(p, cfg: ArchConfig):
    """The (D, V) output-head weight (the embedding's transpose if tied)."""
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


def logits_head(p, cfg: ArchConfig, x):
    """The dense head: f32 logits of the bf16 hidden state, cast to bf16."""
    w = logits_head_weight(p, cfg)
    logits = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return logits.to(torch.bfloat16)


def forward(params, cfg: ArchConfig, tokens, extra_embeds=None,
            remat: bool = True):
    """Full forward, differentiable (the training loss runs it). tokens:
    (B, T) integer. Returns (B, T_total, V) bf16 logits. ``remat`` (the
    reference's default): under autograd, keep only each block's input and
    recompute the block in the backward pass (``torch.utils.checkpoint``;
    the reference's ``jax.checkpoint``), which changes no value."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = remat and torch.is_grad_enabled()
    if cfg.family == "hybrid":
        G, P = _groups(cfg)
        for g in range(G):
            for j in range(P - 1):
                x = run_block(remat, mamba_block_fwd,
                              mamba_layer(params["mamba_blocks"], g, j), cfg,
                              x)
            x = run_block(remat, attn_block_fwd,
                          layer(params["attn_blocks"], g), cfg, x, positions)
    else:
        for i in range(cfg.n_layers):
            x = run_block(remat, attn_block_fwd, layer(params["blocks"], i),
                          cfg, x, positions)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(params, cfg, x)


# ------------------------------------------------------------------ serving

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    _check_family(cfg)
    dev = resolve_device(device)
    hybrid = cfg.family == "hybrid"
    G, P = _groups(cfg) if hybrid else (cfg.n_layers, 1)
    shape = (G, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"attn": {"k": torch.zeros(shape, dtype=KV_CACHE_DTYPE,
                                       device=dev),
                      "v": torch.zeros(shape, dtype=KV_CACHE_DTYPE,
                                       device=dev)},
             "cur": 0}
    if hybrid:          # every attention layer's KV; every Mamba's state
        di = cfg.ssm_d_inner
        cache["ssm"] = {
            "h": torch.zeros((G, P - 1, batch, di, cfg.ssm_d_state),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros((G, P - 1, batch, cfg.ssm_d_conv - 1, di),
                                dtype=torch.bfloat16, device=dev)}
    return cache


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, cache, token, head_fn=None):
    """One decode step. token: (B, 1) integer. Returns (logits, cache): the
    cache's tensors are updated in place and ``cur`` advances by one.

    ``head_fn(hidden) -> logits`` overrides the dense output head."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, token)
    cur = int(cache["cur"])
    if cur >= cache["attn"]["k"].shape[2]:
        raise ValueError(f"KV cache full: position {cur} of "
                         f"{cache['attn']['k'].shape[2]}")
    kc, vc = cache["attn"]["k"], cache["attn"]["v"]
    if cfg.family == "hybrid":
        G, P = _groups(cfg)
        ssm = cache["ssm"]
        for g in range(G):
            for j in range(P - 1):
                x = mamba_block_decode(
                    mamba_layer(params["mamba_blocks"], g, j), cfg, x,
                    ssm["h"][g, j], ssm["conv"][g, j])
            x = attn_block_decode(layer(params["attn_blocks"], g), cfg, x,
                                  kc[g], vc[g], cur)
    else:
        for i in range(cfg.n_layers):
            x = attn_block_decode(layer(params["blocks"], i), cfg, x, kc[i],
                                  vc[i], cur)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_fn(x) if head_fn is not None else logits_head(params, cfg, x)
    return logits, {**cache, "cur": cur + 1}


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens, max_len: Optional[int] = None,
            head_fn=None):
    """Run the whole prompt and build a cache of ``max_len`` positions.
    Returns (last-position logits (B, 1, V), cache). Each block's k and v
    are stored as its forward computes them (the reference recomputes them
    in its scan; the values are the same)."""
    _check_family(cfg)
    B, T = tokens.shape
    max_len = max_len or T
    x = embed_tokens(params, cfg, tokens)
    cache = init_cache(cfg, B, max_len, x.device)
    positions = torch.arange(T, device=x.device)[None, :]

    def attn(bp, i, x):
        kv: Dict[str, torch.Tensor] = {}
        x = attn_block_fwd(bp, cfg, x, positions, kv)
        for name in ("k", "v"):
            c = cache["attn"][name]
            c[i, :, :T] = _cache_store(kv[name], c.dtype)
        return x

    if cfg.family == "hybrid":
        G, P = _groups(cfg)
        for g in range(G):
            for j in range(P - 1):
                st: Dict[str, torch.Tensor] = {}
                x = mamba_block_fwd(mamba_layer(params["mamba_blocks"], g, j),
                                    cfg, x, st)
                for name in ("h", "conv"):
                    cache["ssm"][name][g, j] = st[name]
            x = attn(layer(params["attn_blocks"], g), g, x)
    else:
        for i in range(cfg.n_layers):
            x = attn(layer(params["blocks"], i), i, x)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[:, -1:]
    logits = head_fn(last) if head_fn is not None \
        else logits_head(params, cfg, last)
    cache["cur"] = T
    return logits, cache
