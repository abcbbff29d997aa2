"""Shared language-model primitives: RMSNorm, RoPE, dense GQA attention,
the gated MLP.

Port of the dense parts of the reference package's ``models/common.py``.
Params are nested dicts of tensors in the reference's layout (heads kept as
their own axis: ``wq`` (D, H, hd), ``wo`` (H, hd, D)), and activations stay
bf16 between layers, as there. The reference's matmuls take
``preferred_element_type=float32``:

- where it casts the f32 product back to bf16 (``dense``, ``attn_qkv``,
  ``attn_out``) the port runs a bf16 matmul, which accumulates in f32 and
  rounds once;
- where it keeps the f32 product (attention scores and the PV product) the
  port upcasts the bf16 inputs to f32: bf16 products are exact in f32, so
  only the order of the sum differs.

On the card run these with TF32 and reduced-precision bf16 reductions off
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``allow_bf16_reduced_precision_reduction = False``).

Not ported yet (ROADMAP.md queue 1, item 10): the flash-style attention
branch for sequences longer than ``DENSE_ATTN_MAX`` and mixture-of-experts
FFNs; both raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

DENSE_ATTN_MAX = 8192   # the reference's limit of its materialized-score path
_NOT_PORTED = "ROADMAP.md queue 1, item 10"


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``. bfloat16 arrays (``ml_dtypes.bfloat16``, what ``np.asarray``
    gives for a JAX bf16 array) cross bitwise through an int16 view, since
    ``torch.from_numpy`` refuses them."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``tensor_from_numpy``: a bf16 tensor becomes an
    ``ml_dtypes.bfloat16`` array (the package that gives numpy a bfloat16;
    needed only here, for handing arrays to other frameworks)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------- utilities

def dense(x, w):
    """x @ w in x's dtype (bf16: f32 accumulation, one rounding)."""
    return torch.matmul(x, w)


def rms_norm(x, w, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def normal_init(generator: torch.Generator, shape, scale,
                dtype=torch.bfloat16):
    """``normal * scale`` drawn in f32 on the generator's device, cast to
    ``dtype``. The reference draws with ``jax.random`` (threefry), so the
    values differ from its ``normal_init`` at any seed; tests carry the
    reference's weights across with ``tensor_from_numpy`` instead."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


# ---------------------------------------------------------------- RoPE

@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device):
    """The reference's f32 frequencies (host numpy), copied to ``device``
    once: a host-to-device copy waits for the stream, and rope runs twice
    per layer and step."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(freqs).to(device)


def rope(x, positions, theta: float = 10000.0):
    """x: (..., T, n, d). positions: (..., T) integer. The bf16 input meets
    f32 angles, so the rotation runs in f32 and rounds back once, as in the
    reference."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., T, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def _attn_block(q, k, v, qpos, kpos, kv_valid):
    """Full GQA attention for one block. q: (B,Tq,KV,G,d), k/v: (B,Tk,KV,d).
    Returns (B,Tq,KV,G,d) in f32."""
    scores = torch.einsum("btkgd,bskd->bkgts", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    mask = kpos[None, :] <= qpos[:, None]                    # (Tq,Tk) causal
    if kv_valid is not None:
        mask = mask & (kpos[None, :] < kv_valid)
    scores = scores.masked_fill(~mask[None, None, None], -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bskd->btkgd",
                        p.to(v.dtype).to(torch.float32), v.to(torch.float32))


def gqa_attention(q, k, v, *, q_offset=0, kv_valid=None,
                  chunk_q: int = 512, chunk_k: int = 1024,
                  causal: bool = True, dense_max: Optional[int] = None):
    """GQA attention with materialized scores. q: (B, Tq, H, d); k, v:
    (B, Tk, KV, d); each of KV kv-heads serves G = H // KV query heads.
    ``q_offset`` is the first query's position and ``kv_valid`` the number
    of valid cache rows (decode attends over the whole cache and masks the
    rest). Sequences past ``dense_max`` need the reference's flash-style
    branch, which is not ported."""
    B, Tq, H, d = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    dense_max = DENSE_ATTN_MAX if dense_max is None else dense_max
    if not ((Tq <= chunk_q and Tk <= chunk_k) or max(Tq, Tk) <= dense_max):
        raise NotImplementedError(
            f"flash-style attention for Tq={Tq}, Tk={Tk} > {dense_max} is "
            f"not ported ({_NOT_PORTED})")
    qg = q.reshape(B, Tq, KV, G, d)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tk, device=q.device)
    if not causal:
        qpos = torch.full((Tq,), Tk, device=q.device)     # everything visible
    o = _attn_block(qg, k, v, qpos, kpos, kv_valid)
    return o.reshape(B, Tq, H, d).to(q.dtype)


def init_attn(generator, d_model, n_heads, n_kv_heads, head_dim,
              dtype=torch.bfloat16, stack=()):
    """Attention weights; ``stack``: leading shape of stacked layers."""
    s = 1.0 / math.sqrt(d_model)
    st = tuple(stack)
    return {
        "wq": normal_init(generator, st + (d_model, n_heads, head_dim), s,
                          dtype),
        "wk": normal_init(generator, st + (d_model, n_kv_heads, head_dim), s,
                          dtype),
        "wv": normal_init(generator, st + (d_model, n_kv_heads, head_dim), s,
                          dtype),
        "wo": normal_init(generator, st + (n_heads, head_dim, d_model),
                          1.0 / math.sqrt(n_heads * head_dim), dtype),
    }


def _proj_heads(x, w):
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    D, H, hd = w.shape
    return torch.matmul(x, w.reshape(D, H * hd)).reshape(
        x.shape[:-1] + (H, hd))


def attn_qkv(p, x, positions, theta):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    return rope(q, positions, theta), rope(k, positions, theta), v


def attn_out(p, o):
    """einsum("bthk,hkd->btd") as one matmul."""
    H, hd, D = p["wo"].shape
    return torch.matmul(o.reshape(o.shape[:-2] + (H * hd,)),
                        p["wo"].reshape(H * hd, D))


# ---------------------------------------------------------------- MLP

def init_mlp(generator, d_model, d_ff, dtype=torch.bfloat16, stack=()):
    """Gated-MLP weights; ``stack``: leading shape of stacked layers."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    st = tuple(stack)
    return {
        "w_gate": normal_init(generator, st + (d_model, d_ff), s_in, dtype),
        "w_up": normal_init(generator, st + (d_model, d_ff), s_in, dtype),
        "w_down": normal_init(generator, st + (d_ff, d_model), s_out, dtype),
    }


def mlp(p, x):
    h = torch.nn.functional.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    return dense(h, p["w_down"])


def moe_ffn(p, x, *, top_k: int, **_):
    raise NotImplementedError(f"mixture-of-experts FFNs are not ported "
                              f"({_NOT_PORTED})")
