"""Shared language-model primitives: RMSNorm, RoPE, GQA attention (dense,
and flash-style past ``DENSE_ATTN_MAX``), the gated MLP and the
mixture-of-experts FFN.

Port of the reference package's ``models/common.py``.
Params are nested dicts of tensors in the reference's layout (heads kept as
their own axis: ``wq`` (D, H, hd), ``wo`` (H, hd, D)), and activations stay
bf16 between layers, as there. The reference's matmuls take
``preferred_element_type=float32``:

- where it casts the f32 product back to bf16 (``dense``, ``attn_qkv``,
  ``attn_out``) the port runs a bf16 matmul, which accumulates in f32 and
  rounds once;
- where it keeps the f32 product (attention scores, the PV product, the
  experts' gate and up products) the port upcasts the bf16 inputs to f32:
  bf16 products are exact in f32, so only the order of the sum differs.

On the card run these with TF32 and reduced-precision bf16 reductions off
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``allow_bf16_reduced_precision_reduction = False``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

DENSE_ATTN_MAX = 8192   # the reference's limit of its materialized-score path
# MoE dispatch, read at call time as in the reference: the token-group size
# and the algorithm ("einsum": GShard one-hot products; "gather": the top-C
# tokens of each expert by gate weight), and the capacity factor
MOE_GROUP_SIZE = 1024
MOE_DISPATCH = "einsum"
MOE_CAPACITY_FACTOR = 1.25


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
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(scale).to(dtype)


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
    """GQA attention. q: (B, Tq, H, d); k, v: (B, Tk, KV, d); each of KV
    kv-heads serves G = H // KV query heads. ``q_offset`` is the first
    query's position and ``kv_valid`` the number of valid cache rows
    (decode attends over the whole cache and masks the rest).

    Two regimes, as in the reference: up to ``dense_max`` (or within one
    chunk each way) the scores are materialized (``_attn_block``, the
    differentiable training path); past it the flash-style branch
    (``_flash_attention``) walks q-chunks and kv-chunks with an online
    softmax, the forward-only long-prefill path."""
    B, Tq, H, d = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, d)
    dense_max = DENSE_ATTN_MAX if dense_max is None else dense_max
    if not ((Tq <= chunk_q and Tk <= chunk_k) or max(Tq, Tk) <= dense_max):
        return _flash_attention(qg, k, v, q_offset, kv_valid, chunk_q,
                                chunk_k, causal).to(q.dtype)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tk, device=q.device)
    if not causal:
        qpos = torch.full((Tq,), Tk, device=q.device)     # everything visible
    o = _attn_block(qg, k, v, qpos, kpos, kv_valid)
    return o.reshape(B, Tq, H, d).to(q.dtype)


def _flash_attention(qg, k, v, q_offset, kv_valid, chunk_q, chunk_k,
                     causal):
    """The reference's flash-style branch. qg: (B, Tq, KV, G, d); k, v:
    (B, Tk, KV, d). Tq and Tk are zero-padded to chunk multiples; for each
    q-chunk the kv-chunks are walked in order with the running max ``m``
    and sum ``l`` in f32 (``-1e30`` marks a masked score, and ``m`` starts
    there), ``p`` rounded to v's dtype before the PV product (f32 sums),
    padded keys masked by ``valid``; the output is ``acc / max(l,
    1e-30)``. Returns (B, Tq, H, d) f32."""
    B, Tq, KV, G, d = qg.shape
    Tk = k.shape[1]
    nq, nk = -(-Tq // chunk_q), -(-Tk // chunk_k)
    pq, pk = nq * chunk_q - Tq, nk * chunk_k - Tk
    F = torch.nn.functional
    if pq:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        valid = Tk if kv_valid is None else kv_valid
    else:
        valid = kv_valid
    scale = 1.0 / math.sqrt(d)
    dev = qg.device
    out = torch.empty((B, nq * chunk_q, KV, G, d), dtype=torch.float32,
                      device=dev)
    for qi in range(nq):
        qchunk = qg[:, qi * chunk_q:(qi + 1) * chunk_q].to(torch.float32)
        qpos = q_offset + qi * chunk_q + torch.arange(chunk_q, device=dev)
        m = torch.full((B, KV, G, chunk_q), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, chunk_q, d), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kch = k[:, ki * chunk_k:(ki + 1) * chunk_k]
            vch = v[:, ki * chunk_k:(ki + 1) * chunk_k]
            kpos = ki * chunk_k + torch.arange(chunk_k, device=dev)
            s = torch.einsum("btkgd,bskd->bkgts", qchunk,
                             kch.to(torch.float32)) * scale
            mask = None
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            if valid is not None:
                vmask = (kpos < valid)[None, :]
                mask = vmask if mask is None else mask & vmask
            if mask is not None:
                s = s.masked_fill(~mask[None, None, None], -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgts,bskd->bkgtd", p.to(vch.dtype).to(torch.float32),
                vch.to(torch.float32))
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,KV,G,Cq,d)
        out[:, qi * chunk_q:(qi + 1) * chunk_q] = o.permute(0, 3, 1, 2, 4)
    return out[:, :Tq].reshape(B, Tq, KV * G, d)


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


def init_moe(generator, d_model, d_ff, n_experts, n_shared,
             dtype=torch.bfloat16, stack=()):
    """Expert weights stacked on an experts axis (``w_gate`` (E, D, F)), an
    f32 router (D, E) and, with ``n_shared``, one shared gated MLP of width
    ``d_ff * n_shared``; ``stack``: leading shape of stacked layers."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    st = tuple(stack)
    p = {
        "router": normal_init(generator, st + (d_model, n_experts), s_in,
                              torch.float32),
        "w_gate": normal_init(generator, st + (n_experts, d_model, d_ff),
                              s_in, dtype),
        "w_up": normal_init(generator, st + (n_experts, d_model, d_ff), s_in,
                            dtype),
        "w_down": normal_init(generator, st + (n_experts, d_ff, d_model),
                              s_out, dtype),
    }
    if n_shared:
        p["shared"] = init_mlp(generator, d_model, d_ff * n_shared, dtype,
                               stack)
    return p


def _normalized_top_k(gates, top_k: int):
    """The top-k gates (ties to the lower expert) over their sum."""
    topw, topi = torch.topk(gates, top_k, dim=-1)
    return topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9), topi


def _dispatch_mask(gates, top_k: int, capacity: int):
    """GShard top-k dispatch with capacity, slot-major. gates: (..., S, E)
    probabilities (leading axes: independent groups). Returns dispatch
    (..., S, E, C) bool and combine (..., S, E, C) in the gates' dtype.

    Slot by slot, each expert's tokens take the next free places in token
    order, after the places earlier slots took (``counts``); a token whose
    place is at or past ``capacity`` is dropped. The reference loops over
    the slots; here the slots are one axis, and each slot's ``counts`` the
    exclusive running sum of the earlier slots' picks (integers: the same
    places). The reference builds ``one_hot(pos, capacity)``, a zero row
    for a place out of range; here the place is compared with
    ``arange(capacity)`` instead (``torch.nn.functional.one_hot`` raises out
    of range). A token picks an expert in one slot at most, so each (s, e)
    row holds one weight and ``combine`` is that weight at the token's
    place: the reference's sum over slots adds zeros to it."""
    E = gates.shape[-1]
    topw, topi = _normalized_top_k(gates, top_k)
    experts = torch.arange(E, device=gates.device)
    oh = (topi.movedim(-1, 0)[..., None] == experts).to(torch.int32)
    picks = oh.sum(-2, dtype=torch.int32)                  # (k, ..., E)
    counts = torch.cumsum(picks, dim=0, dtype=torch.int32) - picks
    pos = torch.cumsum(oh, dim=-2, dtype=torch.int32) - 1 + counts[..., None, :]
    keep = (pos < capacity) & (oh > 0)                     # (k, ..., S, E)
    place = torch.where(keep, pos, -1).amax(0)
    w_se = (keep.to(gates.dtype) * topw.movedim(-1, 0)[..., None]).sum(0)
    dispatch = place[..., None] == torch.arange(capacity,
                                                device=gates.device)
    return dispatch, dispatch.to(gates.dtype) * w_se[..., None]


def _expert_ffn(p, xe, w_gate, w_up):
    """Each expert's gated MLP on its (G, E, C, D) tokens (G groups). The
    gate and up products stay f32 (``w_gate``/``w_up``: the f32 weights),
    the hidden state rounds to the tokens' dtype before the down product.
    The groups share one product per expert: (E, G * C, D) rows."""
    G, E, C, D = xe.shape
    rows = xe.transpose(0, 1).reshape(E, G * C, D)
    xf = rows.to(torch.float32)
    h = torch.nn.functional.silu(torch.bmm(xf, w_gate)) * torch.bmm(xf, w_up)
    ye = torch.bmm(h.to(xe.dtype), p["w_down"])
    return ye.reshape(E, G, C, D).transpose(0, 1)


def moe_ffn(p, x, *, top_k: int, group_size: int = 0,
            capacity_factor: float = 0.0):
    """Mixture-of-experts FFN with grouped GShard dispatch. x: (B, T, D).

    Tokens are taken in groups of ``group_size`` (``MOE_GROUP_SIZE``; the
    last group zero-padded), all groups at once, each routed on its own
    with capacity ``ceil(S * top_k * capacity_factor / E)`` places an
    expert; tokens past an expert's capacity are dropped (their residual
    passes through). With
    a ``shared`` MLP its output is added. ``MOE_DISPATCH`` picks the
    algorithm: ``"einsum"`` (one-hot dispatch and combine products, the
    default) or ``"gather"`` (each expert's top-C tokens by gate weight,
    scattered back with ``index_add``)."""
    B, T, D = x.shape
    E = p["w_gate"].shape[0]
    N = B * T
    flat = x.reshape(N, D)
    S = min(group_size or MOE_GROUP_SIZE, N)
    capacity_factor = capacity_factor or MOE_CAPACITY_FACTOR
    n_groups = -(-N // S)
    pad = n_groups * S - N
    if pad:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
    capacity = max(1, int(math.ceil(S * top_k * capacity_factor / E)))
    if MOE_DISPATCH not in ("einsum", "gather"):
        raise ValueError(f"unknown MOE_DISPATCH {MOE_DISPATCH!r}")
    w_gate = p["w_gate"].to(torch.float32)
    w_up = p["w_up"].to(torch.float32)
    groups = flat.reshape(n_groups, S, D)
    gates = torch.softmax(torch.matmul(groups.to(torch.float32), p["router"]),
                          dim=-1)                                # (G,S,E)
    if MOE_DISPATCH == "gather":
        topw, topi = _normalized_top_k(gates, top_k)
        w_se = torch.zeros_like(gates).scatter(-1, topi, topw)
        cap = min(capacity, S)
        sel_w, sel_idx = torch.topk(w_se.transpose(1, 2), cap, dim=-1)
        g_idx = torch.arange(n_groups, device=x.device)[:, None, None]
        ye = _expert_ffn(p, groups[g_idx, sel_idx], w_gate, w_up)
        contrib = ye.to(torch.float32) * sel_w[..., None]   # (G,E,C,D)
        y = torch.zeros((n_groups * S, D), dtype=torch.float32,
                        device=x.device).index_add(
            0, (sel_idx + g_idx * S).reshape(-1), contrib.reshape(-1, D))
        y = y.to(x.dtype)
    else:
        dispatch, combine = _dispatch_mask(gates, top_k, capacity)
        xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), groups)
        ye = _expert_ffn(p, xe, w_gate, w_up)
        y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    y = y.reshape(n_groups * S, D)[:N].reshape(B, T, D)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    return y
