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

On a mesh (``distributed/sharding.py``) the params are DTensors placed by
the logical-axes trees (``ATTN_AXES``, ``MLP_AXES``, ``moe_axes``) and
``shard()`` constrains the activations where the reference's does; off a
mesh both are no-ops.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import from_local, is_dtensor, \
    reduce_partial, shard, split_over, whole
from repro_torch.roofline.counter import trips

# BF16_PARTIALS (the reference's perf lever, set by ``launch/dryrun.py
# --bf16-partials``): a row-parallel product rounds each shard's partial sum
# to bf16, so the cross-shard reduction moves half the bytes. Off (the
# default), the partial sums stay f32 through the reduction and round once.
BF16_PARTIALS = False
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
    """x @ w in x's dtype (bf16: f32 accumulation, one rounding). Where x's
    contracted dim is split over a mesh axis (a row-parallel product on
    DTensors: each shard holds a partial sum), the partial sums are
    reduced across the shards in f32 and rounded once after the reduction,
    or, under ``BF16_PARTIALS``, rounded on each shard and reduced in
    bf16."""
    if not split_over(x, -1):
        return torch.matmul(x, w)
    if BF16_PARTIALS:
        return reduce_partial(torch.matmul(x, w))
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return reduce_partial(y).to(x.dtype)


def rms_norm(x, w, eps: float = 1e-5):
    """RMSNorm in f32, rounded to x's dtype. A norm weight split over a mesh
    axis (``ensure_model`` re-homes "model" on a stacked norm's width) is
    gathered whole first: a split weight would split the activation's
    width, and each following product would then reduce its partial sums
    across the axis."""
    if is_dtensor(w):
        w = whole(w)
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def add_rms_norm(x, y, w, eps: float = 1e-5):
    """(x + y, rms_norm(x + y, w)) for bf16 ``x`` and ``y`` as the reference
    computes them under ``jax.jit`` on the CPU: XLA evaluates the bf16 add
    in float32 and, allowing excess precision, feeds that float32 sum to
    the norm unrounded; only the sum it keeps for the next residual add is
    rounded to bf16. (Op by op, outside ``jit``, the norm sees the rounded
    sum: ``rms_norm(x + y, w)``.) Every block whose residual sum feeds a
    norm takes it so: the xLSTM's pairs, the decoder, Mamba and
    encoder-decoder blocks."""
    h = x.to(torch.float32) + y.to(torch.float32)
    return h.to(x.dtype), rms_norm(h, w, eps).to(x.dtype)


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

def _attn_block(q, k, v, q_offset, kv_valid, causal, k0=None, Tk=None,
                reduce=None):
    """GQA attention with the scores materialized, for one block. q: (B,
    Tq, H, d), k/v: (B, Tk', KV, d). Returns (B, Tq, H, d) in q's dtype.
    The scores and the PV product run in f32, the probabilities round to
    v's dtype before it. Where the keys are this rank's share of a
    sequence of ``Tk`` split across ranks (a decode over a cache sharded on
    ``cache_seq``), ``k0`` is their first global position, and
    ``reduce(t, op)`` completes the softmax's max and sum and the PV sum
    across the ranks that hold the other keys; else ``torch.softmax``."""
    B, Tq, H, d = q.shape
    KV = k.shape[2]
    dev = q.device
    qpos = q_offset + torch.arange(Tq, device=dev)
    kpos = torch.arange(k.shape[1], device=dev)
    if k0 is not None:
        kpos = k0 + kpos
    if not causal:                                  # everything visible
        qpos = torch.full((Tq,), k.shape[1] if Tk is None else Tk,
                          device=dev)
    qg = q.reshape(B, Tq, KV, H // KV, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * (1.0 / math.sqrt(d))
    mask = kpos[None, :] <= qpos[:, None]                    # (Tq,Tk) causal
    if kv_valid is not None:
        mask = mask & (kpos[None, :] < kv_valid)
    scores = scores.masked_fill(~mask[None, None, None], -1e30)
    if reduce is None:
        p = torch.softmax(scores, dim=-1)
    else:
        e = torch.exp(scores - reduce(scores.amax(-1, keepdim=True), "max"))
        p = e / reduce(e.sum(-1, keepdim=True), "sum")
    o = torch.einsum("bkgts,bskd->btkgd",
                     p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    if reduce is not None:
        o = reduce(o, "sum")
    return o.reshape(B, Tq, H, d).to(q.dtype)


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
    softmax, the forward-only long-prefill path. On DTensors each rank
    attends over its own shards (``_mesh_attention``)."""
    if is_dtensor(q) or is_dtensor(k):
        return _mesh_attention(q, k, v, q_offset, kv_valid, chunk_q, chunk_k,
                               causal, dense_max)
    B, Tq, H, d = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, d)
    dense_max = DENSE_ATTN_MAX if dense_max is None else dense_max
    if not ((Tq <= chunk_q and Tk <= chunk_k) or max(Tq, Tk) <= dense_max):
        return _flash_attention(qg, k, v, q_offset, kv_valid, chunk_q,
                                chunk_k, causal).to(q.dtype)
    return _attn_block(q, k, v, q_offset, kv_valid, causal)


def _mesh_plan(q, k):
    """Per mesh dim of the keys' mesh: how the attention splits over it,
    "batch", "heads" (q's heads and k's kv-heads in aligned chunks),
    "q_heads" (q's heads split, the kv-heads replicated: each rank keeps the
    kv-heads its q-heads read), "seq" (the keys' sequence split: a cache
    sharded on ``cache_seq``) or None (replicated). The keys' split decides
    (the cache is the tensor not to move); what cannot be followed is
    replicated."""
    from torch.distributed.tensor import Shard
    B, Tq, H, _ = q.shape
    KV = k.shape[2]
    G = H // KV
    plan, head_dims = [], 0
    for i, pk in enumerate(k.placements):
        n = k.device_mesh.size(i)
        pq = q.placements[i]
        kd = pk.dim if isinstance(pk, Shard) else None
        qd = pq.dim if isinstance(pq, Shard) else None
        if n == 1:
            plan.append(None)
        elif kd == 0 and B % n == 0:
            plan.append("batch")
        elif kd == 1 and Tq <= DENSE_ATTN_MAX:
            plan.append("seq")
        elif kd == 2 and KV % n == 0 and not head_dims:
            plan.append("heads")
            head_dims += 1
        elif kd is None and qd == 2 and H % n == 0 and not head_dims and (
                G % (H // n) == 0 or (H // n) % G == 0):
            plan.append("q_heads")
            head_dims += 1
        else:
            plan.append(None)
    return plan


def _mesh_attention(q, k, v, q_offset, kv_valid, chunk_q, chunk_k, causal,
                    dense_max):
    """``gqa_attention`` on DTensors: q, k and v are redistributed to the
    split ``_mesh_plan`` gives each mesh dim, and every rank runs the plain
    attention on its shards, which is the unsharded computation on each
    (batch, head) slice. Where the keys' sequence is split (a decode over a
    cache sharded on ``cache_seq``) each rank scores its own keys at their
    global positions, and the softmax's max and sum and the PV product are
    reduced across those ranks (all-reduces of (B, H, Tq)-sized rows); the
    normalized probabilities round to v's dtype before the PV product, as
    in ``_attn_block``. Returns q's shape, heads split as q's were."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = (k if is_dtensor(k) else q).device_mesh
    rep = [Replicate()] * mesh.ndim
    q, k, v = (x if is_dtensor(x) else DTensor.from_local(
        x, mesh, rep, run_check=False) for x in (q, k, v))
    B, Tq, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    plan = _mesh_plan(q, k)
    qpl = [Shard(0) if s == "batch" else Shard(2) if s in ("heads",
           "q_heads") else Replicate() for s in plan]
    kpl = [Shard({"batch": 0, "seq": 1, "heads": 2}[s])
           if s in ("batch", "seq", "heads") else Replicate() for s in plan]
    q = q.redistribute(mesh, qpl)
    k, v = k.redistribute(mesh, kpl), v.redistribute(mesh, kpl)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if "q_heads" in plan:                  # the kv-heads of the local q-heads
        _, off = compute_local_shape_and_global_offset(q.shape, mesh, qpl)
        h0, hl = off[2], ql.shape[2]
        kv0, kv1 = h0 // G, (h0 + hl - 1) // G + 1
        kl, vl = kl[:, :, kv0:kv1], vl[:, :, kv0:kv1]
    seq = [i for i, s in enumerate(plan) if s == "seq"]
    if not seq:
        o = gqa_attention(ql, kl, vl, q_offset=q_offset, kv_valid=kv_valid,
                          chunk_q=chunk_q, chunk_k=chunk_k, causal=causal,
                          dense_max=dense_max)
    else:
        _, koff = compute_local_shape_and_global_offset(k.shape, mesh, kpl)
        o = _attn_block(ql, kl, vl, q_offset, kv_valid, causal, koff[1],
                        Tk=k.shape[1], reduce=lambda t, op: _reduce_over(
                            funcol, t, op, mesh, seq))
    return from_local(o.contiguous(), mesh, qpl, q.shape)


def _reduce_over(funcol, t, op, mesh, dims):
    for i in dims:
        t = funcol.all_reduce(t, op, (mesh, i))
    return t


def _flash_attention(qg, k, v, q_offset, kv_valid, chunk_q, chunk_k,
                     causal):
    """The reference's flash-style branch. qg: (B, Tq, KV, G, d); k, v:
    (B, Tk, KV, d). Tq and Tk are zero-padded to chunk multiples; for each
    q-chunk the kv-chunks are walked in order with the running max ``m``
    and sum ``l`` in f32 (``-1e30`` marks a masked score, and ``m`` starts
    there), ``p`` rounded to v's dtype before the PV product (f32 sums),
    padded keys masked by ``valid``; the output is ``acc / max(l,
    1e-30)``. Returns (B, Tq, H, d) f32. Every trip of either loop has the
    same shapes, so under a roofline counter each folds to four trips
    whose counts add up to its trip count (``roofline/counter.py::trips``)."""
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
    for qi in trips(nq):
        qchunk = qg[:, qi * chunk_q:(qi + 1) * chunk_q].to(torch.float32)
        qpos = q_offset + qi * chunk_q + torch.arange(chunk_q, device=dev)
        m = torch.full((B, KV, G, chunk_q), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, chunk_q, d), dtype=torch.float32,
                          device=dev)
        for ki in trips(nk):
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


ATTN_AXES = {
    "wq": ("embed", "heads", "qkv_dim"),
    "wk": ("embed", "kv_heads", "qkv_dim"),
    "wv": ("embed", "kv_heads", "qkv_dim"),
    "wo": ("heads", "qkv_dim", "embed"),
}


def _proj_heads(x, w):
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    D, H, hd = w.shape
    return dense(x, w.reshape(D, H * hd)).reshape(x.shape[:-1] + (H, hd))


def attn_qkv(p, x, positions, theta):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    q = shard(rope(q, positions, theta), "batch", "seq", "heads", None)
    k = shard(rope(k, positions, theta), "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def attn_out(p, o):
    """einsum("bthk,hkd->btd") as one matmul."""
    H, hd, D = p["wo"].shape
    y = dense(o.reshape(o.shape[:-2] + (H * hd,)), p["wo"].reshape(H * hd, D))
    return shard(y, "batch", "seq", "embed")


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


MLP_AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def silu(x):
    """``jax.nn.silu`` as the reference lowers it: x * (1 / (1 +
    exp(-x))), every operation rounded to x's dtype. For bf16 this is what
    XLA computes on the CPU, jitted or not (``torch.sigmoid`` and
    ``F.silu`` round the exact value once, which differs in about a third
    of bf16 inputs). For f32 the four operations are XLA's too, and only
    ``exp``'s last bit can differ from XLA's own (in ~4 % of inputs on the
    CPU, against ~23 % for ``F.silu``)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(p, x):
    h = silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    h = shard(h, "batch", "seq", "mlp")
    return shard(dense(h, p["w_down"]), "batch", "seq", "embed")


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


def moe_axes(n_shared):
    p = {"router": ("embed", None),
         "w_gate": ("experts", "embed", "expert_mlp"),
         "w_up": ("experts", "embed", "expert_mlp"),
         "w_down": ("experts", "expert_mlp", "embed")}
    if n_shared:
        p["shared"] = dict(MLP_AXES)
    return p


_ROUTER_OBSERVERS: list = []


@contextlib.contextmanager
def observe_routers(fn):
    """Call ``fn(gates, top_k)`` at every ``moe_ffn`` inside the block, with
    its router's (B, T, E) f32 softmax gates (a check reads the routing
    margins so; with none registered this costs one list test)."""
    _ROUTER_OBSERVERS.append(fn)
    try:
        yield fn
    finally:
        _ROUTER_OBSERVERS.remove(fn)


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
    xe = shard(xe, None, "experts", None, "embed")
    rows = xe.transpose(0, 1).reshape(E, G * C, D)
    xf = rows.to(torch.float32)
    h = silu(torch.bmm(xf, w_gate)) * torch.bmm(xf, w_up)
    ye = torch.bmm(h.to(xe.dtype), p["w_down"])
    return shard(ye.reshape(E, G, C, D).transpose(0, 1), None, "experts",
                 None, "embed")


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
    groups = shard(flat.reshape(n_groups, S, D), None, "batch", "embed")
    gates = torch.softmax(torch.matmul(groups.to(torch.float32), p["router"]),
                          dim=-1)                                # (G,S,E)
    for fn in _ROUTER_OBSERVERS:
        fn(gates.reshape(n_groups * S, E)[:N].reshape(B, T, E), top_k)
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
    return shard(y, "batch", "seq", "embed")
