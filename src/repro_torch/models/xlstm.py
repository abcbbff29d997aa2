"""xLSTM (sLSTM + mLSTM) language model, in PyTorch.

Port of the reference package's ``models/xlstm.py`` (arXiv:2405.04517):
blocks alternate mLSTM (matrix memory, chunkwise-parallel linear attention
with per-head scalar exponential gating) and sLSTM (scalar memory, per-head
block-diagonal recurrence, a sequential time loop). The gating runs in
float32 with the m-state stabilizer, as there.

Params keep the reference's layout: ``pairs`` holds the G = L / 2 (mLSTM,
sLSTM) pairs stacked on a leading axis (``pair(params, g)`` slices one).
Dtypes follow the reference's exactly: activations bf16 between blocks;
``dense`` products accumulate in f32 and round once to bf16; the sLSTM's
``x @ wx`` and its recurrent kernel ``r`` stay f32.

The MxVs of a block go through an ``mm(key, x, f32=False)`` callable
(``dense_mm`` by default): ``x @ p[key]``, rounded to ``x.dtype`` or kept
f32. The sLSTM's recurrent product goes through ``rec(h)`` (default
``einsum("bhd,hde->bhe", h, r)``). The search target swaps both for
population lanes that read quantized-weight banks
(``core/xlstm_target.py``). Inputs may carry any leading axes before
(T, D); the recurrences fold them into one batch axis.

Serving: ``prefill`` runs the prompt and returns the recurrent state of
every pair (``init_state``'s layout, stacked over the G pairs);
``decode_step`` advances it by one token with ``mlstm_step`` and
``slstm_step``, updating the state's tensors in place.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

Params = Dict
Mm = Callable[..., torch.Tensor]


def dense_mm(p: Params) -> Mm:
    """The reference's products on block params ``p``: ``mm(key, x)`` is
    ``cm.dense`` (f32 accumulation, one rounding to ``x.dtype``);
    ``mm(key, x, f32=True)`` is ``jnp.dot(x, w,
    preferred_element_type=float32)``: bf16 products are exact in f32, so
    the operands are widened and the sum stays f32."""
    def mm(key, x, f32=False):
        if f32:
            return torch.matmul(x.to(torch.float32),
                                p[key].to(torch.float32))
        return cm.dense(x, p[key])
    return mm


def _normal(g, shape, scale, dtype=torch.bfloat16):
    return cm.normal_init(g, shape, scale, dtype)


# ------------------------------------------------------------------ mLSTM

def init_mlstm(generator: torch.Generator, cfg: ArchConfig, stack=()):
    D, H = cfg.d_model, cfg.n_heads
    di = cfg.ssm_d_inner
    st = tuple(stack)
    s = 1.0 / math.sqrt(D)
    g = generator
    return {
        "wq": _normal(g, st + (D, di), s),
        "wk": _normal(g, st + (D, di), s),
        "wv": _normal(g, st + (D, di), s),
        "wi": _normal(g, st + (D, H), s, torch.float32),
        "wf": _normal(g, st + (D, H), s, torch.float32),
        # open forget gates at init
        "fbias": torch.full(st + (H,), 3.0, dtype=torch.float32,
                            device=g.device),
        "wz": _normal(g, st + (D, di), s),
        "wo": _normal(g, st + (di, D), 1.0 / math.sqrt(di)),
    }


def _mlstm_qkvg(p, cfg: ArchConfig, x, mm: Optional[Mm] = None):
    """q, k, v (..., T, H, dh) in x's dtype; the input and forget gate
    logits (..., T, H) in f32."""
    mm = mm or dense_mm(p)
    H = cfg.n_heads
    dh = cfg.ssm_d_inner // H
    heads = x.shape[:-1] + (H, dh)
    q, k, v = (mm(key, x).reshape(heads) for key in ("wq", "wk", "wv"))
    xf = x.to(torch.float32)
    logi = torch.matmul(xf, p["wi"])
    logf = F.logsigmoid(torch.matmul(xf, p["wf"]) + p["fbias"])
    return q, k, v, logi, logf


def mlstm_fwd(p, cfg: ArchConfig, x, chunk: int = 128,
              return_state: bool = False, mm: Optional[Mm] = None):
    """Chunkwise-parallel mLSTM. x: (..., T, D) -> (..., T, D).

    The reference scans over chunks from a zero state. Two of its terms
    are exactly zero here and are skipped: the inter-chunk read-out of the
    first chunk (its state is all zeros; adding 0.0 changes no value), and
    the state update after the last chunk when no state is returned (at
    the search's full width that state is 4 GB a layer)."""
    mm = mm or dense_mm(p)
    lead, T = x.shape[:-2], x.shape[-2]
    H = cfg.n_heads
    dh = cfg.ssm_d_inner // H
    q, k, v, logi, logf = _mlstm_qkvg(p, cfg, x, mm)
    B = math.prod(lead)
    q, k, v = (t.reshape(B, T, H, dh).to(torch.float32) for t in (q, k, v))
    logi, logf = logi.reshape(B, T, H), logf.reshape(B, T, H)
    chunk = min(chunk, T)
    nch = -(-T // chunk)
    pad = nch * chunk - T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
        logf = F.pad(logf, (0, 0, 0, pad))
    scale = 1.0 / math.sqrt(dh)
    tq = torch.arange(chunk, device=x.device)
    causal = (tq[:, None] >= tq[None, :])[None, :, :, None]   # (1,c,c,1)
    S = n = None                      # the zero state
    m = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        qk, kk, vk, ik, fk = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], \
            logf[:, sl]
        g = torch.cumsum(fk, dim=1)                             # (B,c,H)
        g_last = g[:, -1]                                       # (B,H)
        a = g + m[:, None]                                      # inter decay
        intra = ik[:, None, :, :] + (g[:, :, None, :] - g[:, None, :, :])
        intra = torch.where(causal, intra, torch.full_like(intra, -1e30))
        m_intra = intra.max(dim=2).values                       # (B,c,H)
        m_new_t = torch.maximum(a, m_intra)
        s_intra = torch.einsum("bthd,bshd->btsh", qk, kk) * scale
        w_intra = torch.exp(intra - m_new_t[:, :, None, :]) * s_intra * \
            causal.to(torch.float32)
        num = torch.einsum("btsh,bshd->bthd", w_intra, vk)
        den = w_intra.sum(dim=2)                                # (B,c,H)
        if S is not None:
            w_inter = torch.exp(a - m_new_t)
            qs = qk * scale
            num = num + torch.einsum("bthd,bhde,bth->bthe", qs, S, w_inter)
            den = den + torch.einsum("bthd,bhd,bth->bth", qs, n, w_inter)
        denom = torch.maximum(torch.abs(den), torch.exp(-m_new_t))[..., None]
        ys.append(num / denom)                                  # (B,c,H,dh)
        if c == nch - 1 and not return_state:
            break
        dec = ik + (g_last[:, None] - g)
        m_next = torch.maximum(g_last + m, dec.max(dim=1).values)
        up_w = torch.exp(dec - m_next[:, None])
        S_up = torch.einsum("bthd,bthe,bth->bhde", kk, vk, up_w)
        n_up = torch.einsum("bthd,bth->bhd", kk, up_w)
        if S is None:
            S, n = S_up, n_up
        else:
            keep = torch.exp(g_last + m - m_next)
            S = S * keep[..., None, None] + S_up
            n = n * keep[..., None] + n_up
        m = m_next
    y = torch.cat(ys, dim=1)[:, :T].reshape(lead + (T, H * dh))
    z = F.silu(mm("wz", x).to(torch.float32))
    y = (y * z).to(x.dtype)
    out = mm("wo", y)
    if return_state:
        if S is None:
            S = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                            device=x.device)
            n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        return out, {"S": S, "n": n, "m": m}
    return out


def mlstm_step(p, cfg: ArchConfig, x, state):
    """One step of the mLSTM recurrence. x: (B, 1, D); state {"S": (B, H,
    dh, dh), "n": (B, H, dh), "m": (B, H)} in f32. Returns (y (B, 1, D),
    new state)."""
    mm = dense_mm(p)
    B = x.shape[0]
    H = cfg.n_heads
    dh = cfg.ssm_d_inner // H
    q, k, v, logi, logf = _mlstm_qkvg(p, cfg, x, mm)
    q, k, v = (t[:, 0].to(torch.float32) for t in (q, k, v))
    logi, logf = logi[:, 0], logf[:, 0]
    S, n, m = state["S"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, logi)
    fw = torch.exp(logf + m - m_new)[..., None, None]
    iw = torch.exp(logi - m_new)[..., None, None]
    S_new = S * fw + iw * torch.einsum("bhd,bhe->bhde", k, v)
    n_new = n * fw[..., 0] + iw[..., 0] * k
    qs = q * (1.0 / math.sqrt(dh))
    y = torch.einsum("bhd,bhde->bhe", qs, S_new)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n_new)),
                          torch.exp(-m_new))[..., None]
    y = (y / denom).reshape(B, 1, H * dh)
    z = F.silu(mm("wz", x).to(torch.float32))
    y = (y * z).to(x.dtype)
    return mm("wo", y), {"S": S_new, "n": n_new, "m": m_new}


# ------------------------------------------------------------------ sLSTM

def init_slstm(generator: torch.Generator, cfg: ArchConfig, stack=()):
    D, H = cfg.d_model, cfg.n_heads
    di = cfg.ssm_d_inner
    dh = di // H
    st = tuple(stack)
    s = 1.0 / math.sqrt(D)
    g = generator
    return {
        "wx": _normal(g, st + (D, 4 * di), s),              # i,f,z,o pre-acts
        "r": _normal(g, st + (H, dh, 4 * dh), 1.0 / math.sqrt(dh),
                     torch.float32),
        "bias": torch.zeros(st + (4 * di,), dtype=torch.float32,
                            device=g.device),
        "wo": _normal(g, st + (di, D), 1.0 / math.sqrt(di)),
    }


def _slstm_cell(p, cfg: ArchConfig, pre, state,
                rec: Optional[Callable] = None):
    """pre: (B, H, dh, 4) gate pre-activations (the x part, f32); state: a
    dict of (B, H, dh) f32. ``rec(h)`` -> (B, H, 4 dh) f32 recurrent
    pre-activations, by default ``einsum("bhd,hde->bhe", h, r)``."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    B, H, dh = h.shape
    r = (rec(h) if rec is not None
         else torch.einsum("bhd,hde->bhe", h, p["r"]))         # (B,H,4dh)
    r = r.reshape(B, H, 4, dh).transpose(2, 3)
    g = pre + r
    logi = g[..., 0]
    logf = F.logsigmoid(g[..., 1])
    z = torch.tanh(g[..., 2])
    o = torch.sigmoid(g[..., 3])
    m_new = torch.maximum(logf + m, logi)
    i_ = torch.exp(logi - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = torch.clamp(f_ * n + i_, min=1e-6)
    h_new = o * (c_new / n_new)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_init_state(cfg: ArchConfig, B: int, device="cuda"):
    H = cfg.n_heads
    dh = cfg.ssm_d_inner // H

    def zero():
        return torch.zeros((B, H, dh), dtype=torch.float32, device=device)
    return {"c": zero(), "n": zero(), "h": zero(), "m": zero()}


def slstm_fwd(p, cfg: ArchConfig, x, return_state: bool = False,
              mm: Optional[Mm] = None, rec: Optional[Callable] = None):
    """sLSTM over (..., T, D) -> (..., T, D): the gate pre-activations of
    every step in one f32 product, then a loop over the T steps."""
    mm = mm or dense_mm(p)
    lead, T = x.shape[:-2], x.shape[-2]
    H = cfg.n_heads
    di = cfg.ssm_d_inner
    dh = di // H
    B = math.prod(lead)
    pre = (mm("wx", x, f32=True) + p["bias"]).reshape(B, T, H, dh, 4)
    state = slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(T):
        state = _slstm_cell(p, cfg, pre[:, t], state, rec)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(lead + (T, di)).to(x.dtype)
    out = mm("wo", y)
    if return_state:
        return out, state
    return out


def slstm_step(p, cfg: ArchConfig, x, state):
    """One step of the sLSTM. x: (B, 1, D); state: a dict of (B, H, dh)
    f32. Returns (y (B, 1, D), new state)."""
    mm = dense_mm(p)
    B = x.shape[0]
    H = cfg.n_heads
    di = cfg.ssm_d_inner
    pre = (mm("wx", x[:, 0], f32=True) + p["bias"]).reshape(B, H, di // H, 4)
    new = _slstm_cell(p, cfg, pre, state)
    y = new["h"].reshape(B, 1, di).to(x.dtype)
    return mm("wo", y), new


# ------------------------------------------------------------------ LM

def init_block_pair(generator: torch.Generator, cfg: ArchConfig, stack=()):
    st = tuple(stack)
    dev = generator.device
    return {"norm_m": torch.ones(st + (cfg.d_model,), dtype=torch.float32,
                                 device=dev),
            "mlstm": init_mlstm(generator, cfg, st),
            "norm_s": torch.ones(st + (cfg.d_model,), dtype=torch.float32,
                                 device=dev),
            "slstm": init_slstm(generator, cfg, st)}


def init_lm(seed: int, cfg: ArchConfig, device="cuda") -> Params:
    """Random params in the reference layout (``pairs`` stacked over the G
    pairs), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``. The values differ from the reference's ``init_lm``
    (threefry draws); tests carry its weights across with
    ``params_from_numpy``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    D, V = cfg.d_model, cfg.padded_vocab
    return {
        "embed": _normal(g, (V, D), 1.0 / math.sqrt(D)),
        "pairs": init_block_pair(g, cfg, (cfg.n_layers // 2,)),
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": _normal(g, (D, V), 1.0 / math.sqrt(D)),
    }


def pair(params: Params, g: int) -> Params:
    """The g-th (mLSTM, sLSTM) pair of the stacked ``pairs`` tree."""
    return cm.tree_map(lambda a: a[g], params["pairs"])


def params_from_numpy(tree, device="cuda") -> Params:
    """The reference's param pytree as nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors, bitwise;
    bf16 leaves (``ml_dtypes.bfloat16``) cross as bf16."""
    dev = resolve_device(device)
    return cm.tree_map(lambda a: cm.tensor_from_numpy(a, dev), tree)


def params_to_numpy(tree) -> Dict:
    """Inverse of ``params_from_numpy``."""
    return cm.tree_map(cm.tensor_to_numpy, tree)


def add_rms_norm(x, y, w, eps: float = 1e-5):
    """(x + y, rms_norm(x + y, w)) for bf16 ``x`` and ``y`` as the reference
    computes them under ``jax.jit`` on the CPU: XLA evaluates the bf16 add
    in float32 and, allowing excess precision, feeds that float32 sum to
    the norm unrounded; only the sum it keeps for the next residual add is
    rounded to bf16. (Op by op, outside ``jit``, the norm sees the rounded
    sum: ``cm.rms_norm(x + y, w)``.)"""
    h = x.to(torch.float32) + y.to(torch.float32)
    return h.to(x.dtype), cm.rms_norm(h, w, eps).to(x.dtype)


def _pairs_fwd(params, cfg: ArchConfig, x, states=None):
    """The pairs over a whole sequence. The reference scans over them, so
    the residual it carries from pair to pair is rounded to bf16, and only
    the sum inside a pair reaches its norm unrounded (``add_rms_norm``).
    ``states``: a list that receives each pair's final (mLSTM, sLSTM)
    state."""
    for g in range(cfg.n_layers // 2):
        bp = pair(params, g)
        keep = states is not None
        y = mlstm_fwd(bp["mlstm"], cfg,
                      cm.rms_norm(x, bp["norm_m"], cfg.norm_eps),
                      return_state=keep)
        if keep:
            y, mst = y
        x, xin = add_rms_norm(x, y, bp["norm_s"], cfg.norm_eps)
        y = slstm_fwd(bp["slstm"], cfg, xin, return_state=keep)
        if keep:
            y, sst = y
            states.append((mst, sst))
        x = x + y
    return cm.rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params, cfg: ArchConfig, tokens):
    """The training forward: (B, T) tokens -> (B, T, V) bf16 logits."""
    x = _pairs_fwd(params, cfg, tfm.embed_tokens(params, cfg, tokens))
    return tfm.logits_head(params, cfg, x)


# ------------------------------------------------------------------ serving

def init_state(cfg: ArchConfig, batch: int, max_len: int = 0,
               device="cuda"):
    """Zero recurrent state of the G pairs (``max_len`` is unused: the state
    does not grow with the sequence)."""
    dev = resolve_device(device)
    G, H = cfg.n_layers // 2, cfg.n_heads
    dh = cfg.ssm_d_inner // H

    def z(*s):
        return torch.zeros((G, batch) + s, dtype=torch.float32, device=dev)
    return {"mlstm": {"S": z(H, dh, dh), "n": z(H, dh), "m": z(H)},
            "slstm": {"c": z(H, dh), "n": z(H, dh), "h": z(H, dh),
                      "m": z(H, dh)},
            "cur": 0}


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, cache, token):
    """One decode step. token: (B, 1) integer. Returns (logits (B, 1, V),
    cache): the state's tensors are updated in place and ``cur`` advances
    by one. The residual adds and norms are taken as in ``forward``
    (``add_rms_norm``), as the reference's jitted ``decode_step`` does."""
    x = tfm.embed_tokens(params, cfg, token)
    for g in range(cfg.n_layers // 2):
        bp = pair(params, g)
        mst = {k: v[g] for k, v in cache["mlstm"].items()}
        sst = {k: v[g] for k, v in cache["slstm"].items()}
        y, mst = mlstm_step(bp["mlstm"], cfg,
                            cm.rms_norm(x, bp["norm_m"], cfg.norm_eps), mst)
        x, xin = add_rms_norm(x, y, bp["norm_s"], cfg.norm_eps)
        y, sst = slstm_step(bp["slstm"], cfg, xin, sst)
        x = x + y
        for name, new in (("mlstm", mst), ("slstm", sst)):
            for k, v in new.items():
                cache[name][k][g] = v
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.logits_head(params, cfg, x), {
        "mlstm": cache["mlstm"], "slstm": cache["slstm"],
        "cur": int(cache["cur"]) + 1}


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens):
    """Run the prompt; returns (last-position logits (B, 1, V), the state
    after it, for ``decode_step``)."""
    states = []
    x = _pairs_fwd(params, cfg, tfm.embed_tokens(params, cfg, tokens),
                   states)
    logits = tfm.logits_head(params, cfg, x[:, -1:])
    stack = {name: {k: torch.stack([s[i][k] for s in states])
                    for k in states[0][i]}
             for i, name in enumerate(("mlstm", "slstm"))}
    return logits, {**stack, "cur": tokens.shape[1]}
