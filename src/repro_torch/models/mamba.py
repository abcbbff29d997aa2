"""Mamba (S6 selective state space) block: the chunked training and prefill
form, and the single-step recurrence of decode.

Port of the reference package's ``models/mamba.py``. The diagonal
recurrence h_t = a_t h_{t-1} + b_t runs over time-chunks of
``cfg.ssm_chunk`` steps: the state is carried from chunk to chunk in a
Python loop, and within a chunk the recurrence is solved by a log-depth
(Hillis-Steele) scan with the reference's ``combine`` (8 doubling steps at
a chunk of 256), so the peak is (B, chunk, d_inner, N) f32 as there. The
reference's ``jax.lax.associative_scan`` pairs the products in another
tree, so the state differs from it by f32 roundings.

Dtypes follow the reference: ``in_proj`` and ``out_proj`` are bf16
products rounded once to bf16; ``x_proj`` keeps its f32 sum; ``dt_proj``
is an f32 product (run it with TF32 off on the card); the conv, its SiLU
and the gate arithmetic round every bf16 operation, as XLA does on the CPU
for the reference, jitted and op by op alike (``common.silu``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import shard
from repro_torch.models import common as cm
from repro_torch.roofline.counter import fill_trips, trips

# the logical axes of each leaf (the reference's ``mamba_axes()``)
MAMBA_AXES = {
    "in_proj": ("embed", "ssm_inner"),
    "conv_w": (None, "ssm_inner"),
    "x_proj": ("ssm_inner", None),
    "dt_proj": (None, "ssm_inner"),
    "dt_bias": ("ssm_inner",),
    "A_log": ("ssm_inner", "ssm_state"),
    "D_skip": ("ssm_inner",),
    "out_proj": ("ssm_inner", "embed"),
}


def mamba_axes():
    return dict(MAMBA_AXES)


def init_mamba(generator, cfg, stack=()) -> Dict[str, torch.Tensor]:
    """One Mamba mixer's weights (``stack``: leading shape of stacked
    layers): the reference's scales, S4D-real ``A_log`` = log(1..N) per
    channel, ``dt_bias`` = softplus^-1(0.01), ``D_skip`` = 1."""
    D, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state
    R = max(1, math.ceil(D / 16))             # dt_rank
    st = tuple(stack)
    dev = generator.device
    # numpy's float32 log gives XLA's bits (torch.log differs at log(7))
    A_log = torch.from_numpy(np.log(np.arange(1, N + 1, dtype=np.float32)))
    return {
        "in_proj": cm.normal_init(generator, st + (D, 2 * di),
                                  1.0 / math.sqrt(D)),
        "conv_w": cm.normal_init(generator, st + (cfg.ssm_d_conv, di), 0.1),
        "x_proj": cm.normal_init(generator, st + (di, R + 2 * N),
                                 1.0 / math.sqrt(di)),
        "dt_proj": cm.normal_init(generator, st + (R, di),
                                  1.0 / math.sqrt(R), torch.float32),
        "dt_bias": torch.full(st + (di,), -4.6, dtype=torch.float32,
                              device=dev),
        "A_log": A_log.to(dev).expand(st + (di, N)).clone(),
        "D_skip": torch.ones(st + (di,), dtype=torch.float32, device=dev),
        "out_proj": cm.normal_init(generator, st + (di, D),
                                   1.0 / math.sqrt(di)),
    }


def _causal_conv(p, cfg, x, init_state=None):
    """Depthwise causal conv over time, then SiLU. x: (B, T, di) bf16;
    ``init_state``: the previous K-1 inputs (B, K-1, di), zeros if None.
    Returns (conv output, the last K-1 inputs)."""
    K = cfg.ssm_d_conv
    if init_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = xp[:, 0:T] * p["conv_w"][0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * p["conv_w"][i]
    return cm.silu(out), xp[:, xp.shape[1] - (K - 1):]


def _gates(p, cfg, x):
    """x: (B, T, di) after the conv. Returns dt (softplus of the f32
    ``dt_proj`` product plus bias), B and C, all f32."""
    N = cfg.ssm_d_state
    dbc = torch.matmul(x.to(torch.float32), p["x_proj"].to(torch.float32))
    R = dbc.shape[-1] - 2 * N
    dt, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    pre = torch.matmul(dt, p["dt_proj"]) + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros((), dtype=pre.dtype,
                                          device=pre.device))
    return dt, Bm, Cm


def _scan_chunk(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 (Hillis-Steele,
    log2(chunk) doubling steps), with the reference's ``combine(l, r) =
    (l.a * r.a, l.b * r.a + r.b)``. Returns (a_cum, b_cum)."""
    off, c = 1, a.shape[1]
    while off < c:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


def mamba_fwd(p, cfg, h, return_state: bool = False):
    """Training / prefill forward. h: (B, T, D) bf16 -> (B, T, D) bf16, and
    with ``return_state`` the decode state {"h": (B, di, N) f32, "conv":
    (B, K-1, di)} after the last step. T is right-padded to a chunk
    multiple with dt = 0 (so a = 1 and b = 0 there: the state passes the
    pad steps unchanged)."""
    B, T, D = h.shape
    chunk = min(cfg.ssm_chunk, T)
    nch = -(-T // chunk)
    pad = nch * chunk - T
    di = cfg.ssm_d_inner

    xz = shard(cm.dense(h, p["in_proj"]), "batch", "seq", "ssm_inner")
    x, z = xz[..., :di], xz[..., di:]
    x, conv_tail = _causal_conv(p, cfg, x)
    dt, Bm, Cm = _gates(p, cfg, x)
    A = -torch.exp(p["A_log"])                                 # (di, N)
    xf = x.to(torch.float32)
    if pad:
        F = torch.nn.functional
        xf, dt = F.pad(xf, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))

    hstate = torch.zeros((B, di, cfg.ssm_d_state), dtype=torch.float32,
                         device=h.device)
    ys = []
    for c in trips(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        xk, dtk, Bk, Ck = xf[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        a = torch.exp(dtk[..., None] * A)                      # (B,c,di,N)
        b = (dtk * xk)[..., None] * Bk[..., None, :]
        a_cum, b_cum = _scan_chunk(a, b)
        hs = a_cum * hstate[:, None] + b_cum
        y = torch.einsum("bcdn,bcn->bcd", hs, Ck)
        ys.append(y + p["D_skip"] * xk)
        hstate = hs[:, -1]
    y = torch.cat(fill_trips(ys, nch), dim=1)[:, :T]
    y = (y * cm.silu(z.to(torch.float32))).to(h.dtype)
    y = shard(y, "batch", "seq", "ssm_inner")
    out = shard(cm.dense(y, p["out_proj"]), "batch", "seq", "embed")
    if return_state:
        return out, {"h": hstate, "conv": conv_tail}
    return out


def mamba_step(p, cfg, h, state) -> Tuple[torch.Tensor, Dict]:
    """Decode step. h: (B, 1, D); state = {"h": (B, di, N) f32, "conv":
    (B, K-1, di)}. Returns (out (B, 1, D), new state)."""
    di = cfg.ssm_d_inner
    xz = cm.dense(h, p["in_proj"])
    x, z = xz[..., :di], xz[..., di:]
    x, new_conv = _causal_conv(p, cfg, x, init_state=state["conv"])
    dt, Bm, Cm = _gates(p, cfg, x)
    A = -torch.exp(p["A_log"])
    x0 = x[:, 0].to(torch.float32)
    a = torch.exp(dt[:, 0, :, None] * A)                       # (B,di,N)
    b = (dt[:, 0] * x0)[..., None] * Bm[:, 0, None, :]
    hs = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", hs, Cm[:, 0])
    y = y + p["D_skip"] * x0
    y = (y * cm.silu(z[:, 0].to(torch.float32))).to(h.dtype)
    out = cm.dense(y[:, None], p["out_proj"])
    return out, {"h": hs, "conv": new_conv.to(state["conv"].dtype)}
