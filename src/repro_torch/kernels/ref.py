"""Plain PyTorch versions of every kernel of the port, and the
packed-weight bit layout.

Port of the reference package's ``kernels/ref.py``. These functions are the
semantics the CUDA kernels in ``csrc/`` are held to: the CPU lanes and the
tests run them, and ``chip_smoke.py`` compares each kernel with its plain
version on the card. Nothing on the CUDA main path calls them. Run them on
the card only with TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
False``), or ``torch.bmm`` rounds its inputs to 10 mantissa bits.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

MENU_BITS = (2, 4, 8, 16)       # bank row order, as quantization.SUPPORTED_BITS
_PACK_BITS = (2, 4)


def unpack_weights(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Unpack int8-container sub-byte weights along axis 0.

    packed: (ceil(K * bits / 8), N) int8 -> (K, N) int8 signed values.
    Layout (bits=4): byte b holds rows 2b (low nibble) and 2b+1 (high).
    Layout (bits=2): byte b holds rows 4b..4b+3, 2 bits each, low-first.
    """
    if bits == 8:
        return packed[:k]
    per = 8 // bits
    u = packed.view(torch.uint8).to(torch.int16)
    shifts = torch.arange(per, dtype=torch.int16, device=packed.device) * bits
    vals = (u[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    sign_bit = 1 << (bits - 1)
    signed = vals - ((vals & sign_bit) != 0).to(torch.int16) * (1 << bits)
    return signed.to(torch.int8).reshape(-1, packed.shape[1])[:k]


def pack_weights(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of unpack_weights. q: (K, N) integer codes in the bits-range."""
    if bits == 8:
        return q.to(torch.int8)
    per = 8 // bits
    K, N = q.shape
    pad = (-K) % per
    if pad:
        q = torch.cat([q, torch.zeros((pad, N), dtype=q.dtype,
                                      device=q.device)])
    u = (q.to(torch.int32) & ((1 << bits) - 1)).reshape(-1, per, N)
    out = torch.zeros((u.shape[0], N), dtype=torch.int32, device=q.device)
    for r in range(per):
        out |= u[:, r] << (bits * r)
    return out.to(torch.uint8).view(torch.int8)


def dequant_packed_rows(packed: Dict[str, torch.Tensor],
                        bits_menu: Sequence[int] = MENU_BITS) -> torch.Tensor:
    """(|menu|, K, N) f32 rows of a packed bank: codes times each row's
    scale, one f32 multiply per element."""
    wide = packed[f"q{max(b for b in bits_menu if b not in _PACK_BITS)}"]
    k_dim = wide.shape[0]
    rows = []
    for k, bits in enumerate(bits_menu):
        codes = packed[f"q{bits}"]
        if bits in _PACK_BITS:
            codes = unpack_weights(codes, bits, k_dim)
        rows.append(codes.to(torch.float32) * packed["scale"][k][None, :])
    return torch.stack(rows)


def quant_matmul_ref(x, packed_w, scales, bits: int):
    """y = x @ (unpack(packed_w, bits) * scales[None, :]): x (M, K) f32;
    packed_w (ceil(K * bits / 8), N) int8; scales (N,) f32 per output
    channel. Each code is dequantized by one f32 multiply, then an f32
    matmul. Returns (M, N) f32."""
    k = x.shape[-1]
    w = unpack_weights(packed_w, bits, k).to(torch.float32) * scales[None, :]
    return torch.matmul(x.to(torch.float32), w)


def sru_scan_pop_ref(uw, uf, ur, v_f, v_r, b_f, b_r):
    """SRU element-wise recurrence (paper Eq. 2) over a population.

    uw/uf/ur: (P, B, T, n) f32; v_f, v_r, b_f, b_r: (n,) f32 shared by
    every lane. Returns (h, r, c_last): h/r (P, B, T, n), c_last (P, B, n).
        f_t = sigmoid(uf_t + v_f * c_{t-1} + b_f)
        r_t = sigmoid(ur_t + v_r * c_{t-1} + b_r)
        c_t = f_t * c_{t-1} + (1 - f_t) * uw_t
        h_t = r_t * c_t
    The caller applies the highway skip h_t + (1 - r_t) * x_t."""
    P, B, T, n = uw.shape
    c = torch.zeros((P, B, n), dtype=torch.float32, device=uw.device)
    hs, rs = [], []
    for t in range(T):
        f = torch.sigmoid(uf[:, :, t] + v_f * c + b_f)
        r = torch.sigmoid(ur[:, :, t] + v_r * c + b_r)
        c = f * c + (1.0 - f) * uw[:, :, t]
        hs.append(r * c)
        rs.append(r)
    return torch.stack(hs, 2), torch.stack(rs, 2), c


def sru_scan_ref(uw, uf, ur, v_f, v_r, b_f, b_r):
    """Single-lane form: uw/uf/ur (B, T, n) -> h, r (B, T, n), c_last (B, n)."""
    h, r, c = sru_scan_pop_ref(uw[None], uf[None], ur[None],
                               v_f, v_r, b_f, b_r)
    return h[0], r[0], c[0]


def bank_mxv_pop_ref(x, bank, idx):
    """out[p] = x[p] @ bank[idx[p]]. x (P, M, m) f32, bank (K, m, N) f32,
    idx (P,) int -> (P, M, N) f32."""
    return torch.bmm(x, bank.index_select(0, idx.long()))


def bank_qmm_pop_ref(x, packed, idx):
    """out[p] = x[p] @ dequant(packed)[idx[p]]: unpack, scale, ``bmm``."""
    return bank_mxv_pop_ref(x, dequant_packed_rows(packed), idx)


def bank_step_ref(x, bank, idx):
    """Plain twin of ``ops.bank_step``: a packed dict bank goes to the
    packed MxV, a stack to the f32 one."""
    if isinstance(bank, dict):
        return bank_qmm_pop_ref(x, bank, idx)
    return bank_mxv_pop_ref(x, bank, idx)
