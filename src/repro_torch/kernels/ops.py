"""Public wrappers around the port's CUDA kernels.

Port of the reference package's ``kernels/ops.py``. Each wrapper dispatches
on where its tensors lie:

- on the CPU it runs the kernel's plain PyTorch version
  (``kernels/ref.py``), which is how the tests reach the kernel lanes;
- on a CUDA device it checks device, dtype, shape and layout, allocates the
  outputs with ``torch.empty``, launches the kernel on the current stream
  without synchronising, and raises if the build or the launch fails. There
  is no fallback from the card to the plain version.

Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, incremented only where the kernel is launched;
``reset_launch_counts``/``launch_counts`` read and clear them all.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.quantization import INT_RANGES, _f32
from repro_torch.kernels import build
from repro_torch.kernels import ref

_CONTAINERS = (("q2", torch.int8), ("q4", torch.int8), ("q8", torch.int8),
               ("q16", torch.int16))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    # The launch is asynchronous and the caller may drop its tensors at once:
    # safe, because the caching allocator only reuses a block for work on
    # the same stream, which runs after the kernel.
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        _check(t.device == dev, f"{name}: {key} on {t.device}, expected {dev}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _stream_ld(t: torch.Tensor, shape) -> int:
    """Row stride of a stream whose channels are contiguous and whose rows
    are evenly spaced (a contiguous array, or a column slice of one)."""
    _check(tuple(t.shape) == tuple(shape),
           f"stream shape {tuple(t.shape)} != {tuple(shape)}")
    *lead, n = shape
    st = t.stride()
    _check(st[-1] == 1, f"stream channels not contiguous, strides {st}")
    ld = st[-2]
    _check(ld >= n, f"stream row stride {ld} < channels {n}")
    expect = ld
    for d in range(len(lead) - 2, -1, -1):
        expect *= lead[d + 1]
        # a size-1 axis is never stepped over, so its stride is free
        _check(lead[d] == 1 or st[d] == expect,
               f"stream strides {st} are not evenly spaced rows of stride {ld}")
    return ld


def _launch_scan(uw, uf, ur, v_f, v_r, b_f, b_r):
    """Launch csrc/sru_scan_pop.cu on (P, B, T, n) streams."""
    name = "sru_scan_pop"
    dev = uw.device
    P, B, T, n = uw.shape
    _check_cuda(name, dev, uf=uf, ur=ur, v_f=v_f, v_r=v_r, b_f=b_f, b_r=b_r)
    for key, t in dict(uw=uw, uf=uf, ur=ur, v_f=v_f, v_r=v_r, b_f=b_f,
                       b_r=b_r).items():
        _check(t.dtype == torch.float32, f"{name}: {key} is {t.dtype}")
    lds = {_stream_ld(t, (P, B, T, n)) for t in (uw, uf, ur)}
    _check(len(lds) == 1, f"{name}: streams have different row strides {lds}")
    vecs = [t.contiguous() for t in (v_f, v_r, b_f, b_r)]
    for t in vecs:
        _check(tuple(t.shape) == (n,), f"{name}: vector shape {tuple(t.shape)}")
    h = torch.empty((P, B, T, n), dtype=torch.float32, device=dev)
    r = torch.empty_like(h)
    c_last = torch.empty((P, B, n), dtype=torch.float32, device=dev)
    if h.numel() == 0:                       # T == 0 leaves c at its zero start
        return h, r, c_last.zero_(), False
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.repro_sru_scan_pop(
            _ptr(uw), _ptr(uf), _ptr(ur), lds.pop(),
            *(_ptr(t) for t in vecs), _ptr(h), _ptr(r), _ptr(c_last),
            P, B, T, n, _stream(dev))
    _raise_on(err, name)
    return h, r, c_last, True


def sru_scan_pop(uw, uf, ur, v_f, v_r, b_f, b_r):
    """Population SRU scan. uw/uf/ur: (P, B, T, n) f32, one quantization
    lane each; v/b: (n,) f32 shared. Returns (h, r, c_last). The streams
    may be column slices of one (P, B, T, 3n) MxV output; the caller
    applies the highway skip and the backward direction's time flips."""
    if uw.device.type == "cpu":
        return ref.sru_scan_pop_ref(uw, uf, ur, v_f, v_r, b_f, b_r)
    h, r, c, launched = _launch_scan(uw, uf, ur, v_f, v_r, b_f, b_r)
    sru_scan_pop.launches += int(launched)
    return h, r, c


def sru_scan(uw, uf, ur, v_f, v_r, b_f, b_r):
    """Single-lane SRU scan: (B, T, n) streams -> h, r (B, T, n), c_last
    (B, n). On the card it launches the population kernel with P = 1."""
    if uw.device.type == "cpu":
        return ref.sru_scan_ref(uw, uf, ur, v_f, v_r, b_f, b_r)
    h, r, c, launched = _launch_scan(uw[None], uf[None], ur[None],
                                     v_f, v_r, b_f, b_r)
    sru_scan.launches += int(launched)
    return h[0], r[0], c[0]


def _check_mxv_x(name, x, idx, m):
    _check(x.dtype == torch.float32 and x.ndim == 3 and x.is_contiguous(),
           f"{name}: x must be contiguous (P, M, m) f32, got "
           f"{x.dtype} {tuple(x.shape)}")
    _check(x.shape[2] == m, f"{name}: x width {x.shape[2]} != bank rows {m}")
    _check(idx.dtype == torch.int32 and tuple(idx.shape) == (x.shape[0],)
           and idx.is_contiguous(),
           f"{name}: idx must be contiguous ({x.shape[0]},) int32, got "
           f"{idx.dtype} {tuple(idx.shape)}")


def bank_mxv_pop(x, bank, idx):
    """Population MxV against a quantized-weight bank: x (P, M, m) f32,
    bank (K, m, N) f32 (the K menu-entry fake-quantizations of one weight),
    idx (P,) int32 menu indices. Returns (P, M, N), ``out[p] = x[p] @
    bank[idx[p]]``. The kernel reads the selected row in place; no (P, m, N)
    gathered copy exists. A lane whose index is out of range gets NaN."""
    if x.device.type == "cpu":
        return ref.bank_mxv_pop_ref(x, bank, idx)
    name = "bank_mxv_pop"
    dev = x.device
    _check_cuda(name, dev, bank=bank, idx=idx)
    _check(bank.dtype == torch.float32 and bank.ndim == 3
           and bank.is_contiguous(),
           f"{name}: bank must be contiguous (K, m, N) f32, got "
           f"{bank.dtype} {tuple(bank.shape)}")
    K, m, N = bank.shape
    _check_mxv_x(name, x, idx, m)
    P, M, _ = x.shape
    out = torch.empty((P, M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0 or m == 0:
        return out.zero_()
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.repro_bank_mxv_pop(_ptr(x), _ptr(bank), _ptr(idx), _ptr(out),
                                     P, M, m, N, K, _stream(dev))
    _raise_on(err, name)
    bank_mxv_pop.launches += 1
    return out


def bank_qmm_pop(x, packed, idx):
    """Population MxV against a PACKED bank
    (``quantization.build_packed_weight_bank`` dict for a (m, N) weight):
    x (P, M, m) f32, idx (P,) int32 menu indices in ``SUPPORTED_BITS``
    order. Returns (P, M, N), ``out[p] = x[p] @ dequant(packed)[idx[p]]``.
    The kernel reads only the selected container and dequantizes it on the
    way to shared memory; the (4, 1) scale column is read as it is stored."""
    if x.device.type == "cpu":
        return ref.bank_qmm_pop_ref(x, packed, idx)
    name = "bank_qmm_pop"
    dev = x.device
    q8 = packed["q8"]
    m, N = q8.shape
    _check_mxv_x(name, x, idx, m)
    rows = {"q2": (m + 3) // 4, "q4": (m + 1) // 2, "q8": m, "q16": m}
    for key, dtype in _CONTAINERS:
        t = packed[key]
        _check_cuda(name, dev, **{key: t})
        _check(t.dtype == dtype and tuple(t.shape) == (rows[key], N)
               and t.is_contiguous(),
               f"{name}: {key} must be contiguous ({rows[key]}, {N}) {dtype},"
               f" got {t.dtype} {tuple(t.shape)}")
    scale = packed["scale"]
    _check_cuda(name, dev, scale=scale)
    _check(scale.dtype == torch.float32 and scale.ndim == 2
           and scale.shape[0] == 4 and scale.shape[1] in (1, N)
           and scale.is_contiguous(),
           f"{name}: scale must be contiguous (4, 1) or (4, {N}) f32, got "
           f"{scale.dtype} {tuple(scale.shape)}")
    P, M, _ = x.shape
    out = torch.empty((P, M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0 or m == 0:
        return out.zero_()
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.repro_bank_qmm_pop(
            _ptr(x), _ptr(packed["q2"]), _ptr(packed["q4"]), _ptr(q8),
            _ptr(packed["q16"]), _ptr(scale), scale.shape[1], _ptr(idx),
            _ptr(out), P, M, m, N, _stream(dev))
    _raise_on(err, name)
    bank_qmm_pop.launches += 1
    return out


def bank_step(x, bank, idx):
    """Bank-gather MxV front door: a packed dict bank goes to
    ``bank_qmm_pop``, an f32 (K, m, N) stack to ``bank_mxv_pop``."""
    if isinstance(bank, dict):
        return bank_qmm_pop(x, bank, idx)
    return bank_mxv_pop(x, bank, idx)


def pack_for_kernel(w, bits: int, clip: float):
    """Quantize and pack a (K, N) weight for ``quant_matmul``: per-column
    scales ``min(max|w[:, c]|, clip) / hi`` and codes
    ``clip(round(w / scale), lo, hi)`` packed along K
    (``ref.pack_weights``). Returns (packed (ceil(K * bits / 8), N) int8,
    scales (N,) f32), bitwise the reference's for the same f32 weight."""
    lo, hi = INT_RANGES[bits]
    w = w.to(torch.float32)
    absmax = torch.clamp(torch.max(torch.abs(w), dim=0).values, min=1e-9)
    scales = torch.minimum(absmax, _f32(clip, w)) / _f32(hi, w)
    q = torch.clamp(torch.round(w / scales[None, :]), lo, hi).to(torch.int8)
    return ref.pack_weights(q, bits), scales


def _check_qmm(x, packed_w, scales, bits):
    name = "quant_matmul"
    _check(bits in (2, 4, 8), f"{name}: bits must be 2, 4 or 8, got {bits}")
    _check(x.dtype == torch.float32 and x.ndim == 2,
           f"{name}: x must be (M, K) f32, got {x.dtype} {tuple(x.shape)}")
    _check(packed_w.dtype == torch.int8 and packed_w.ndim == 2,
           f"{name}: packed_w must be 2-D int8, got {packed_w.dtype} "
           f"{tuple(packed_w.shape)}")
    K = x.shape[1]
    rows = -(-K * bits // 8)
    _check(packed_w.shape[0] == rows,
           f"{name}: packing misaligned for bits={bits}: K={K} needs "
           f"ceil(K*bits/8)={rows} packed rows, got {packed_w.shape[0]}")
    N = packed_w.shape[1]
    _check(scales.dtype == torch.float32 and tuple(scales.shape) == (N,),
           f"{name}: scales must be ({N},) f32, got {scales.dtype} "
           f"{tuple(scales.shape)}")


def quant_matmul(x, packed_w, scales, bits: int):
    """y = x @ (unpack(packed_w, bits) * scales[None, :]): x (M, K) f32,
    packed_w (ceil(K * bits / 8), N) int8 (``pack_for_kernel``), scales
    (N,) f32, bits in {2, 4, 8}. Returns (M, N) f32. Shapes and packing
    that do not fit raise ``ValueError`` on every device."""
    _check_qmm(x, packed_w, scales, bits)
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, packed_w, scales, bits)
    name = "quant_matmul"
    dev = x.device
    _check_cuda(name, dev, packed_w=packed_w, scales=scales)
    _check(x.is_contiguous() and packed_w.is_contiguous()
           and scales.is_contiguous(), f"{name}: inputs must be contiguous")
    M, K = x.shape
    N = packed_w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.repro_quant_matmul(_ptr(x), _ptr(packed_w), _ptr(scales),
                                     _ptr(out), M, K, N, bits, _stream(dev))
    _raise_on(err, name)
    quant_matmul.launches += 1
    return out


WRAPPERS = (sru_scan_pop, sru_scan, bank_mxv_pop, bank_qmm_pop, quant_matmul)
for _fn in WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
