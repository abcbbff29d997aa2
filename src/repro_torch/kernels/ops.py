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
import functools
import math
from typing import Dict, NamedTuple, Optional

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


def _check(cond: bool, what) -> None:
    """Raise ``ValueError(what)`` unless ``cond``; ``what`` may be a
    callable that builds the message, so that the serving step's per-call
    checks format no strings when they pass."""
    if not cond:
        raise ValueError(what() if callable(what) else what)


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")


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
        _check(t.dtype == torch.float32,
               lambda: f"{name}: {key} is {t.dtype}")
    vecs = [t.contiguous() for t in (v_f, v_r, b_f, b_r)]
    for t in vecs:
        _check(tuple(t.shape) == (n,),
               lambda: f"{name}: vector shape {tuple(t.shape)}")
    h = torch.empty((P, B, T, n), dtype=torch.float32, device=dev)
    r = torch.empty_like(h)
    c_last = torch.empty((P, B, n), dtype=torch.float32, device=dev)
    if h.numel() == 0:     # T == 0 leaves c at its zero start; an empty
        return h, r, c_last.zero_(), False   # stream's strides mean nothing
    lds = {_stream_ld(t, (P, B, T, n)) for t in (uw, uf, ur)}
    _check(len(lds) == 1,
           lambda: f"{name}: streams have different row strides {lds}")
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


class BankConfig(NamedTuple):
    """One block-tile configuration of ``csrc/bank_gemm.cuh``: a BM x BN
    output tile, K in steps of BK through a ring of ``stages`` shared-memory
    stages, TM x 8 outputs per thread, and the blocks per SM its launch
    bounds promise."""
    bm: int
    bn: int
    bk: int
    tm: int
    stages: int
    threads: int
    min_blocks: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one ``bank_mxv_pop`` block: the ring of
        k-major x tiles (rows of BM + 4 floats) and of f32 B tiles.
        ``bank_qmm_pop`` adds BN floats of column scales."""
        return 4 * self.stages * (self.bk * (self.bm + 4) + self.bk * self.bn)


# In bank_gemm.cuh's order (Config0, Config1, Config2)
BANK_CONFIGS = (
    BankConfig(128, 128, 16, 16, 4, 128, 2),   # the search: 1536 rows/lane
    BankConfig(128, 64, 16, 8, 3, 128, 3),     # the same, smaller tiles
    BankConfig(16, 64, 16, 2, 4, 64, 8),       # the serving step: 16 rows
)
SMEM_PER_BLOCK = 232448          # H100: 227 KB of dynamic shared memory
SMALL_M = 32                     # rows per lane up to which 16-row tiles win
# The 128 x 64 tile's cost per output against the 128 x 128 tile's, fitted
# to chip_smoke.py's timings of every configuration at the search shapes
# (PERF.md): for bank_mxv_pop it reads 1.0 byte of shared memory per FMA
# against 0.75; bank_qmm_pop's per-tile loads and dequantization hide
# better behind its three blocks an SM than behind two.
NARROW_COST = {"bank_mxv_pop": 1.04, "bank_qmm_pop": 0.92}


def bank_config(P: int, M: int, N: int, sms: int = 132,
                kernel: str = "bank_mxv_pop") -> int:
    """The bank GEMM configuration for ``kernel`` on P lanes of an (M, m) x
    (m, N) product on a card with ``sms`` SMs: the 16-row tile where a lane
    has at most ``SMALL_M`` rows (the serving step), else the 128-row tile
    whose grid costs the least: waves of ``sms * min_blocks`` blocks, each
    wave costing an SM ``min_blocks`` tiles' area, the 128 x 64 tile's area
    weighted by ``NARROW_COST[kernel]`` (Pr, N = 256 at P = 16, fills 2
    waves of 128 x 64 tiles better than 1.45 of 128 x 128). A tie goes to
    the larger tile."""
    if M <= SMALL_M:
        return 2

    def cost(i):
        c = BANK_CONFIGS[i]
        blocks = P * math.ceil(M / c.bm) * math.ceil(N / c.bn)
        waves = math.ceil(blocks / (sms * c.min_blocks))
        return (waves * c.min_blocks * c.bm * c.bn
                * (NARROW_COST[kernel] if i == 1 else 1.0))

    return 1 if cost(1) < cost(0) else 0


def copy_width(*quantities: int, widths=(16, 8, 4)) -> int:
    """The widest copy in ``widths`` (powers of two, widest first, in bytes)
    that divides every quantity: row strides in bytes and base addresses,
    so that no vector crosses a row end or starts misaligned."""
    bits = 0
    for q in quantities:
        bits |= q
    common = bits & -bits if bits else widths[0]   # largest power of 2
    for w in widths:
        if w <= common:
            return w
    raise ValueError(f"no copy width of {widths} divides {quantities}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bank_config_for(name, dev, P, M, N, config):
    if config is None:
        return bank_config(P, M, N, _sm_count(dev.index), name)
    _check(0 <= config < len(BANK_CONFIGS),
           f"{name}: config {config} not in 0..{len(BANK_CONFIGS) - 1}")
    return config


def bank_config_info(config: int) -> BankConfig:
    """Configuration ``config`` as the built library holds it, read back to
    hold ``BANK_CONFIGS`` to the CUDA source; raises if the library's
    shared-memory size is not ``BankConfig.smem_bytes``."""
    out = (ctypes.c_int * 8)()
    err = build.load().repro_bank_config_info(config, ctypes.cast(
        out, ctypes.c_void_p))
    _raise_on(err, "bank_config_info")
    cfg = BankConfig(*out[:7])
    _check(cfg.smem_bytes == out[7], f"config {config}: {out[7]} bytes of "
           f"shared memory in the library, {cfg.smem_bytes} by BankConfig")
    return cfg


def _check_mxv_x(name, x, idx, m):
    _check(x.dtype == torch.float32 and x.ndim == 3 and x.is_contiguous(),
           lambda: f"{name}: x must be contiguous (P, M, m) f32, got "
           f"{x.dtype} {tuple(x.shape)}")
    _check(x.shape[2] == m,
           lambda: f"{name}: x width {x.shape[2]} != bank rows {m}")
    _check(idx.dtype == torch.int32 and tuple(idx.shape) == (x.shape[0],)
           and idx.is_contiguous(),
           lambda: f"{name}: idx must be contiguous ({x.shape[0]},) int32, "
           f"got {idx.dtype} {tuple(idx.shape)}")


def bank_mxv_pop(x, bank, idx, config: Optional[int] = None):
    """Population MxV against a quantized-weight bank: x (P, M, m) f32,
    bank (K, m, N) f32 (the K menu-entry fake-quantizations of one weight),
    idx (P,) int32 menu indices. Returns (P, M, N), ``out[p] = x[p] @
    bank[idx[p]]``. The kernel reads the selected row in place; no (P, m, N)
    gathered copy exists. A lane whose index is out of range gets NaN.
    ``config`` forces a tile configuration (``BANK_CONFIGS``) on the card;
    by default ``bank_config`` picks one. Every configuration gives bitwise
    the same output."""
    if x.device.type == "cpu":
        return ref.bank_mxv_pop_ref(x, bank, idx)
    name = "bank_mxv_pop"
    dev = x.device
    _check_cuda(name, dev, bank=bank, idx=idx)
    _check(bank.dtype == torch.float32 and bank.ndim == 3
           and bank.is_contiguous(),
           lambda: f"{name}: bank must be contiguous (K, m, N) f32, got "
           f"{bank.dtype} {tuple(bank.shape)}")
    K, m, N = bank.shape
    _check_mxv_x(name, x, idx, m)
    P, M, _ = x.shape
    out = torch.empty((P, M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0 or m == 0:
        return out.zero_()
    cfg = _bank_config_for(name, dev, P, M, N, config)
    width = copy_width(4 * N, bank.data_ptr())
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.repro_bank_mxv_pop(_ptr(x), _ptr(bank), _ptr(idx), _ptr(out),
                                     P, M, m, N, K, cfg, width, _stream(dev))
    _raise_on(err, name)
    bank_mxv_pop.launches += 1
    return out


def bank_qmm_pop(x, packed, idx, config: Optional[int] = None):
    """Population MxV against a PACKED bank
    (``quantization.build_packed_weight_bank`` dict for a (m, N) weight):
    x (P, M, m) f32, idx (P,) int32 menu indices in ``SUPPORTED_BITS``
    order. Returns (P, M, N), ``out[p] = x[p] @ dequant(packed)[idx[p]]``.
    The kernel reads only the selected container and dequantizes it on the
    way to shared memory; the (4, 1) scale column is read as it is stored.
    ``config`` as for ``bank_mxv_pop``."""
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
        if not (t.device == dev and t.dtype == dtype
                and t.shape == (rows[key], N) and t.is_contiguous()):
            _check_cuda(name, dev, **{key: t})
            raise ValueError(f"{name}: {key} must be contiguous "
                             f"({rows[key]}, {N}) {dtype}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    scale = packed["scale"]
    _check_cuda(name, dev, scale=scale)
    _check(scale.dtype == torch.float32 and scale.ndim == 2
           and scale.shape[0] == 4 and scale.shape[1] in (1, N)
           and scale.is_contiguous(),
           lambda: f"{name}: scale must be contiguous (4, 1) or (4, {N}) f32,"
           f" got {scale.dtype} {tuple(scale.shape)}")
    P, M, _ = x.shape
    out = torch.empty((P, M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0 or m == 0:
        return out.zero_()
    cfg = _bank_config_for(name, dev, P, M, N, config)
    width8 = copy_width(N, *(packed[k].data_ptr() for k in ("q2", "q4", "q8")),
                        widths=(16, 8, 4, 2, 1))
    width16 = copy_width(2 * N, packed["q16"].data_ptr(),
                         widths=(16, 8, 4, 2))
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.repro_bank_qmm_pop(
            _ptr(x), _ptr(packed["q2"]), _ptr(packed["q4"]), _ptr(q8),
            _ptr(packed["q16"]), _ptr(scale), scale.shape[1], _ptr(idx),
            _ptr(out), P, M, m, N, cfg, width8, width16, _stream(dev))
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


def quant_matmul_occupancy(M: int, N: int, bits: int) -> Dict[str, int]:
    """The card's view of a ``quant_matmul`` launch on (M, K) x (K, N):
    its ``blocks`` and the ``blocks_per_sm`` the runtime's occupancy
    calculator lets share an SM (registers, shared memory and threads)."""
    out = (ctypes.c_int * 2)()
    err = build.load().repro_quant_matmul_occupancy(
        M, N, bits, ctypes.cast(out, ctypes.c_void_p))
    _raise_on(err, "quant_matmul_occupancy")
    return {"blocks": out[0], "blocks_per_sm": out[1]}


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
