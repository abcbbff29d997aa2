"""Post-training quantization primitives (paper §4.1), in PyTorch.

Port of the reference package's ``core/quantization.py``:

- symmetric integer linear quantization with MMSE-selected clipping
  thresholds, ranges [-128,127] / [-8,7] / [-2,1] for 8/4/2 bits;
- 16-bit fixed point for recurrent vectors, biases and 16-bit layers;
- activation ranges from calibration (median of per-batch max-abs);
- the straight-through estimator as ``x + (q - x).detach()``.

Bitwise parity with the reference rests on three habits: ``torch.round``
rounds half to even like ``jnp.round``; every grid divides by its scale
(never multiplies by ``1/scale``); and every scale is a float32 tensor
before it meets the data, as the reference's traced triples are. On bf16
data each quantizer follows JAX's type promotion for its own grid: a
float32-array grid widens the data to float32 (``fake_quant_triple``), a
Python-float grid keeps bf16 arithmetic (``quantize_int``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref as kref

# paper's integer ranges
INT_RANGES: Dict[int, Tuple[int, int]] = {8: (-128, 127), 4: (-8, 7), 2: (-2, 1)}
SUPPORTED_BITS = (2, 4, 8, 16)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (Python/numpy scalar or tensor) as float32 on ``like``'s device."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def mmse_clip(x, bits: int, n_grid: int = 64) -> float:
    """MMSE clipping threshold: grid-search the clip value minimizing
    ||x - Q(x)||^2 (host numpy, as in the reference). A CUDA tensor is
    searched on its device instead (``_mmse_clip_on_device``)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            return _mmse_clip_on_device(x, bits, n_grid)
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float32)
    absmax = float(np.abs(x).max()) or 1.0
    lo, hi = INT_RANGES[bits]
    best_c, best_e = absmax, np.inf
    for frac in np.linspace(1.0 / n_grid, 1.0, n_grid):
        c = absmax * frac
        scale = c / hi
        q = np.clip(np.round(x / scale), lo, hi) * scale
        e = float(np.mean((x - q) ** 2))
        if e < best_e:
            best_e, best_c = e, c
    return best_c


@torch.no_grad()
def _mmse_clip_on_device(x: torch.Tensor, bits: int, n_grid: int) -> float:
    """``mmse_clip``'s search on a CUDA tensor: the same candidate clips
    (host ``linspace`` fractions of the same max |x|) and the first
    candidate of least error. The host divides float32 weights by a
    float64 scale, which numpy 2 computes in float64; so does this. Its
    mean sums in another order than numpy's, so it can pick another clip
    only where two candidates' errors agree to float64 rounding. On the
    51.6 M-weight head of xlstm-350m the host search takes minutes; this
    takes milliseconds."""
    x = x.detach().flatten().to(torch.float64)
    absmax = float(torch.max(torch.abs(x))) or 1.0
    lo, hi = INT_RANGES[bits]
    clips = [absmax * frac for frac in np.linspace(1.0 / n_grid, 1.0, n_grid)]
    errs = []
    for c in clips:
        # a tensor, not a Python scalar: CUDA would multiply by 1 / scale
        scale = torch.as_tensor(c / hi, dtype=torch.float64, device=x.device)
        q = torch.clamp(torch.round(x / scale), lo, hi) * scale
        errs.append(torch.mean(torch.square(x - q)))
    return clips[int(torch.argmin(torch.stack(errs)))]


def fixed_point_16(x: torch.Tensor) -> torch.Tensor:
    """16-bit fixed point: int bits sized to the range, rest sign+fraction."""
    absmax = torch.max(torch.abs(x))
    int_bits = torch.ceil(torch.log2(torch.clamp(absmax, min=1e-9)))
    int_bits = torch.clamp(int_bits, -14, 14)
    frac_bits = 15.0 - torch.clamp(int_bits, min=0.0)
    scale = torch.exp2(-frac_bits)
    lim = 2.0 ** 15 - 1
    return torch.clamp(torch.round(x / scale), -lim - 1, lim) * scale


def _is_narrow(x: torch.Tensor) -> bool:
    """True for a floating dtype narrower than float32 (bf16, f16)."""
    return x.dtype.is_floating_point and x.dtype.itemsize < 4


def _weak(v) -> bool:
    """True for a Python number, which JAX types weakly (it takes the other
    operand's dtype); numpy scalars and arrays are strongly typed."""
    return isinstance(v, (int, float)) and not isinstance(v, np.generic)


def quantize_int(x: torch.Tensor, bits: int, clip: float) -> torch.Tensor:
    """Symmetric linear integer fake-quant with clipping threshold ``clip``.
    On float32 data the grid scale is a float32 tensor, as in the
    reference.

    On bf16 data the result follows JAX's type promotion for ``clip``. A
    Python float (what the search and retraining pass) is weakly typed, so
    JAX keeps the arithmetic in bf16: XLA rounds the scale to bf16 once,
    and evaluates each bf16 operation in float32 and rounds its result back
    to bf16. The port spells out the same steps: the quotient is rounded to
    bf16 before ``round`` (round and clip of a bf16 value are exact), and
    the product once at the end. A numpy scalar is strongly typed: the
    float32 scale promotes the data, and the result is float32."""
    lo, hi = INT_RANGES[bits]
    scale = _f32(clip / hi, x)
    if _is_narrow(x) and _weak(clip):
        scale = scale.to(x.dtype).to(torch.float32)
        quot = (x.to(torch.float32) / scale).to(x.dtype).to(torch.float32)
        return (torch.clamp(torch.round(quot), lo, hi) * scale).to(x.dtype)
    if _is_narrow(x):
        x = x.to(torch.float32)
    return torch.clamp(torch.round(x / scale), lo, hi) * scale


def quantize_weight(w: torch.Tensor, bits: int, clip=None) -> torch.Tensor:
    """Fake-quantize a weight tensor to ``bits`` (paper menu: 2/4/8 int,
    16 fixed point); ``clip`` defaults to the MMSE clip."""
    if bits == 16:
        return fixed_point_16(w)
    if clip is None:
        clip = mmse_clip(w, bits)
    return quantize_int(w, bits, clip)


def ste(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the value of ``xq``, the gradient of
    ``x``."""
    return x + (xq - x).detach()


def ste_quantize_weight(w: torch.Tensor, bits: int, clip) -> torch.Tensor:
    """Binary-connect weight: quantized forward, full-precision gradient."""
    if bits == 16:
        return ste(w, fixed_point_16(w))
    return ste(w, quantize_int(w, bits, clip))


def quantize_activation(a: torch.Tensor, bits: int,
                        expected_range: float) -> torch.Tensor:
    """Activation fake-quant (STE) against a calibrated expected range. The
    16-bit grid's scale is a power of two derived on the host in numpy, as
    in the reference, so both packages land on the same grid bit for bit."""
    if bits == 16:
        int_bits = np.ceil(np.log2(max(expected_range, 1e-9)))
        frac_bits = 15.0 - max(int_bits, 0.0)
        # a numpy float64 scale: strongly typed, it widens bf16 data
        scale = _f32(2.0 ** (-frac_bits), a)
        lim = 2.0 ** 15 - 1
        af = a.to(torch.float32) if _is_narrow(a) else a
        q = torch.clamp(torch.round(af / scale), -lim - 1, lim) * scale
        return ste(a, q.to(a.dtype))
    return ste(a, quantize_int(a, bits, expected_range).to(a.dtype))


def quant_triple(bits: int, clip_or_range: float):
    """Any menu precision as a (scale, lo, hi) triple so one forward serves
    every allocation. 16-bit -> fixed-point grid. Host Python, copied."""
    if bits == 16:
        int_bits = int(np.ceil(np.log2(max(clip_or_range, 1e-9))))
        frac_bits = 15.0 - max(int_bits, 0)
        scale = 2.0 ** (-frac_bits)
        return (scale, -32768.0, 32767.0)
    lo, hi = INT_RANGES[bits]
    return (clip_or_range / hi, float(lo), float(hi))


def fake_quant_triple(x: torch.Tensor, scale, lo, hi,
                      use_ste: bool = True) -> torch.Tensor:
    """``clip(round(x / scale), lo, hi) * scale`` on a dynamic grid. The
    grid may be scalars or tensors broadcastable against ``x`` (one grid
    per population lane). ``use_ste`` returns ``x + (q - x).detach()``:
    the value can differ from ``q`` in the last ulp, exactly as the
    reference's ``x + stop_gradient(q - x)`` does.

    The reference's grid is a float32 array, which promotes bf16 data to
    float32 in JAX: the divide, round, clip and multiply run in float32
    and only ``q`` is cast back to ``x.dtype``. PyTorch would keep a bf16
    ``x`` in bf16 against a 0-dim grid, so ``x`` is widened here first."""
    scale, lo, hi = _f32(scale, x), _f32(lo, x), _f32(hi, x)
    xf = x.to(torch.float32) if _is_narrow(x) else x
    q = torch.clamp(torch.round(xf / scale), lo, hi) * scale
    q = q.to(x.dtype)
    return x + (q - x).detach() if use_ste else q


# ---------------------------------------------------- quantized-weight banks
#
# The menu is {2, 4, 8, 16} bits and every grid freezes after calibration,
# so a weight has at most |menu| fake-quantized forms in a whole search. A
# bank stacks them: row k is the weight under menu entry k. Rows are pure
# grid values (use_ste=False), the same expression every eval lane uses.

def build_weight_bank(w: torch.Tensor, triples) -> torch.Tensor:
    """(K, *w.shape) stack; row k is
    ``fake_quant_triple(w, *triples[k], use_ste=False)``. ``triples``:
    (K, 3) float32 (scale, lo, hi) rows from ``menu_triples``."""
    triples = np.asarray(triples, np.float32)
    return torch.stack([fake_quant_triple(w, t[0], t[1], t[2], use_ste=False)
                        for t in triples])


def menu_triples(bits_menu, clip_of_bits) -> np.ndarray:
    """(K, 3) float32 of ``quant_triple`` rows for a per-layer menu."""
    return np.asarray([quant_triple(b, clip_of_bits(b)) for b in bits_menu],
                      np.float32)


def menu_index_from_hi(w_hi: torch.Tensor,
                       bits_menu=SUPPORTED_BITS) -> torch.Tensor:
    """Map a grid-top value back to its menu slot (the bank row index).
    Each menu entry has a distinct, exactly representable ``hi`` (1, 7, 127
    for int grids; 32767 for the 16-bit grid), so the (P, L, 6) qp stack
    alone carries each lane's bit-width. Runs on ``w_hi``'s device."""
    tops = [32767.0 if b == 16 else float(INT_RANGES[b][1])
            for b in bits_menu]
    idx = torch.zeros(w_hi.shape, dtype=torch.int32, device=w_hi.device)
    for t in sorted(tops)[:-1]:
        idx = idx + (w_hi > t).to(torch.int32)
    return idx


# ------------------------------------------------ packed-integer weight banks
#
#     {"q2":  int8  (ceil(K/4), N)   4 codes/byte, kernels/ref.py layout
#      "q4":  int8  (ceil(K/2), N)   2 codes/byte
#      "q8":  int8  (K, N)
#      "q16": int16 (K, N)           fixed-point codes
#      "scale": f32 (|menu|, 1)}     the per-tensor grid scale of each row
#
# Codes are ``clip(round(w/s), lo, hi)`` on the f32 banks' triples and
# dequantization is one f32 multiply by the same scale, so
# ``dequant_packed_bank`` rebuilds the f32 bank bitwise.

_PACK_BITS = (2, 4)          # menu entries stored packed in int8 containers


def build_packed_weight_bank(w: torch.Tensor, triples,
                             bits_menu=SUPPORTED_BITS) -> Dict[str, torch.Tensor]:
    """Packed-integer bank of a 2-D ``w`` (contraction axis first)."""
    if w.ndim != 2:
        raise ValueError(f"packed banks require 2-D weights, got {tuple(w.shape)}")
    triples = np.asarray(triples, np.float32)
    if len(triples) != len(bits_menu):
        raise ValueError(f"{len(triples)} triples for menu {bits_menu}")
    bank = {}
    for k, bits in enumerate(bits_menu):
        s, lo, hi = (_f32(t, w) for t in triples[k])
        codes = torch.clamp(torch.round(w / s), lo, hi).to(
            torch.int16 if bits == 16 else torch.int8)
        if bits in _PACK_BITS:
            codes = kref.pack_weights(codes, bits)
        bank[f"q{bits}"] = codes
    bank["scale"] = torch.from_numpy(triples[:, 0:1].copy()).to(w.device)
    return bank


def dequant_packed_bank(packed: Dict[str, torch.Tensor],
                        bits_menu=SUPPORTED_BITS) -> torch.Tensor:
    """The (|menu|, K, N) f32 bank stack from a packed bank — bitwise equal
    to ``build_weight_bank`` on the same weight and triples."""
    return kref.dequant_packed_rows(packed, bits_menu)


def packed_bank_nbytes(bank) -> int:
    """Bytes a bank (packed dict, f32 stack or nested dict) occupies."""
    if isinstance(bank, torch.Tensor):
        return bank.numel() * bank.element_size()
    if isinstance(bank, dict):
        return sum(packed_bank_nbytes(v) for v in bank.values())
    return 0


class ActRangeCalibrator:
    """Records per-layer activation ranges; expected range = median of the
    observed max-abs values (paper: 70 sequences suffice)."""

    def __init__(self):
        self._ranges: Dict[str, list] = {}

    def observe(self, name: str, value: torch.Tensor) -> None:
        self._ranges.setdefault(name, []).append(
            float(torch.max(torch.abs(value))))

    def expected_ranges(self) -> Dict[str, float]:
        return {k: float(np.median(v)) for k, v in self._ranges.items()}


def compressed_bits(layer_weights: Dict[str, int], layer_bits: Dict[str, int],
                    vector_weights: int = 0) -> int:
    """Total model bits under a per-layer bit allocation; non-MxV vectors are
    16-bit (paper §4.1)."""
    total = sum(n * layer_bits[name] for name, n in layer_weights.items())
    return total + vector_weights * 16


def compression_ratio(layer_weights: Dict[str, int],
                      layer_bits: Dict[str, int],
                      vector_weights: int = 0,
                      base_bits: int = 32) -> float:
    n_all = sum(layer_weights.values()) + vector_weights
    return (n_all * base_bits) / compressed_bits(
        layer_weights, layer_bits, vector_weights)


# ---------------------------------------------------- param-tree quantization
#
# MOHAQ applied to LM decode: every >= 2-D float leaf of a param tree lives
# as int8 codes (8 bits) or packed int4 nibbles (4 bits) under one
# per-tensor symmetric scale, and is dequantized into use. The bits equal
# the reference's ``quantize_tree`` / ``dequantize_tree`` in both
# directions. Leaves are quantized and dequantized in chunks along their
# leading axis (the work is elementwise, so the bits do not change): at
# qwen2-moe-a2.7b's width one stacked expert leaf holds 4.15 G elements,
# and a float32 copy of it is 16.6 GB.

TREE_CHUNK_ELEMS = 1 << 26        # elements a chunk holds at most


def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and "q" in node and "scale" in node


def _quantizable(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and leaf.dtype in (torch.float32, torch.bfloat16))


def _chunks(n_rows: int, row_elems: int):
    """Slices of the leading axis, each of at most ``TREE_CHUNK_ELEMS``
    elements (one row at least)."""
    step = max(1, TREE_CHUNK_ELEMS // max(row_elems, 1))
    return [slice(i, min(i + step, n_rows)) for i in range(0, n_rows, step)]


def _leaf_scale(leaf: torch.Tensor, bits: int) -> torch.Tensor:
    """The per-tensor scale ``max(max|w|, 1e-9) / hi`` as a float32 tensor
    on the leaf's device, divided (never multiplied by a reciprocal); the
    max is exact in any order and dtype, so it is taken chunk by chunk."""
    hi = 127 if bits == 8 else 7
    row = leaf[0].numel()
    amax = torch.stack([leaf[s].abs().amax() for s in _chunks(len(leaf), row)]
                       ).amax().to(torch.float32)
    return torch.clamp(amax, min=1e-9) / _f32(hi, amax)


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int4 codes (int8 in [-8, 7]) packed two a byte along the last axis,
    the even element in the low nibble; an odd width gets a zero pad."""
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    u = q.view(torch.uint8)
    return ((u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)).view(
        torch.int8)


def _unpack_nibbles(q: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of ``_pack_nibbles``: sign-extended int8 codes, the pad
    column cut to ``width``."""
    u = q.view(torch.uint8)

    def signed(nib):
        nib = nib.to(torch.int8)
        return nib - ((nib & 0x8) != 0).to(torch.int8) * 16
    both = torch.stack([signed(u & 0xF), signed((u >> 4) & 0xF)], dim=-1)
    return both.reshape(q.shape[:-1] + (q.shape[-1] * 2,))[..., :width]


def _quantize_leaf(leaf: torch.Tensor, bits: int):
    """One leaf as ``{"q": int8 codes (int4: packed), "scale": f32[]}``."""
    hi = 127 if bits == 8 else 7
    scale = _leaf_scale(leaf, bits)
    width = leaf.shape[-1] if bits == 8 else -(-leaf.shape[-1] // 2)
    q = torch.empty(leaf.shape[:-1] + (width,), dtype=torch.int8,
                    device=leaf.device)
    for s in _chunks(len(leaf), leaf[0].numel()):
        codes = torch.clamp(torch.round(leaf[s].to(torch.float32) / scale),
                            -hi - 1, hi).to(torch.int8)
        q[s] = codes if bits == 8 else _pack_nibbles(codes)
    return {"q": q, "scale": scale}


def _dequantize_leaf(qleaf, spec, bits: int) -> torch.Tensor:
    """Inverse of ``_quantize_leaf``: ``codes * scale`` in float32, cast
    to ``spec``'s dtype (``spec``: anything with the original ``shape`` and
    ``dtype``, e.g. a meta tensor)."""
    q, scale = qleaf["q"], qleaf["scale"]
    out = torch.empty(tuple(spec.shape), dtype=spec.dtype, device=q.device)
    # a 1-D leaf (one layer of stacked norms) is one chunk: int4 packs its
    # only axis
    chunks = _chunks(len(q), q[0].numel()) if q.ndim > 1 else [slice(None)]
    for s in chunks:
        codes = q[s] if bits == 8 else _unpack_nibbles(q[s], spec.shape[-1])
        out[s] = (codes.to(torch.float32) * scale).to(spec.dtype)
    return out


def _check_bits(bits: int) -> None:
    if bits not in (8, 4):
        raise ValueError(f"tree quantization takes 8 or 4 bits, not {bits}")


def quantize_tree(params, bits: int):
    """Quantize every >= 2-D float leaf of a nested-dict param tree to
    ``bits`` (8 or 4) with a per-tensor symmetric scale; int4 packs two
    codes a byte along the last axis. Each quantized leaf becomes
    ``{"q": int8, "scale": f32[]}``; other leaves are kept as they are."""
    _check_bits(bits)
    if isinstance(params, dict):
        return {k: quantize_tree(v, bits) for k, v in params.items()}
    return _quantize_leaf(params, bits) if _quantizable(params) else params


def tree_spec(params):
    """The param tree as meta tensors: shapes and dtypes, no storage (the
    ``spec_tree`` of ``dequantize_tree``)."""
    if isinstance(params, dict):
        return {k: tree_spec(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return torch.empty(params.shape, dtype=params.dtype, device="meta")
    return params


def dequantize_tree(qtree, spec_tree, bits: int):
    """Inverse of ``quantize_tree``; ``spec_tree`` (``tree_spec`` of the
    original params) gives each leaf's shape and dtype. A quantized leaf
    alone, with its spec, is a tree too."""
    _check_bits(bits)
    if _is_qleaf(qtree):
        return _dequantize_leaf(qtree, spec_tree, bits)
    if isinstance(qtree, dict):
        return {k: dequantize_tree(v, spec_tree[k], bits)
                for k, v in qtree.items()}
    return qtree


def _layer_slice(node, i: int):
    """Layer ``i`` of a stacked (quantized or spec) tree: the codes' and
    plain leaves' leading index, the scale whole."""
    if _is_qleaf(node):
        return {"q": node["q"][i], "scale": node["scale"]}
    if isinstance(node, dict):
        return {k: _layer_slice(v, i) for k, v in node.items()}
    return node[i]


def quant_tree_axes(axes_tree, spec_tree):
    """Logical axes of the ``quantize_tree`` tree: ``q`` inherits its
    leaf's axes, ``scale`` is replicated; unquantized leaves keep theirs."""
    if isinstance(axes_tree, dict):
        return {k: quant_tree_axes(v, spec_tree[k])
                for k, v in axes_tree.items()}
    if _quantizable(spec_tree):
        return {"q": axes_tree, "scale": ()}
    return axes_tree


class DequantizedByLayer:
    """A ``quantize_tree`` tree of an LM read as the params it came from,
    where they are used: ``tree[key]`` dequantizes a top-level entry when
    read, and the stacked layers (``blocks``) read as an object whose
    ``layer(i)`` dequantizes layer ``i`` alone
    (``models/transformer.py::layer`` calls it). So a decode step holds one
    layer's dequantized weights at a time. Each value is bitwise the slice
    of ``dequantize_tree``'s: the dequantization is elementwise."""

    def __init__(self, qtree, spec_tree, bits: int):
        _check_bits(bits)
        self.qtree, self.spec, self.bits = qtree, spec_tree, bits

    def __contains__(self, key) -> bool:
        return key in self.qtree

    def __getitem__(self, key):
        if key == "blocks":
            return _StackedLayers(self.qtree[key], self.spec[key], self.bits)
        return dequantize_tree(self.qtree[key], self.spec[key], self.bits)


class _StackedLayers:
    def __init__(self, qtree, spec, bits: int):
        self.qtree, self.spec, self.bits = qtree, spec, bits

    def layer(self, i: int):
        return dequantize_tree(_layer_slice(self.qtree, i),
                               _layer_slice(self.spec, i), self.bits)
