"""Plain quantization arithmetic of the references (paper §4.1), written
from the paper's definitions and the reference package's conventions, with
nothing of the port: symmetric integer grids with MMSE clips for 2/4/8 bits
([-2, 1], [-8, 7], [-128, 127]), a 16-bit fixed-point grid sized to the
range, activation grids from the median of per-batch max |x|.

``Precision`` is the arithmetic of a reference's products: float32 with
TF32 off (the references), or a lower precision for the control: every
operand of a product rounded to TF32's 10 mantissa bits (``tf32``), to
bfloat16 (``bf16``) or to float8 e4m3 (``fp8``, saturating at 448) before
an exact float32 product; or float64 products (``f64``), the witness of how
far last-bit rounding alone moves a row.
"""
from __future__ import annotations

import math

import numpy as np
import torch

INT_RANGES = {8: (-128, 127), 4: (-8, 7), 2: (-2, 1)}
MENU = (2, 4, 8, 16)


def quant_triple(bits: int, clip_or_range: float):
    """(scale, lo, hi) of a menu precision's grid."""
    if bits == 16:
        int_bits = int(math.ceil(math.log2(max(clip_or_range, 1e-9))))
        return (2.0 ** -(15.0 - max(int_bits, 0)), -32768.0, 32767.0)
    lo, hi = INT_RANGES[bits]
    return (clip_or_range / hi, float(lo), float(hi))


def fake_quant(x: torch.Tensor, scale, lo, hi, ste: bool = True):
    """clip(round(x / scale), lo, hi) * scale on float32 grid values
    (broadcast against ``x``); narrower data is widened for the grid
    arithmetic and the result cast back, float64 data stays float64.
    ``ste``: the value of ``x + (q - x)``, as a straight-through estimator
    computes it in ``x``'s dtype."""
    dev = x.device
    s, l, h = (torch.as_tensor(v, dtype=torch.float32, device=dev)
               for v in (scale, lo, hi))
    xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
    q = (torch.clamp(torch.round(xf / s), l, h) * s).to(x.dtype)
    return x + (q - x) if ste else q


def fixed_point_16(x: torch.Tensor) -> torch.Tensor:
    """16-bit fixed point: integer bits sized to max |x|, the rest sign and
    fraction."""
    absmax = torch.max(torch.abs(x))
    int_bits = torch.clamp(torch.ceil(torch.log2(torch.clamp(absmax,
                                                             min=1e-9))),
                           -14, 14)
    scale = torch.exp2(-(15.0 - torch.clamp(int_bits, min=0.0)))
    lim = 2.0 ** 15 - 1
    return torch.clamp(torch.round(x / scale), -lim - 1, lim) * scale


def mmse_clip_host(w: np.ndarray, bits: int, n_grid: int = 64) -> float:
    """The clip of least mean squared quantization error among ``n_grid``
    fractions of max |w|, searched in float32 numpy."""
    x = np.asarray(w, np.float32)
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
def mmse_clip_f64(w: torch.Tensor, bits: int, n_grid: int = 64) -> float:
    """The same search on the tensor's device in float64: the first
    candidate of least error."""
    x = w.detach().flatten().to(torch.float64)
    absmax = float(torch.max(torch.abs(x))) or 1.0
    lo, hi = INT_RANGES[bits]
    clips = [absmax * f for f in np.linspace(1.0 / n_grid, 1.0, n_grid)]
    errs = []
    for c in clips:
        s = torch.as_tensor(c / hi, dtype=torch.float64, device=x.device)
        q = torch.clamp(torch.round(x / s), lo, hi) * s
        errs.append(torch.mean(torch.square(x - q)))
    return clips[int(torch.argmin(torch.stack(errs)))]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties to
    even; non-finite values pass."""
    b = x.contiguous().view(torch.int32)
    bias = ((b >> 13) & 1) + 0xFFF
    r = ((b + bias) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


class Precision:
    """The arithmetic of a reference's products."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "bf16", "fp8", "f64"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as this precision holds it, in its own dtype."""
        if self.name in ("f32", "f64") or not x.dtype.is_floating_point:
            return x
        if self.name == "fp8":
            y = x.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
            return y.to(x.dtype)
        if x.dtype != torch.float32:
            return x
        if self.name == "tf32":
            return round_tf32(x)
        return x.to(torch.bfloat16).to(torch.float32)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (batched like ``torch.matmul``) in float32, exact float32
        products of this precision's operands (``f64``: in float64)."""
        if self.name == "f64":
            return torch.matmul(a.double(), b.double())
        return torch.matmul(self.operand(a.float()), self.operand(b.float()))


def rel_gap(a, b) -> float:
    """|a - b| / |b| (0 where both are 0)."""
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-30)


def grid_gap(side, ref) -> float:
    """The widest ``rel_gap`` between two (act_ranges, wclips, wranges)."""
    return max([0.0] + [rel_gap(x[k], y[k]) for x, y in zip(side, ref)
                        for k in y])


def max_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def lane_trips(names, allocs, grids):
    """{layer: (w_trips (L, 3), a_trips (L, 3))} of the lanes' allocations
    ({layer: (weight bits, activation bits)}) on ``grids`` = (act_ranges,
    wclips, wranges)."""
    act, clips, wr = grids
    out = {}
    for name in names:
        w = [quant_triple(a[name][0], wr[name] if a[name][0] == 16
                          else clips[(name, a[name][0])]) for a in allocs]
        x = [quant_triple(a[name][1], act[name]) for a in allocs]
        out[name] = (np.asarray(w, np.float32), np.asarray(x, np.float32))
    return out


PARTS = 4      # each (lane, sequence) row of positions cut into this many


def row_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(..., T) float64: the RMS of prog - ref over the last axis, over the
    reference row's RMS, for every row of the last axis."""
    p, r = prog.double(), ref.double()
    num = torch.sqrt(torch.mean((p - r) ** 2, dim=-1))
    return num / torch.sqrt(torch.mean(r * r, dim=-1)).clamp_min(1e-30)


def part_median(gaps: torch.Tensor) -> float:
    """The widest median over the parts of ``gaps`` (L, N, T): each
    (lane, sequence) cut into ``PARTS`` runs of consecutive positions, so
    that a fault of one lane, one sequence or one stretch of positions
    shows even where it leaves most rows of the sample sound."""
    g = gaps.reshape(-1, gaps.shape[-1])
    parts = torch.tensor_split(g, min(PARTS, g.shape[-1]), dim=-1)
    return max(float(p.median(dim=-1).values.max()) for p in parts)


STABLE_GAP = 1e-6   # a row the float64 witness moves by more is unstable


def stable_median(gaps: torch.Tensor, witness_gaps: torch.Tensor) -> float:
    """The median of ``gaps`` over the rows whose ``witness_gaps`` (the
    reference in float64 against itself in float32) stay within
    ``STABLE_GAP``: rows that last-bit rounding alone does not move. A
    quantized lane can be chaotic: a rounding difference flips one grid
    step and the recurrence carries the flip on, so such rows of a sound
    program read anything up to the control's gaps. With no stable row, the
    median over every row."""
    g = gaps.flatten()
    keep = witness_gaps.flatten() <= STABLE_GAP
    return float((g[keep] if bool(keep.any()) else g).median())


def logit_stats(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """Gaps of logits (L, N, T, V) against the reference's, each row of V
    measured against the reference row's RMS: the widest element gap
    (``logit_max``), the median row's RMS gap and the mean (``logit_med``,
    ``logit_rms``), the widest part's median (``logit_part``, see
    ``part_median``), and how far below the reference's best the program's
    top entry lies, the widest over the rows (``top_gap``)."""
    gaps = row_gaps(prog, ref)
    p = prog.reshape(-1, prog.shape[-1]).double()
    r = ref.reshape(-1, ref.shape[-1]).double()
    scale = torch.sqrt(torch.mean(r * r, dim=-1)).clamp_min(1e-30)
    row_max = (p - r).abs().max(dim=-1).values / scale
    top = (r.max(dim=-1).values
           - r.gather(1, p.argmax(dim=-1, keepdim=True))[:, 0]) / scale
    return {"logit_max": float(row_max.max()),
            "logit_med": float(gaps.median()),
            "logit_rms": float(gaps.mean()),
            "logit_part": part_median(gaps),
            "top_gap": float(top.max()),
            "rows": int(p.shape[0])}


def reduction_gaps(allocs, argmax, labels, counts, errors, n_subsets: int):
    """The evaluator's reduction held to the program's own outputs: the
    widest gap, in points, between each lane's integer error counts and
    those of the argmax of its logits against the labels
    (``count_gap_pp``), and between the errors the search received and the
    max over the subsets of those counts (``err_gap_pp``)."""
    n = len(allocs)
    wrong = argmax[:n] != labels[None]
    frames = wrong[0].numel() // n_subsets
    recount = wrong.reshape(n, n_subsets, -1).sum(-1).cpu().numpy()
    counts = np.asarray(counts)[:n].astype(np.int64)
    err = (100.0 * counts / frames).max(axis=1)
    return (float(np.abs(counts - recount).max()) * 100.0 / frames,
            float(np.abs(np.asarray(errors, float) - err).max()))
