"""The benchmark's frozen arithmetic: the H100's peaks and the work a kernel
call needs, counted from shapes.

The formulas are copies of ``bank_mxv_cost`` and ``scan_cost`` in the
port's ``kernels/ops.py`` (and ``SCAN_FLOPS`` beside them), and the peaks are
those of its ``roofline/report.py``: NVIDIA's data sheet for the H100 SXM at
its 700 W limit. They live here so that a change to the program cannot move
the yardstick it is measured with.
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_F32_FLOPS = 67e12        # FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # HBM3
PEAK_BF16_FLOPS = 989.4e12    # dense bf16 tensor cores (not used by a cell yet)

# flops per (lane, sequence, step, channel) of the SRU recurrence: two gate
# pre-activations (2 mul + 4 add), two sigmoids (neg, exp, add, div each),
# the state update (2 mul, 2 add) and h (1 mul)
SCAN_FLOPS = 21


class KernelCost(NamedTuple):
    """A kernel call's work: ``flops`` of its f32 products, the
    ``elementwise_flops`` of its own arithmetic, and the bytes it reads and
    writes (each input byte read once, each output byte written once)."""
    flops: float
    elementwise_flops: float
    read_bytes: float
    write_bytes: float

    @property
    def hbm_bytes(self) -> float:
        return self.read_bytes + self.write_bytes

    def floor_s(self) -> float:
        """The least time the chip could take: the larger of the f32
        operations over the f32 peak and the bytes over the HBM peak."""
        ops = self.flops + self.elementwise_flops
        return max(ops / PEAK_F32_FLOPS, self.hbm_bytes / PEAK_HBM_BYTES)


def bank_mxv_cost(P: int, M: int, m: int, N: int, K: int) -> KernelCost:
    """``bank_mxv_pop`` on x (P, M, m) and a (K, m, N) bank: ``2*P*M*m*N``
    f32 FLOPs; reads x, min(P, K) bank rows (each lane's own row, at most K
    distinct) and the (P,) index, writes (P, M, N)."""
    return KernelCost(2 * P * M * m * N, 0,
                      4 * P * M * m + 4 * min(P, K) * m * N + 4 * P,
                      4 * P * M * N)


def scan_cost(P: int, B: int, T: int, n: int) -> KernelCost:
    """``sru_scan_pop`` on (P, B, T, n) streams: ``SCAN_FLOPS * P*B*T*n``
    elementwise; reads uw, uf, ur and the four (n,) vectors, writes h, r
    and c_last."""
    elems = P * B * T * n
    return KernelCost(0, SCAN_FLOPS * elems, 3 * 4 * elems + 4 * 4 * n,
                      4 * (2 * elems + P * B * n))


def total_floor_s(costs) -> float:
    return sum(c.floor_s() for c in costs)


def roofline_share(ctx, key: str, kernel: str):
    """Percent of a kernel's floor in the traced window: the floor of the
    work (``ctx["work"](n)[key]``) the real lanes of every dispatch need,
    over the device time of the operations whose name holds ``kernel``;
    None where the trace has none."""
    tr = ctx["trace"]
    if not tr:
        return None
    dev_s = sum(e - s for name, s, e in tr["ops"] if kernel in name) * 1e-9
    if dev_s <= 0:
        return None
    floor = sum(c.floor_s() for n in ctx["eval_sizes"]
                for c in ctx["work"](n)[key])
    if floor <= 0:
        return None
    return floor / dev_s * 100.0
