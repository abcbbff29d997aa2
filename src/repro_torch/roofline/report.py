"""Roofline terms of a counted step on one NVIDIA H100.

Port of the reference package's ``roofline/report.py``, priced with the
card's peaks in place of the TPU's (the reference's
``core/hardware.py:173-175``):

  compute term    = sum over dtypes of FLOPs / that dtype's peak, plus the
                    kernels' elementwise FLOPs at the f32 CUDA-core rate
  memory term     = HBM bytes of the eager stream / HBM bandwidth
  collective term = the ring-model collective bytes a device sends
                    (``counter.py``) / its NVLink bandwidth one way; 0 on
                    one card

``floor_s = max(compute_s, min_hbm_bytes / H100_HBM_BYTES_S)`` is the bound
no implementation beats (each input read once, each output written once),
the denominator of every ``share`` in ``chip_smoke.py``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from repro_torch.roofline.counter import RooflineCounts

# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth 3.35 TB/s
H100_HBM_BYTES_S = 3.35e12
# NVIDIA H100 SXM5 data sheet: FP32 67 TFLOPS on the CUDA cores. The port's
# parity rule keeps TF32 off, so this rate prices every f32 product.
H100_FP32_FLOP_S = 67e12
# NVIDIA H100 SXM5 data sheet: BF16 tensor core 989.4 TFLOPS dense (the
# sheet's 1,979 is with 2:4 sparsity)
H100_BF16_FLOP_S = 989.4e12
# NVIDIA H100 SXM5 data sheet: NVLink 900 GB/s a card (18 links of 4th
# generation NVLink, both directions together); a ring sends each device's
# bytes one way, so the collective term prices them at half of it
H100_ICI_BYTES_S = 900e9 / 2
# an HGX H100 board joins 8 cards in one NVLink domain (NVSwitch); wider
# groups cross the network between boards, which is slower than NVLink
NVLINK_DOMAIN = 8
H100_HBM_CAPACITY_BYTES = 80e9          # H100 80GB HBM3

# the peak that prices a product of each operand dtype
PEAK_FLOP_S = {"bfloat16": H100_BF16_FLOP_S, "float16": H100_BF16_FLOP_S,
               "float32": H100_FP32_FLOP_S}


def compute_seconds(counts: RooflineCounts) -> float:
    """Each dtype's FLOPs over its peak (a dtype without one, such as
    float64, at the f32 rate), plus the elementwise FLOPs at the f32 rate."""
    s = sum(f / PEAK_FLOP_S.get(dt, H100_FP32_FLOP_S)
            for dt, f in counts.flops_by_dtype.items())
    return s + counts.elementwise_flops / H100_FP32_FLOP_S


def floor_seconds(counts: RooflineCounts) -> float:
    """The floor: ``max(compute_s, min_hbm_bytes / H100_HBM_BYTES_S)``."""
    return max(compute_seconds(counts),
               counts.min_hbm_bytes / H100_HBM_BYTES_S)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device counts
    flops: float
    hbm_bytes: float
    ici_bytes: float
    collective_bytes_by_type: Dict[str, float]
    n_collectives: int
    collective_bytes_by_dtype: Dict[str, float] = field(default_factory=dict)
    # terms (seconds)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    # usefulness
    model_flops: float = 0.0          # analytic 6*N*D (global)
    hlo_total_flops: float = 0.0      # per-device * devices
    useful_ratio: float = 0.0         # model_flops / hlo_total_flops
    # XLA-reported: always None here. The reference reads them from XLA's
    # cost analysis of the compiled step; an eager program has no compiler
    # cost analysis, and the counter's own numbers are above.
    xla_flops: Optional[float] = None
    xla_bytes: Optional[float] = None
    # memory, reckoned by the counter's live-storage tracking
    argument_bytes_per_device: Optional[float] = None
    temp_bytes_per_device: Optional[float] = None
    output_bytes_per_device: Optional[float] = None
    roofline_fraction: float = 0.0    # compute_s / max(term)
    step_time_lower_bound_s: float = 0.0
    # the port's additions
    min_hbm_bytes: float = 0.0
    floor_s: float = 0.0
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    elementwise_flops: float = 0.0
    launches: Dict[str, float] = field(default_factory=dict)
    collective_note: str = ""

    @classmethod
    def build(cls, *, arch: str, shape: str, mesh: str, n_devices: int,
              counts: RooflineCounts, model_flops: float,
              group_sizes: Optional[Dict[str, int]] = None
              ) -> "RooflineReport":
        compute_s = compute_seconds(counts)
        memory_s = counts.hbm_bytes / H100_HBM_BYTES_S
        collective_s = counts.ici_bytes / H100_ICI_BYTES_S
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": collective_s}
        bottleneck = max(terms, key=terms.get)
        total = counts.flops * n_devices
        top = max(terms.values())
        return cls(
            arch=arch, shape=shape, mesh=mesh, n_devices=n_devices,
            flops=counts.flops, hbm_bytes=counts.hbm_bytes,
            ici_bytes=counts.ici_bytes,
            collective_bytes_by_type=dict(counts.collective_bytes_by_type),
            n_collectives=counts.n_collectives,
            collective_bytes_by_dtype=dict(counts.collective_bytes_by_dtype),
            compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
            bottleneck=bottleneck,
            model_flops=model_flops, hlo_total_flops=total,
            useful_ratio=(model_flops / total) if total else 0.0,
            argument_bytes_per_device=counts.argument_bytes,
            temp_bytes_per_device=counts.temp_bytes,
            output_bytes_per_device=counts.output_bytes,
            roofline_fraction=(compute_s / top) if top > 0 else 0.0,
            step_time_lower_bound_s=top,
            min_hbm_bytes=counts.min_hbm_bytes,
            floor_s=floor_seconds(counts),
            flops_by_dtype=dict(counts.flops_by_dtype),
            elementwise_flops=counts.elementwise_flops,
            launches=dict(counts.launches),
            collective_note=collective_note(group_sizes))

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)

    def summary_row(self) -> str:
        return (f"{self.arch:24s} {self.shape:12s} {self.mesh:6s} "
                f"C={self.compute_s*1e3:9.3f}ms M={self.memory_s*1e3:9.3f}ms "
                f"I={self.collective_s*1e3:9.3f}ms -> {self.bottleneck:10s} "
                f"floor={self.floor_s*1e3:9.3f}ms "
                f"frac={self.roofline_fraction:5.2f} useful={self.useful_ratio:5.2f}")


def collective_note(group_sizes: Optional[Dict[str, int]]) -> str:
    """What the collective term assumes, for a mesh's axis sizes: every
    group is priced at NVLink's rate, which holds only within one 8-card
    NVLink domain."""
    if not group_sizes:
        return "one card: no collectives"
    wide = {a: n for a, n in group_sizes.items() if n > NVLINK_DOMAIN}
    note = (f"priced at NVLink {H100_ICI_BYTES_S / 1e9:.0f} GB/s one way "
            f"a card")
    if wide:
        note += ("; axes " + ", ".join(f"{a}={n}" for a, n in wide.items())
                 + f" are wider than one {NVLINK_DOMAIN}-card NVLink domain,"
                 " so their collectives cross the network between boards "
                 "and this term is a lower bound")
    return note


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for training (N=active params, D=tokens);
    2*N*D for inference steps."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n = cfg.n_active_params() if hasattr(cfg, "n_active_params") else 0
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
