"""Hardware platform models (paper §2.5, §4.4) + TPU v5e adaptation.

A ``HardwareModel`` turns a per-layer (w_bits, a_bits) allocation plus the
model's per-layer MAC/weight counts into the paper's objectives:

  speedup  S = sum_i S_i * N_i / N_T                      (Eq. 4)
  energy   E = N_b * C_M + sum_i E_i * N_i                (Eq. 3)

and enforces the on-chip SRAM size constraint.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class HardwareModel:
    name: str
    supported_bits: Tuple[int, ...]
    sram_bytes: Optional[int]
    weights_equal_acts: bool = False         # SiLago: W precision == A precision
    load_pj_per_bit: float = 0.0

    def speedup_of_pair(self, w_bits: int, a_bits: int) -> float:
        raise NotImplementedError

    def mac_energy_pj(self, w_bits: int, a_bits: int) -> float:
        raise NotImplementedError

    # ---- paper objectives over a per-layer allocation ----
    def speedup(self, layer_macs: Dict[str, int],
                alloc: Dict[str, Tuple[int, int]],
                fixed_ops: int = 0) -> float:
        """Eq. 4. ``fixed_ops`` are element-wise + nonlinear ops that always
        run at the platform's max precision (1x); including them in N_T is
        what makes the paper's all-4-bit SiLago solution 3.9x, not 4.0x."""
        total = sum(layer_macs.values()) + fixed_ops
        return (sum(self.speedup_of_pair(*alloc[n]) * m
                    for n, m in layer_macs.items()) + fixed_ops) / total

    def energy_joules(self, layer_macs: Dict[str, int],
                      layer_weights: Dict[str, int],
                      alloc: Dict[str, Tuple[int, int]],
                      vector_weights: int = 0) -> float:
        n_bits = sum(w * alloc[n][0] for n, w in layer_weights.items())
        n_bits += vector_weights * 16
        e = n_bits * self.load_pj_per_bit
        e += sum(self.mac_energy_pj(*alloc[n]) * m
                 for n, m in layer_macs.items())
        return e * 1e-12

    def model_fits(self, layer_weights: Dict[str, int],
                   alloc: Dict[str, Tuple[int, int]],
                   vector_weights: int = 0) -> Tuple[bool, float]:
        bits = sum(w * alloc[n][0] for n, w in layer_weights.items())
        bits += vector_weights * 16
        size = bits / 8.0
        if self.sram_bytes is None:
            return True, size
        return size <= self.sram_bytes, size


@dataclass(frozen=True)
class SiLago(HardwareModel):
    """Paper Table 2: reconfigurable MAC — 1x 16b, 2x 8b, 4x 4b / cycle."""
    name: str = "silago"
    supported_bits: Tuple[int, ...] = (4, 8, 16)
    sram_bytes: Optional[int] = 6 * 2 ** 20          # paper experiment 2
    weights_equal_acts: bool = True
    load_pj_per_bit: float = 0.08
    mac_pj: Dict[int, float] = field(
        default_factory=lambda: {16: 1.666, 8: 0.542, 4: 0.153})

    def speedup_of_pair(self, w_bits: int, a_bits: int) -> float:
        assert w_bits == a_bits, "SiLago requires W precision == A precision"
        return {16: 1.0, 8: 2.0, 4: 4.0}[w_bits]

    def mac_energy_pj(self, w_bits: int, a_bits: int) -> float:
        return self.mac_pj[w_bits]


@dataclass(frozen=True)
class Bitfusion(HardwareModel):
    """Bit-brick fusion: ops/cycle = 64 / (wb * ab); speedup over the 16-bit
    baseline = 256 / (wb * ab) (paper §2.5.2: 2b/2b is 64x over 16b)."""
    name: str = "bitfusion"
    supported_bits: Tuple[int, ...] = (2, 4, 8, 16)
    sram_bytes: Optional[int] = 2 * 2 ** 20          # paper experiment 3

    def speedup_of_pair(self, w_bits: int, a_bits: int) -> float:
        return 256.0 / (w_bits * a_bits)

    def mac_energy_pj(self, w_bits: int, a_bits: int) -> float:
        # paper uses Bitfusion for speedup only; keep a bit-proportional proxy
        return 1.666 * (w_bits * a_bits) / 256.0


@dataclass(frozen=True)
class TPUv5e(HardwareModel):
    """TPU adaptation (DESIGN.md): int8 runs 2x bf16 on the MXU; int4/int2
    have no MXU speedup but cut HBM traffic — so 'speedup' here scores the
    *memory-bound* serving regime: effective step speedup is modeled as
    min(compute gain, bytes gain) against the roofline-dominant term, which
    the caller supplies via ``memory_bound``."""
    name: str = "tpu_v5e"
    supported_bits: Tuple[int, ...] = (2, 4, 8, 16)
    sram_bytes: Optional[int] = None                 # HBM 16 GiB checked elsewhere
    memory_bound: bool = True
    peak_bf16_tflops: float = 197.0
    hbm_gbps: float = 819.0
    hbm_pj_per_bit: float = 0.6                      # ~DDR/HBM-class per-bit cost
    mac_pj_bf16: float = 0.3

    def speedup_of_pair(self, w_bits: int, a_bits: int) -> float:
        compute = 2.0 if max(w_bits, a_bits) <= 8 else 1.0
        memory = 16.0 / w_bits                       # weight-traffic gain vs bf16
        return memory if self.memory_bound else compute

    def mac_energy_pj(self, w_bits: int, a_bits: int) -> float:
        return self.mac_pj_bf16 * (0.5 if max(w_bits, a_bits) <= 8 else 1.0)


SILAGO = SiLago()
BITFUSION = Bitfusion()
TPU_V5E = TPUv5e()


# ------------------------------------------------------- platform registry
#
# Search sessions are constructed from *names* (``SearchSession(target,
# "bitfusion", ...)``, see repro_torch.core.api) so swapping the hardware platform
# never requires touching model or search code — the paper's central claim
# (adapting the search to a platform change) reduced to a config string.

_PLATFORMS: Dict[str, HardwareModel] = {
    "silago": SILAGO,
    "bitfusion": BITFUSION,
    "tpuv5e": TPU_V5E,
    "tpu_v5e": TPU_V5E,                              # alias
    # experiment-1 style search: no platform constraints, memory objective
    # only (sram unbounded; Bitfusion's full menu)
    "mem-only": Bitfusion(name="none(mem-only)", sram_bytes=None),
}


def _norm(name: str) -> str:
    return name.lower().replace(" ", "")


def list_platforms() -> Tuple[str, ...]:
    """Registered platform names accepted by ``get_platform``."""
    return tuple(sorted(_PLATFORMS))


def get_platform(name: str) -> HardwareModel:
    """Resolve a platform name to its ``HardwareModel``. Unknown names raise
    with the list of valid choices (case-insensitive lookup)."""
    key = _norm(name)
    if key not in _PLATFORMS:
        raise KeyError(f"unknown hardware platform {name!r}; valid choices: "
                       f"{', '.join(list_platforms())}")
    return _PLATFORMS[key]


def register_platform(name: str, model: HardwareModel) -> None:
    """Add a platform to the registry (tests / downstream configs); lookup
    is whitespace-insensitive, so names are stored the same way."""
    _PLATFORMS[_norm(name)] = model

