"""The kernel verifier: rules K0-K4 over every CUDA kernel instantiation.

The port's counterpart of the reference's Pallas verifier
(``tools/analysis/kernel_rules.py``). There a ``pallas_call`` is captured
and its grid and BlockSpecs checked without running a kernel body. Here
the kernels are CUDA C++ (``csrc/*.cu``) behind a plain C interface whose
ctypes (``kernels/build.py::signatures``) and bank tiles
(``kernels/ops.py::BANK_CONFIGS``) are read off the sources, so the rules
read the sources, re-derive the launch plans from them, and on a card
drive every template instantiation the host code can dispatch. Findings
anchor to the ``csrc`` line that adds what they are about.

- K0  coverage: every instantiation the host code can dispatch
      (``bank_gemm.cuh``'s ``with_config`` and ``with_width`` cases,
      ``quant_matmul.cu``'s ``launch<MT>`` calls, ``launch_bits`` cases and
      vector branch, the scan's launch) has exactly one driver
      (``drivers()``). A driver builds inputs that the wrapper dispatches
      to its instantiation (held through a mirror of the wrappers'
      dispatch, ``dispatch_key``); on a card
      it launches once through the wrapper (its lane counter must move by
      one) and agrees with the plain version (rtol 1e-4 / atol 1e-3). An
      undriven instantiation, a stale driver or a crash is a finding.
- K1  the interface and the launch plan: every prototype's parameter is
      a kind ``build.CTYPES`` passes (pointer, ``int``, ``long long``);
      every driven call, and the largest shapes the paths feed
      (``large_shapes``: the dry run's one-card LM heads, the search's
      largest population), gets a grid re-derived from the sources that
      stays inside CUDA's limits (x < 2^31, y and z <= 65,535); on a card
      the library's tile configurations are the ones read off the source.
- K2  index and lane discipline (card): every menu index of the bank calls
      of one SRU generation, one served SRU step and one xLSTM generation
      (the contract harnesses, through ``ops.observe_launches``) lies in
      [0, K); changing one lane's index and inputs (one row of x for
      ``quant_matmul``) leaves every other lane bitwise the same at a
      population that is not a multiple of a tile; an out-of-range index
      fills only its own lane with NaN.
- K3  resources (card): ``repro_kernel_attributes`` gives each
      instantiation's registers, local bytes, static and dynamic shared
      memory and the blocks an SM holds at its launch; static plus dynamic
      shared memory over ``ops.SMEM_PER_BLOCK`` and fewer blocks an SM than
      the ``__launch_bounds__`` minimum are findings, and so are spill
      bytes (``build.log``'s ptxas lines) in an instantiation that had
      none when the rule was written (``KNOWN_SPILLS``).
- K4  the packed layout: on the CPU, ``ref.pack_weights`` and the plain
      unpacker round-trip codes of every width, and a packed bank
      dequantized by the plain unpacker equals the f32 bank; on a card,
      identity activations make each output one product, so
      ``bank_qmm_pop`` must return the f32 bank's rows and ``quant_matmul``
      the dequantized weight, value for value.

``run_kernel_checks(device)`` returns ``(findings, report)``; on the CPU it
runs the static rules (K0's enumeration and dispatch keys, K1's
prototypes and grids, K4's round trips), on a card all of them. The
sanitizer pass (``python -m repro_torch.analysis --sanitize``) re-runs the
drivers under ``compute-sanitizer``. Nothing here imports the reference
package.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

REPO = Path(__file__).resolve().parents[3]
CSRC = build.CSRC
INT32_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535
RTOL, ATOL = 1e-4, 1e-3
# instantiations that spilled when K3 was written (none: every one of
# chip_smoke.py's setup lines read 0 spill stores and loads); a spill in
# any other is a finding
KNOWN_SPILLS: Dict[tuple, int] = {}
KERNEL_IDS = ("bank_mxv_pop", "bank_qmm_pop", "quant_matmul", "sru_scan_pop")
RULES = ("K0", "K1", "K2", "K3", "K4")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative where inside the repo
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _rel(path: Path) -> str:
    path = Path(path).resolve()
    try:
        return path.relative_to(REPO).as_posix()
    except ValueError:
        return str(path)


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _find(csrc: Path, name: str, pattern: str) -> Tuple[str, int]:
    """(path, line) of the first match of ``pattern`` in ``csrc/name``."""
    text = (csrc / name).read_text()
    m = re.search(pattern, text)
    if m is None:
        raise ValueError(f"{name}: no match for {pattern!r}")
    return _rel(csrc / name), _line_of(text, m.start())


def _body(text: str, head: str) -> Tuple[str, int]:
    """The text of the function whose definition starts with ``head`` (up
    to its closing brace at column 0) and its offset."""
    start = text.index(head)
    return text[start:text.index("\n}", start) + 2], start


# ------------------------------------------------------------------ sources

@dataclasses.dataclass(frozen=True)
class Instantiation:
    """One template instantiation the host code can launch: its kernel,
    its template arguments (``key``) and the source sites (path, line)
    whose switch cases and branches select it, outermost first."""
    kernel: str
    key: Tuple[Tuple[str, object], ...]
    sites: Tuple[Tuple[str, int], ...]

    @property
    def name(self) -> str:
        args = ",".join(f"{k}={v}" for k, v in self.key)
        return f"{self.kernel}[{args}]" if args else self.kernel


def _cases(text: str, head: str, pattern: str, path: str):
    body, off = _body(text, head)
    return [(m.groups(), (path, _line_of(text, off + m.start())))
            for m in re.finditer(pattern, body)]


def instantiations(csrc: Path = CSRC) -> List[Instantiation]:
    """Every instantiation the sources' host code can dispatch, read off
    the switches that choose them."""
    gemm = (csrc / "bank_gemm.cuh").read_text()
    gpath = _rel(csrc / "bank_gemm.cuh")
    configs = [(int(g[0]), site) for g, site in _cases(
        gemm, "inline cudaError_t with_config(",
        r"case\s+(\d+)\s*:\s*return\s+f\(", gpath)]
    widths = [(int(g[0]), site) for g, site in _cases(
        gemm, "inline cudaError_t with_width(",
        r"case\s+(\d+)\s*:\s*return\s+f\(", gpath)]
    out = []
    mxv = (csrc / "bank_mxv_pop.cu").read_text()
    mxv_entry, _ = _body(mxv, 'extern "C" int repro_bank_mxv_pop(')
    for c, csite in configs:
        for w, wsite in (widths if "with_width" in mxv_entry else []):
            out.append(Instantiation("bank_mxv_pop",
                                     (("config", c), ("width", w)),
                                     (csite, wsite)))
    qmm = (csrc / "bank_qmm_pop.cu").read_text()
    if "with_config" in _body(qmm, 'extern "C" int repro_bank_qmm_pop(')[0]:
        out += [Instantiation("bank_qmm_pop", (("config", c),), (csite,))
                for c, csite in configs]
    qm = (csrc / "quant_matmul.cu").read_text()
    qpath = _rel(csrc / "quant_matmul.cu")
    mts = [(int(g[0]), site) for g, site in _cases(
        qm, 'extern "C" int repro_quant_matmul(', r"launch<(\d+)>\(", qpath)]
    bits = [(int(g[0]), site) for g, site in _cases(
        qm, "cudaError_t launch(",
        r"case\s+(\d+)\s*:\s*launch_bits<\s*\d+\s*,\s*MT\s*>", qpath)]
    vecs = [(g[0] == "true", site) for g, site in _cases(
        qm, "void launch_bits(",
        r"quant_matmul_kernel<\s*BITS\s*,\s*MT\s*,\s*(true|false)\s*>",
        qpath)]
    for mt, msite in mts:
        for b, bsite in bits:
            for v, vsite in vecs:
                out.append(Instantiation(
                    "quant_matmul", (("bits", b), ("mt", mt), ("vec", v)),
                    (msite, bsite, vsite)))
    scan = (csrc / "sru_scan_pop.cu").read_text()
    for m in re.finditer(r"sru_scan_pop_kernel\s*<<<", scan):
        out.append(Instantiation("sru_scan_pop", (), (
            (_rel(csrc / "sru_scan_pop.cu"), _line_of(scan, m.start())),)))
    return out


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch-plan constants of the sources: the bank tiles
    (``ops.bank_configs``), ``quant_matmul``'s columns a block and
    rows-a-block rule, the scan's block, and the line of each kernel's
    grid."""
    tiles: tuple
    qmm_bn: int
    qmm_rows: Tuple[int, int, int]      # M <= a ? b : c
    scan_block: int
    grid_sites: Dict[str, Tuple[str, int]]


def launch_plan(csrc: Path = CSRC) -> Plan:
    from repro_torch.kernels import ops
    qm = (csrc / "quant_matmul.cu").read_text()
    cols = int(re.search(r"constexpr\s+int\s+COLS\s*=\s*(\d+)", qm).group(1))
    lanes = int(re.search(r"constexpr\s+int\s+BN\s*=\s*(\d+)\s*\*\s*COLS",
                          qm).group(1))
    rows = re.search(r"return\s+M\s*<=\s*(\d+)\s*\?\s*(\d+)\s*:\s*(\d+)",
                     qm).groups()
    scan = (csrc / "sru_scan_pop.cu").read_text()
    block = int(re.search(r"constexpr\s+int\s+BLOCK\s*=\s*(\d+)",
                          scan).group(1))
    sites = {
        "bank": _find(csrc, "bank_gemm.cuh", r"inline\s+dim3\s+grid_for"),
        "quant_matmul": _find(csrc, "quant_matmul.cu",
                              r"const\s+dim3\s+grid\("),
        "sru_scan_pop": _find(csrc, "sru_scan_pop.cu",
                              r"const\s+long\s+long\s+grid\s*="),
    }
    sites["bank_mxv_pop"] = sites["bank_qmm_pop"] = sites.pop("bank")
    return Plan(ops.bank_configs(csrc), lanes * cols,
                tuple(int(v) for v in rows), block, sites)


def qmm_rows(plan: Plan, M: int) -> int:
    a, b, c = plan.qmm_rows
    return b if M <= a else c


def grid(plan: Plan, kernel: str, key: dict, shape: dict
         ) -> Tuple[int, int, int]:
    """The grid the source launches for ``shape``, re-derived: the bank
    kernels' ``grid_for`` on the tile of ``key["config"]``,
    ``quant_matmul``'s (ceil(N / BN), ceil(M / MT)), the scan's
    ceil(P B n / BLOCK)."""
    if kernel in ("bank_mxv_pop", "bank_qmm_pop"):
        cfg = plan.tiles[key["config"]]
        return (-(-shape["N"] // cfg.bn), -(-shape["M"] // cfg.bm),
                shape["P"])
    if kernel == "quant_matmul":
        return (-(-shape["N"] // plan.qmm_bn),
                -(-shape["M"] // qmm_rows(plan, shape["M"])), 1)
    return (-(-shape["P"] * shape["B"] * shape["n"] // plan.scan_block), 1,
            1)


def check_grid(plan: Plan, kernel: str, key: dict, shape: dict,
               label: str = "") -> List[Finding]:
    """K1 on one launch: the re-derived grid stays inside CUDA's limits
    (the scan's grid is cast to ``unsigned``: past 2^31 - 1 it would
    wrap)."""
    g = grid(plan, kernel, key, shape)
    path, line = plan.grid_sites[kernel]
    msgs = []
    if g[0] > INT32_MAX:
        msgs.append(f"grid.x {g[0]} > {INT32_MAX}")
    msgs += [f"grid.{a} {v} > {GRID_YZ_MAX}" for a, v in zip("yz", g[1:])
             if v > GRID_YZ_MAX]
    if min(g) < 1:
        msgs.append(f"grid {g} has an empty dimension")
    return [Finding("K1", path, line,
                    f"{kernel}{key} at {shape}{label}: grid {g}: {m}")
            for m in msgs]


# ------------------------------------------------------------------ drivers

@dataclasses.dataclass(frozen=True)
class Driver:
    """Inputs that the wrapper of ``kernel`` dispatches to the
    instantiation ``key``: ``shape`` and, for the bank rows' copy width, the
    offset in floats of the bank's base from a 16-byte-aligned
    allocation."""
    kernel: str
    key: Tuple[Tuple[str, object], ...]
    shape: Dict[str, int]
    offset: int = 0

    @property
    def name(self) -> str:
        return Instantiation(self.kernel, self.key, ()).name


def _drivers() -> List[Driver]:
    from repro_torch.kernels import ops
    out = []
    # ragged against every tile: M = 37 rows, m = 45 (BK 16), N = 36
    # (4 N divides by 16); the base offset picks the copy width
    for c in range(len(ops.BANK_CONFIGS)):
        for w, off in ((16, 0), (8, 2), (4, 1)):
            out.append(Driver("bank_mxv_pop", (("config", c), ("width", w)),
                              {"P": 5, "M": 37, "m": 45, "N": 36, "K": 4},
                              off))
    out += [Driver("bank_qmm_pop", (("config", c),),
                   {"P": 5, "M": 37, "m": 45, "N": 36})
            for c in range(len(ops.BANK_CONFIGS))]
    # M <= 4 takes 4 rows a block, more takes 8; N % 8 == 0 with an
    # aligned base takes the vector loads
    for bits in (2, 4, 8):
        for mt, M in ((4, 3), (8, 6)):
            for vec, N in ((True, 264), (False, 261)):
                out.append(Driver("quant_matmul",
                                  (("bits", bits), ("mt", mt), ("vec", vec)),
                                  {"M": M, "K": 70, "N": N}))
    # P B n = 555 threads: not a multiple of the block
    out.append(Driver("sru_scan_pop", (), {"P": 3, "B": 5, "T": 19,
                                           "n": 37}))
    return out


@functools.lru_cache(maxsize=None)
def drivers() -> Tuple[Driver, ...]:
    """One driver an instantiation (built on first use: it reads
    ``ops.BANK_CONFIGS``)."""
    return tuple(_drivers())


def _menu_weight(m: int, N: int, gen: torch.Generator):
    """A (m, N) weight, its menu triples, and both banks (f32, packed),
    with the most negative code of every grid present."""
    from repro_torch.core import quantization as Q
    w = torch.randn((m, N), generator=gen) / m ** 0.5
    w[0, :4] = -w.abs().max() * 4
    amax = float(w.abs().max())
    trips = Q.menu_triples(Q.SUPPORTED_BITS, lambda b: amax if b == 16
                           else 0.5 * amax)
    return w, trips


def driver_inputs(d: Driver, device, seed: int = 0):
    """(args, kwargs) of the wrapper call of driver ``d`` on ``device``."""
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(seed)
    s, key = d.shape, dict(d.key)
    if d.kernel == "sru_scan_pop":
        P, B, T, n = s["P"], s["B"], s["T"], s["n"]
        u = torch.randn((P, B, T, 3 * n), generator=gen).to(device)
        vecs = [(torch.randn((n,), generator=gen) * 0.5).to(device)
                for _ in range(4)]
        return (u[..., :n], u[..., n:2 * n], u[..., 2 * n:], *vecs), {}
    if d.kernel == "quant_matmul":
        w = torch.randn((s["K"], s["N"]), generator=gen) / s["K"] ** 0.5
        packed, scales = ops.pack_for_kernel(w, key["bits"],
                                             float(w.abs().max()))
        x = torch.randn((s["M"], s["K"]), generator=gen)
        return (x.to(device), packed.to(device), scales.to(device),
                key["bits"]), {}
    P, M, m, N = s["P"], s["M"], s["m"], s["N"]
    w, trips = _menu_weight(m, N, gen)
    x = torch.randn((P, M, m), generator=gen).to(device)
    idx = torch.tensor([p % 4 for p in range(P)], dtype=torch.int32,
                       device=device)
    if d.kernel == "bank_qmm_pop":
        packed = Q.build_packed_weight_bank(w.to(device), trips)
        return (x, packed, idx), {"config": key["config"]}
    rows = Q.build_weight_bank(w, trips)
    # a 16-byte-aligned allocation; the bank starts ``offset`` floats in
    buf = torch.empty(rows.numel() + 4, dtype=torch.float32, device=device)
    bank = buf[d.offset:d.offset + rows.numel()].view(rows.shape)
    bank.copy_(rows.to(device))
    return (x, bank, idx), {"config": key["config"]}


def dispatch_key(plan: Plan, kernel: str, args, kwargs) -> tuple:
    """The instantiation the wrapper dispatches ``args`` to, by the mirror:
    ``ops.copy_width`` of the bank rows, ``quant_matmul``'s rows-a-block
    rule and its vector test (N % 8 == 0 and an 8-byte-aligned base)."""
    from repro_torch.kernels import ops
    if kernel == "bank_mxv_pop":
        bank = args[1]
        return (("config", kwargs["config"]),
                ("width", ops.copy_width(4 * bank.shape[2],
                                         bank.data_ptr())))
    if kernel == "bank_qmm_pop":
        return (("config", kwargs["config"]),)
    if kernel == "quant_matmul":
        x, packed, _, bits = args
        N = packed.shape[1]
        cols = plan.qmm_bn // 32
        return (("bits", bits), ("mt", qmm_rows(plan, x.shape[0])),
                ("vec", N % cols == 0 and packed.data_ptr() % cols == 0))
    return ()


def _plain(kernel: str, args):
    from repro_torch.kernels import ref
    return getattr(ref, kernel + "_ref")(*args)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def run_driver(d: Driver, device) -> Tuple[Optional[str], dict]:
    """Launch driver ``d`` once through its wrapper on ``device`` (a card)
    and hold it to its plain version. Returns (what went wrong or None,
    its report row)."""
    from repro_torch.kernels import ops
    args, kwargs = driver_inputs(d, device)
    fn = getattr(ops, d.kernel)
    before = fn.launches
    got = _as_tuple(fn(*args, **kwargs))
    launched = fn.launches - before
    plain_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                  for a in args]
    if d.kernel == "bank_qmm_pop":
        plain_args[1] = {k: v.cpu() for k, v in args[1].items()}
    want = _as_tuple(_plain(d.kernel, plain_args))
    err = max(float((g.cpu().double() - w.double()).abs().max())
              for g, w in zip(got, want))
    row = {"instantiation": d.name, "launches": launched,
           "max_abs_err": err}
    if launched != 1:
        return f"launched {launched} times, not once", row
    for g, w in zip(got, want):
        if not torch.allclose(g.cpu(), w, rtol=RTOL, atol=ATOL):
            return (f"disagrees with its plain version (max abs err "
                    f"{err:.3g}; rtol {RTOL}, atol {ATOL})"), row
    return None, row


# ------------------------------------------------------------------ K0 / K1

def check_coverage(csrc: Path = CSRC, driver_list=None,
                   plan: Optional[Plan] = None) -> List[Finding]:
    """K0 without a card: the sources' instantiations against the driver
    list (each driver's inputs dispatched, by the mirror of the wrappers'
    dispatch, to the instantiation it names). Undriven instantiations are
    reported once per source site: the first of their sites that no driven
    instantiation shares, or the last."""
    driver_list = drivers() if driver_list is None else driver_list
    plan = plan or launch_plan(csrc)
    out: List[Finding] = []
    insts = instantiations(csrc)
    have = {(i.kernel, i.key) for i in insts}
    driven = {(d.kernel, d.key) for d in driver_list}
    covered_sites = {s for i in insts if (i.kernel, i.key) in driven
                     for s in i.sites}
    missing: Dict[Tuple[str, int], List[str]] = {}
    for i in insts:
        if (i.kernel, i.key) in driven:
            continue
        site = next((s for s in i.sites if s not in covered_sites),
                    i.sites[-1])
        missing.setdefault(site, []).append(i.name)
    for (path, line), names in missing.items():
        out.append(Finding("K0", path, line, f"{len(names)} instantiation(s) "
                           f"reached by no driver: {', '.join(names)}"))
    for d in driver_list:
        if (d.kernel, d.key) not in have:
            path, line = plan.grid_sites[d.kernel]
            out.append(Finding("K0", path, line, f"driver {d.name} names an "
                               "instantiation the sources cannot launch"))
            continue
        args, kwargs = driver_inputs(d, "cpu")
        got = dispatch_key(plan, d.kernel, args, kwargs)
        if got != d.key:
            path, line = plan.grid_sites[d.kernel]
            out.append(Finding("K0", path, line, f"driver {d.name}'s inputs "
                               f"dispatch to {dict(got)}"))
    return out


def check_interface(csrc: Path = CSRC) -> List[Finding]:
    """K1: every prototype's parameters are of a kind ``build.CTYPES``
    passes, so ``build.signatures`` can declare the entry (a ``size_t`` or
    a ``float`` would make ``build.load`` raise on the card)."""
    out = []
    for name, (f, line, kinds) in build.prototypes(csrc).items():
        bad = [f"#{i} {k!r}" for i, k in enumerate(kinds)
               if k not in build.CTYPES]
        if bad:
            out.append(Finding("K1", _rel(f), line, f"{name}: parameters of "
                               f"no ctypes kind: {', '.join(bad)}"))
    return out


# The population MxVs of the searches at the evaluator's largest bucket
# (64 lanes): the SRU's (P, M, m, N) of L, Pr and FC (1,536 frames a lane)
# and the xLSTM's fc, wx and head (1,024 folded frames), and its sLSTM
# recurrent MxV (P x H = 256 lanes of 16 sequences)
SEARCH_MXVS = {"sru L": (64, 1536, 256, 1650), "sru Pr": (64, 1536, 1100, 256),
               "sru FC": (64, 1536, 1100, 1904),
               "xlstm fc": (64, 1024, 1024, 2048),
               "xlstm wx": (64, 1024, 1024, 8192),
               "xlstm head": (64, 1024, 1024, 50432),
               "xlstm rec": (256, 16, 512, 2048)}


def large_shapes() -> List[Tuple[str, dict, dict, str]]:
    """(kernel, key, shape, label) of the largest launches the paths feed:
    an int8 LM head of every architecture at the dry run's one-card
    ``prefill_32k`` and ``decode_32k`` batches (a prefill runs the head on
    its last position), the bank GEMM in every configuration at the
    searches' largest populations (``SEARCH_MXVS``) and the SRU scan at
    64 lanes of the search's 32 x 48 frames."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import ops
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape.name in ("prefill_32k", "decode_32k"):
                out.append(("quant_matmul", {},
                            {"M": shape.global_batch, "K": cfg.d_model,
                             "N": cfg.padded_vocab},
                            f" ({arch} {shape.name} head)"))
    for name, (P, M, m, N) in SEARCH_MXVS.items():
        for c in range(len(ops.BANK_CONFIGS)):
            for kernel in ("bank_mxv_pop", "bank_qmm_pop"):
                out.append((kernel, {"config": c},
                            {"P": P, "M": M, "m": m, "N": N},
                            f" ({name}, {P} lanes)"))
    out.append(("sru_scan_pop", {}, {"P": 64, "B": 32, "T": 48, "n": 550},
                " (sru search, 64 lanes)"))
    return out


def check_launch_plans(plan: Plan, launches) -> List[Finding]:
    """K1 over ``launches``: (kernel, key, shape, label) tuples."""
    out = []
    for kernel, key, shape, label in launches:
        out += check_grid(plan, kernel, dict(key), shape, label)
    return out


# ------------------------------------------------------------------ K4

def check_packing(csrc: Path = CSRC, pack_fn=None, unpack_fn=None
                  ) -> List[Finding]:
    """K4 without a card: ``pack_fn`` (``ref.pack_weights``) then
    ``unpack_fn`` (the plain unpacker) returns codes of every width
    exactly; the port's packed bank dequantized by the plain unpacker
    equals its f32 bank. Anchored at the CUDA consumers' unpack code: one
    finding a consumer."""
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ref
    pack = pack_fn or ref.pack_weights
    unpack = unpack_fn or ref.unpack_weights
    gen = torch.Generator().manual_seed(7)
    bad = []
    for bits in (2, 4, 8):
        lo, hi = Q.INT_RANGES[bits]
        q = torch.randint(lo, hi + 1, (13, 6), generator=gen,
                          dtype=torch.int32).to(torch.int8)
        got = unpack(pack(q, bits), bits, 13)
        if not torch.equal(got, q):
            first = tuple(torch.nonzero(got != q)[0].tolist())
            bad.append(f"bits={bits}: first mismatch at {first} (got "
                       f"{int(got[first])}, want {int(q[first])})")
    out = []
    if bad:
        path, line = _find(csrc, "quant_matmul.cu", r"float\s+code_f\(")
        out.append(Finding("K4", path, line, "pack_weights -> unpacker "
                           "round trip broken: " + "; ".join(bad)))
    w, trips = _menu_weight(45, 6, gen)
    packed = Q.build_packed_weight_bank(w, trips)
    f32 = Q.build_weight_bank(w, trips)
    bad = []
    for k, bits in enumerate(Q.SUPPORTED_BITS):
        codes = packed[f"q{bits}"]
        if bits in (2, 4):
            codes = unpack(codes, bits, 45)
        deq = codes.to(torch.float32) * packed["scale"][k][None, :]
        if not torch.equal(deq, f32[k]):
            bad.append(f"q{bits}: max abs err "
                       f"{float((deq - f32[k]).abs().max()):.3g}")
    if bad:
        path, line = _find(csrc, "bank_qmm_pop.cu", r"float\s+code\(")
        out.append(Finding("K4", path, line, "packed bank dequantized by "
                           "the plain unpacker differs from the f32 bank: "
                           + "; ".join(bad)))
    return out


# ------------------------------------------------------------------ card

def kernel_attributes() -> List[dict]:
    """``repro_kernel_attributes``'s records: each instantiation's key and
    what the card holds of it (``csrc/kernel_attributes.cuh``)."""
    lib = build.load()
    fields = ("kernel", "a", "b", "c", "registers", "local_bytes",
              "static_smem", "max_dynamic_smem", "max_threads", "threads",
              "dynamic_smem", "min_blocks", "blocks_per_sm")
    rows, which = [], 0
    while True:
        out = (ctypes.c_int * len(fields))()
        err = lib.repro_kernel_attributes(which, ctypes.cast(
            out, ctypes.c_void_p))
        if err == 1:                      # cudaErrorInvalidValue: the end
            break
        if err != 0:
            raise RuntimeError(f"repro_kernel_attributes({which}): CUDA "
                               f"error {err}")
        row = dict(zip(fields, out))
        kernel = KERNEL_IDS[row.pop("kernel")]
        a, b, c = row.pop("a"), row.pop("b"), row.pop("c")
        key = {"bank_mxv_pop": (("config", a), ("width", b)),
               "bank_qmm_pop": (("config", a),),
               "quant_matmul": (("bits", a), ("mt", b), ("vec", bool(c))),
               "sru_scan_pop": ()}[kernel]
        rows.append({"kernel": kernel, "key": key, **row})
        which += 1
    return rows


def ptxas_spills(log: str) -> Dict[tuple, dict]:
    """Registers and spill bytes of each instantiation from ``build.log``'s
    ``-Xptxas -v`` lines, by (kernel, key)."""
    from repro_torch.kernels import ops
    tiles = {(c.bm, c.bn): i for i, c in enumerate(ops.BANK_CONFIGS)}
    out = {}
    for block in re.split(r"(?=ptxas info\s+: Compiling entry function)",
                          log):
        bank = re.search(r"(bank_(?:mxv|qmm)_pop)_kernelIN9bank_gemm4TileILi"
                         r"(\d+)ELi(\d+)E(?:Li\d+E)*EE(?:Li(\d+)E)?E", block)
        qmm = re.search(r"quant_matmul_kernelILi(\d)ELi(\d)ELb(\d)E", block)
        if bank:
            kernel, bm, bn, width = bank.groups()
            key = (("config", tiles.get((int(bm), int(bn)), -1)),)
            if width:
                key += (("width", int(width)),)
        elif qmm:
            kernel = "quant_matmul"
            key = (("bits", int(qmm.group(1))), ("mt", int(qmm.group(2))),
                   ("vec", qmm.group(3) == "1"))
        elif "sru_scan_pop_kernel" in block:
            kernel, key = "sru_scan_pop", ()
        else:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        out[(kernel, key)] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                            if spill else 0)}
    return out


def check_resources(insts: Sequence[Instantiation]
                    ) -> Tuple[List[Finding], List[dict]]:
    """K3 on the card: every instantiation's attributes; shared memory
    over ``ops.SMEM_PER_BLOCK``, fewer blocks an SM than its launch bounds
    promise, and a spill outside ``KNOWN_SPILLS`` are findings."""
    from repro_torch.kernels import ops
    attrs = {(r["kernel"], r["key"]): r for r in kernel_attributes()}
    log = (build.build().parent / "build.log").read_text()
    spills = ptxas_spills(log)
    out, report = [], []
    for inst in insts:
        path, line = inst.sites[-1]
        a = attrs.get((inst.kernel, inst.key))
        if a is None:
            out.append(Finding("K3", path, line, f"{inst.name}: no "
                               "repro_kernel_attributes record"))
            continue
        sp = spills.get((inst.kernel, inst.key), {})
        smem = a["static_smem"] + a["dynamic_smem"]
        row = {"instantiation": inst.name, "registers": a["registers"],
               "spill_bytes": sp.get("spill_bytes"),
               "local_bytes": a["local_bytes"],
               "static_smem": a["static_smem"],
               "dynamic_smem": a["dynamic_smem"], "threads": a["threads"],
               "blocks_per_sm": a["blocks_per_sm"],
               "min_blocks": a["min_blocks"]}
        report.append(row)
        if smem > ops.SMEM_PER_BLOCK:
            out.append(Finding("K3", path, line, f"{inst.name}: {smem} bytes "
                               f"of shared memory > {ops.SMEM_PER_BLOCK}"))
        if a["blocks_per_sm"] < a["min_blocks"]:
            out.append(Finding("K3", path, line, f"{inst.name}: "
                               f"{a['blocks_per_sm']} blocks an SM, launch "
                               f"bounds promise {a['min_blocks']}"))
        if sp.get("spill_bytes") is None:
            out.append(Finding("K3", path, line, f"{inst.name}: no ptxas "
                               "line in build.log"))
        elif sp["spill_bytes"] and (inst.kernel, inst.key) \
                not in KNOWN_SPILLS:
            out.append(Finding("K3", path, line, f"{inst.name}: "
                               f"{sp['spill_bytes']} spill bytes (none "
                               "when K3 was written)"))
    return out, report


def _bank_index_checker(bad: list):
    """An ``observe_launches`` callable: every bank call's menu indices in
    [0, K) (``bank_mxv_pop``: the bank's rows; ``bank_qmm_pop``: its 4
    containers)."""
    def check(name, inputs, outputs):
        if name == "bank_mxv_pop":
            idx, K = inputs[2], inputs[1].shape[0]
        elif name == "bank_qmm_pop":
            idx, K = inputs[1], 4
        else:
            return
        lo, hi = int(idx.min()), int(idx.max())
        check.calls += 1
        if lo < 0 or hi >= K:
            bad.append(f"{name}: menu index in [{lo}, {hi}], K = {K}")
    check.calls = 0
    return check


def check_path_indices(device) -> Tuple[List[Finding], dict]:
    """K2 on the paths: every bank call of one SRU generation (the
    evaluator, f32 banks), one packed SRU generation, one served SRU step
    and one xLSTM generation, on the contract harnesses."""
    from repro_torch.core import contracts
    from repro_torch.core.target_registry import get_contract_harness
    from repro_torch.kernels import ops
    bad: List[str] = []
    check = _bank_index_checker(bad)
    with ops.observe_launches(check):
        for name in ("sru", "xlstm"):
            h = get_contract_harness(name, device=device)
            t = h.target
            allocs = contracts._contract_allocs(h.layer_names,
                                                tuple(t.menu))
            qp = contracts._qp_stack(t, allocs, h.layer_names, device)
            h.make_evaluator().errors(allocs, t.params)
            make_packed = getattr(t, "make_packed_banks", None)
            if make_packed is not None:
                packed = make_packed(t.params)
                h.forward_pop(t.params, h.feats, qp, packed)
                lane = h.feats[:1].expand((len(allocs),) +
                                          tuple(h.feats.shape[1:]))
                h.forward_decode(t.params, lane.contiguous(), qp, packed)
    path, line = _find(CSRC, "bank_gemm.cuh", r"poison_tile\(")
    out = [Finding("K2", path, line, m) for m in bad]
    if check.calls == 0:
        out.append(Finding("K2", path, line, "no bank call observed on the "
                           "paths"))
    return out, {"bank_calls_checked": check.calls}


def _lane_case(kernel: str, device):
    """(run(args) -> out, args, a function that changes lane q of args,
    lanes, the lane axis of the output) for a lane check of ``kernel`` at
    a population that is no multiple of a tile."""
    from repro_torch.kernels import ops
    d = next(x for x in drivers() if x.kernel == kernel)
    args, kwargs = driver_inputs(d, device, seed=3)
    fn = getattr(ops, kernel)

    def run(a):
        return _as_tuple(fn(*a, **kwargs))[0]

    def change(a, q):
        a = list(a)
        if kernel == "quant_matmul":
            x = a[0].clone()
            x[q] = -x[q] + 0.5
            a[0] = x
        elif kernel == "sru_scan_pop":
            u = [t.clone() for t in a[:3]]
            for t in u:
                t[q] = -t[q] + 0.5
            a[:3] = u
        else:
            x, idx = a[0].clone(), a[2].clone()
            x[q] = -x[q] + 0.5
            idx[q] = (int(idx[q]) + 1) % 4
            a[0], a[2] = x, idx
        return a
    lanes = args[0].shape[0]
    return run, list(args), change, lanes


def check_lanes(device) -> Tuple[List[Finding], dict]:
    """K2 on the kernels: for each kernel, changing one lane's inputs (and
    menu index) leaves every other lane bitwise the same and moves its
    own; an out-of-range menu index (K, and -1) fills only its own lane
    with NaN."""
    out, report = [], {}
    anchors = {"bank_mxv_pop": ("bank_mxv_pop.cu", r"const int sel ="),
               "bank_qmm_pop": ("bank_qmm_pop.cu", r"const int sel ="),
               "quant_matmul": ("quant_matmul.cu", r"const int col0 ="),
               "sru_scan_pop": ("sru_scan_pop.cu", r"const long long tid")}
    for kernel in KERNEL_IDS:
        path, line = _find(CSRC, *anchors[kernel])
        run, args, change, lanes = _lane_case(kernel, device)
        base = run(args)
        moved = []
        for q in range(lanes):
            got = run(change(args, q))
            others = [p for p in range(lanes) if p != q]
            if not torch.equal(got[others], base[others]):
                moved.append(q)
            if torch.equal(got[q], base[q]):
                out.append(Finding("K2", path, line, f"{kernel}: changing "
                                   f"lane {q} left it unchanged"))
        if moved:
            out.append(Finding("K2", path, line, f"{kernel}: changing lanes "
                               f"{moved} moved another lane's output"))
        report[kernel] = {"lanes": lanes, "moved_others": moved}
        if kernel in ("bank_mxv_pop", "bank_qmm_pop"):
            K = args[1].shape[0] if kernel == "bank_mxv_pop" else 4
            for bad in (K, -1):
                a = list(args)
                a[2] = args[2].clone()
                a[2][1] = bad
                got = run(a)
                others = [p for p in range(lanes) if p != 1]
                if not (torch.isnan(got[1]).all()
                        and torch.equal(got[others], base[others])):
                    out.append(Finding("K2", path, line, f"{kernel}: menu "
                                       f"index {bad} did not poison only "
                                       "its own lane"))
            report[kernel]["out_of_range_poisons_own_lane"] = True
    return out, report


def check_packing_on_card(device) -> Tuple[List[Finding], dict]:
    """K4 on the card: identity activations make each output one product
    (code times scale, plus zeros), so ``bank_qmm_pop(I, packed, idx)``
    must equal the f32 bank's rows ``bank[idx]`` for every container and
    tile configuration, and ``quant_matmul(I, packed, scales, bits)`` the
    plain dequantized weight for bits 2, 4 and 8, value for value."""
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops, ref
    out, report = [], {"bank_qmm_pop": {}, "quant_matmul": {}}
    gen = torch.Generator().manual_seed(11)
    m, N = 45, 36
    w, trips = _menu_weight(m, N, gen)
    packed = Q.build_packed_weight_bank(w.to(device), trips)
    f32 = Q.build_weight_bank(w, trips)
    idx = torch.arange(4, dtype=torch.int32, device=device)
    eye = torch.eye(m, dtype=torch.float32, device=device).expand(
        4, m, m).contiguous()
    path, line = _find(CSRC, "bank_qmm_pop.cu", r"float\s+code\(")
    for c in range(len(ops.BANK_CONFIGS)):
        got = ops.bank_qmm_pop(eye, packed, idx, config=c).cpu()
        same = [bool(torch.equal(got[k], f32[k])) for k in range(4)]
        report["bank_qmm_pop"][f"config={c}"] = same
        if not all(same):
            bad = [k for k in range(4) if not same[k]]
            out.append(Finding("K4", path, line, f"bank_qmm_pop config {c} "
                               f"on identity rows != the f32 bank for "
                               f"menu entries {bad}"))
    path, line = _find(CSRC, "quant_matmul.cu", r"float\s+code_f\(")
    K = 70
    wq = torch.randn((K, N * 8), generator=gen) / K ** 0.5
    eye = torch.eye(K, dtype=torch.float32, device=device)
    for bits in (2, 4, 8):
        p, s = ops.pack_for_kernel(wq, bits, float(wq.abs().max()) * 0.7)
        want = ref.unpack_weights(p, bits, K).to(torch.float32) * s[None, :]
        got = ops.quant_matmul(eye, p.to(device), s.to(device), bits).cpu()
        same = bool(torch.equal(got, want))
        report["quant_matmul"][f"bits={bits}"] = same
        if not same:
            out.append(Finding("K4", path, line, f"quant_matmul bits {bits} "
                               "on identity rows != the dequantized weight"))
    return out, report


# ------------------------------------------------------------------ runner

def run_drivers(device, driver_list=None) -> Tuple[List[Finding],
                                                    List[dict]]:
    """Each driver launched once on the card (K0's driven half)."""
    plan = launch_plan()
    sites = {(i.kernel, i.key): i.sites[-1] for i in instantiations()}
    out, rows = [], []
    for d in (drivers() if driver_list is None else driver_list):
        path, line = sites.get((d.kernel, d.key), plan.grid_sites[d.kernel])
        try:
            bad, row = run_driver(d, device)
        except Exception as e:          # a crash is a finding, not an exit
            bad, row = f"crashed: {e!r}", {"instantiation": d.name}
        rows.append(row)
        if bad:
            out.append(Finding("K0", path, line, f"driver {d.name} {bad}"))
    return out, rows


def run_kernel_checks(device="cpu") -> Tuple[List[Finding], dict]:
    """K0-K4. On the CPU the static rules; on a CUDA device all of them.
    Returns (findings sorted by place, report): the report holds, by
    rule, its counts and, on a card, each instantiation's driven result,
    resources, lane checks and identity products."""
    from repro_torch.kernels import ops
    device = torch.device(device)
    card = device.type == "cuda"
    t0 = time.perf_counter()
    plan = launch_plan()
    insts = instantiations()
    found: Dict[str, List[Finding]] = {r: [] for r in RULES}
    report: Dict[str, dict] = {r: {} for r in RULES}
    found["K0"] += check_coverage(plan=plan)
    report["K0"] = {"instantiations": len(insts), "drivers": len(drivers())}
    launches = [(d.kernel, d.key, d.shape, f" (driver {d.name})")
                for d in drivers()] + large_shapes()
    found["K1"] += check_interface() + check_launch_plans(plan, launches)
    report["K1"] = {"prototypes": len(build.prototypes()),
                    "launch_plans": len(launches)}
    found["K4"] += check_packing()
    if card:
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            for rule, part, name in (
                    ("K0", lambda: run_drivers(device), "driven"),
                    ("K2", lambda: check_path_indices(device), "paths"),
                    ("K2", lambda: check_lanes(device), "lanes"),
                    ("K3", lambda: check_resources(insts),
                     "instantiations"),
                    ("K4", lambda: check_packing_on_card(device),
                     "identity")):
                t = time.perf_counter()
                f, rep = part()
                torch.cuda.synchronize()
                found[rule] += f
                report[rule][name] = rep
                report[rule][f"{name}_s"] = time.perf_counter() - t
            for c, cfg in enumerate(plan.tiles):
                if ops.bank_config_info(c) != cfg:
                    path, line = _find(CSRC, "bank_gemm.cuh",
                                       rf"using\s+Config{c}\b")
                    found["K1"].append(Finding(
                        "K1", path, line, f"the library's configuration {c} "
                        "is not the one read off the source"))
    for r in RULES:
        report[r]["findings"] = len(found[r])
    report["seconds"] = time.perf_counter() - t0
    report["device"] = str(device)
    findings = sorted((f for r in RULES for f in found[r]),
                      key=lambda f: (f.path, f.line, f.rule))
    return findings, report
