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
- K2  index, lane and bounds discipline. Without a card: every global and
      shared access of the device code goes through ``csrc/checked.cuh``'s
      accessors (an indexed pointer parameter, local pointer or shared
      array, a unary dereference, ``__ldg``, ``cp_async`` or an L2
      prefetch written raw is a finding at its line), and each kernel
      source's ``enum Param`` names its C entry's pointer parameters in
      order (the checked build's extents follow it). On a card: every menu
      index of the bank calls of one SRU generation, one served SRU step
      and one xLSTM generation (the contract harnesses, through
      ``ops.observe_launches``) lies in [0, K); changing one lane's index
      and inputs (one row of x for ``quant_matmul``) leaves every other
      lane bitwise the same at a population that is not a multiple of a
      tile; an out-of-range index fills only its own lane with NaN. The
      bounds half (``check_bounds``, ``--checked``) runs the drivers, the
      ragged cases (``ragged_cases``) and the large shapes that fit on the
      card through the checked build (``build.checked``), where every
      access is held to its parameter's or shared array's extent: each must
      record no violation and equal the default library's output (bitwise
      for the bank kernels and the scan); a violation is a finding at the
      ``csrc`` line of its access.
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
prototypes and grids, K2's accessors and parameter enums, K4's round
trips), on a card all of them; ``check_bounds(device)`` is the checked
build's pass. The sanitizer pass (``python -m repro_torch.analysis --sanitize``) re-runs the
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

from repro_torch.kernels import build, ops

REPO = Path(__file__).resolve().parents[3]
CSRC = build.CSRC
INT32_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535
RTOL, ATOL = 1e-4, 1e-3
# instantiations that spilled when K3 was written (none: every one of
# chip_smoke.py's setup lines read 0 spill stores and loads); a spill in
# any other is a finding
KNOWN_SPILLS: Dict[tuple, int] = {}
KERNEL_IDS = tuple(ops.KERNEL_IDS)     # in kernel_attributes.cuh's order
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
    """A (m, N) weight on ``gen``'s device and its menu triples, with the
    most negative code of every grid present."""
    from repro_torch.core import quantization as Q
    w = torch.randn((m, N), generator=gen, device=gen.device) / m ** 0.5
    w[0, :4] = -w.abs().max() * 4
    amax = float(w.abs().max())
    trips = Q.menu_triples(Q.SUPPORTED_BITS, lambda b: amax if b == 16
                           else 0.5 * amax)
    return w, trips


def driver_inputs(d: Driver, device, seed: int = 0, draw_on="cpu"):
    """(args, kwargs) of the wrapper call of driver ``d`` on ``device``,
    drawn from a generator on ``draw_on`` (the CPU; the card for the large
    shapes)."""
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops
    gen = torch.Generator(device=draw_on).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    s, key = d.shape, dict(d.key)
    if d.kernel == "sru_scan_pop":
        P, B, T, n = s["P"], s["B"], s["T"], s["n"]
        u = randn(P, B, T, 3 * n).to(device)
        vecs = [(randn(n) * 0.5).to(device) for _ in range(4)]
        return (u[..., :n], u[..., n:2 * n], u[..., 2 * n:], *vecs), {}
    if d.kernel == "quant_matmul":
        w = randn(s["K"], s["N"]) / s["K"] ** 0.5
        packed, scales = ops.pack_for_kernel(w, key["bits"],
                                             float(w.abs().max()))
        x = randn(s["M"], s["K"])
        return (x.to(device), packed.to(device), scales.to(device),
                key["bits"]), {}
    P, M, m, N = s["P"], s["M"], s["m"], s["N"]
    w, trips = _menu_weight(m, N, gen)
    x = randn(P, M, m).to(device)
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


# ------------------------------------------------------------------ K2, static

# the types that device code points at
_POINTEE = (r"(?:float[24]?|int|unsigned(?:\s+int)?|u?int(?:8|16|32)_t|"
            r"char|void|uint[24])")
_PTR_DECL = re.compile(r"(?:\bconst\s+)?\b" + _POINTEE + r"\s*\*\s*"
                       r"(?:const\s+)?(?:__restrict__\s+)?([A-Za-z_]\w*)"
                       r"\s*(=\s*&?\s*\w*|[,;)\[])")
_SHARED_DECL = re.compile(r"__shared__[^;]*?\b([A-Za-z_]\w*)\s*\[")
_RAW_CALLS = ((re.compile(r"\b__ldg\s*\("), "__ldg"),
              (re.compile(r"\bcp_async\s*<[^<>]*>\s*\("), "cp_async"))
_PREFETCH = re.compile(r"prefetch\.global")     # in an asm string
ACCESSORS = ("CK_LD", "CK_LDG", "CK_ST", "CK_SH_LD", "CK_SH_ST",
             "CK_CP_ASYNC", "CK_PREFETCH")


def _blank(text: str) -> str:
    """``text`` with comments and string literals blanked (newlines kept,
    so offsets keep their lines)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"', blank, text,
                  flags=re.S)


def _close(text: str, i: int) -> int:
    """The offset just past the bracket that closes the one at ``i``."""
    pairs = {"{": "}", "(": ")"}
    want, depth = pairs[text[i]], 0
    for j in range(i, len(text)):
        if text[j] == text[i]:
            depth += 1
        elif text[j] == want:
            depth -= 1
            if depth == 0:
                return j + 1
    raise ValueError("unbalanced source")


def _is_product(before: str) -> bool:
    """Whether a ``*`` after ``before`` (stripped) multiplies or declares:
    it follows an operand, but not the ``)`` of an ``if``/``for``/``while``
    header."""
    if not before or not (before[-1].isalnum() or before[-1] in "_)]>"):
        return False
    if before[-1] != ")":
        return True
    depth = 0
    for j in range(len(before) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(before[j], 0)
        if depth == 0:
            return not re.search(r"\b(?:if|for|while|switch)\s*$",
                                 before[:j])
    return True


def _device_functions(text: str):
    """(head, body offset, body) of every ``__device__``/``__global__``
    function definition of blanked ``text``."""
    out = []
    for m in re.finditer(r"\b__(?:device|global)__\b", text):
        j = m.end()
        depth = 0
        while j < len(text):
            ch = text[j]
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif depth == 0 and ch in ";{":
                break
            j += 1
        if j < len(text) and text[j] == "{":
            out.append((text[m.start():j], j, text[j:_close(text, j)]))
    return out


def _struct_members(text: str) -> List[Tuple[int, int, set]]:
    """(start, end, pointer members) of every struct of blanked ``text``."""
    out = []
    for m in re.finditer(r"\bstruct\s+\w+[^;{]*\{", text):
        start = m.end() - 1
        end = _close(text, start)
        body = text[start + 1:end - 1]
        flat = re.sub(r"\{[^{}]*\}", "", body)      # method bodies out
        while re.search(r"\{[^{}]*\}", flat):
            flat = re.sub(r"\{[^{}]*\}", "", flat)
        names = {g.group(1) for g in _PTR_DECL.finditer(flat)
                 if g.group(2).strip() in (";", ",")}
        out.append((start, end, names))
    return out


def _pointer_names(head: str, body: str, members: set) -> set:
    """The names in scope of one device function that point at memory:
    its pointer parameters, the members of its struct, its shared arrays
    and its local pointers, but not a local pointer set from the address of
    a register array (``&acc[i][j]``)."""
    names = set(members)
    names |= {g.group(1) for g in _PTR_DECL.finditer(head)}
    names |= {g.group(1) for g in _SHARED_DECL.finditer(body)}
    for g in _PTR_DECL.finditer(body):
        init = g.group(2).replace(" ", "")
        if init.startswith("=&") and init[2:] not in names:
            continue                          # an alias of registers
        names.add(g.group(1))
    return names


def raw_accesses(path: Path) -> List[Tuple[int, str]]:
    """(line, what) of every raw global or shared access in the device
    code of one source file: an indexed pointer (not ``&p[i]``), a unary
    dereference of a pointer or a cast, and ``__ldg``, ``cp_async`` or an
    L2 prefetch written outside ``checked.cuh``'s accessors."""
    raw = path.read_text()
    text = _blank(raw)
    structs = _struct_members(text)
    out = []
    for head, off, body in _device_functions(text):
        members = set().union(*(n for s, e, n in structs if s < off < e))
        names = _pointer_names(head, body, members)
        hits = []
        for m in re.finditer(r"\b([A-Za-z_]\w*)\s*\[", body):
            if m.group(1) in names and not re.search(
                    r"&\s*$", body[:m.start()]) and not re.search(
                    r"(__shared__|" + _POINTEE + r")[^;=]*$",
                    body[:m.start()]):
                hits.append((m.start(), f"{m.group(1)}[...]"))
        for m in re.finditer(r"\*\s*(reinterpret_cast\b|\(|[A-Za-z_]\w*)",
                             body):
            if _is_product(body[:m.start()].rstrip()):
                continue
            what = m.group(1)
            if what in ("reinterpret_cast", "(") or what in names:
                hits.append((m.start(), f"*{what}"))
        for pattern, what in _RAW_CALLS:
            hits += [(m.start(), what) for m in pattern.finditer(body)]
        hits += [(m.start(), "L2 prefetch") for m in _PREFETCH.finditer(
            raw[off:off + len(body)])]
        out += [(_line_of(text, off + pos), what) for pos, what in hits]
    return sorted(set(out))


def check_accessors(csrc: Path = CSRC) -> Tuple[List[Finding], dict]:
    """K2 without a card: every global and shared access of the device
    code of ``csrc/*.cu*`` goes through ``checked.cuh``'s accessors (a raw
    access is a finding at its line; ``checked.cuh`` itself is where they
    are written), and each kernel source's ``enum Param`` lists its C
    entry's pointer parameters, uppercased, in order."""
    out, sites = [], 0
    for f in sorted(Path(csrc).glob("*.cu*")):
        if f.name == "checked.cuh":
            continue
        sites += len(re.findall(r"\b(?:" + "|".join(ACCESSORS) + r")\s*\(",
                                _blank(f.read_text())))
        for line, what in raw_accesses(f):
            out.append(Finding("K2", _rel(f), line, f"raw access {what}: not "
                               "through checked.cuh's accessors"))
    protos = build.prototypes(csrc)
    for kernel in KERNEL_IDS:
        f = Path(csrc) / f"{kernel}.cu"
        text = f.read_text()
        m = re.search(r"enum\s+Param\s*\{([^}]*)\}", text)
        want = [p.upper() for p in pointer_params(csrc, kernel)]
        if m is None:
            path, line = plan_site = (_rel(f), 1)
            out.append(Finding("K2", path, line, f"{kernel}: no enum Param "
                               f"(want {want})"))
            continue
        got = [v.strip() for v in m.group(1).split(",") if v.strip()]
        if got != want:
            out.append(Finding("K2", _rel(f), _line_of(text, m.start()),
                               f"{kernel}: enum Param {got} is not the C "
                               f"entry's pointer parameters {want}"))
    return out, {"accessor_sites": sites, "sources": len(
        list(Path(csrc).glob("*.cu*"))), "entries_checked": len(
            [k for k in KERNEL_IDS if f"repro_{k}" in protos])}


def pointer_params(csrc: Path, kernel: str) -> List[str]:
    """The pointer parameters of ``repro_<kernel>``'s prototype in order,
    the stream left out: the order of the checked build's extents."""
    text = (Path(csrc) / f"{kernel}.cu").read_text()
    m = next(m for m in build._PROTOTYPE.finditer(text)
             if m.group(1) == f"repro_{kernel}")
    names = []
    for param in m.group(2).split(","):
        param = " ".join(param.split())
        name = re.search(r"(\w+)$", param).group(1)
        if "*" in param and name != "stream":
            names.append(name)
    return names


# ------------------------------------------------------------------ K2, bounds

RECORD = 13                     # csrc/checked.cuh's ck::RECORD
CHECKED_FREE_SHARE = 0.8        # a large case runs if it needs less of the card


def ragged_cases() -> List[Driver]:
    """Shapes that are multiples of no tile, for the checked pass: the bank
    GEMM at M 133 (BM 128 and 16), m 37 (BK 16), N 197 (BN 128 and 64; odd,
    so the f32 rows' copies fall to 4 bytes and the int8 containers' loads
    to 1) with five lanes (the last bank row selected), and at 1 x 1 x 1;
    ``quant_matmul`` past one x slice with x staged by element (K % 4 != 0)
    and by 16-byte loads, with the packed rows' vector loads off (N % 8 !=
    0) and on; the scan at T = 1 and at T 17 (past two prefetch stages)
    with P B n no multiple of the block."""
    out = []
    for c in range(len(ops.BANK_CONFIGS)):
        for shape in ({"P": 5, "M": 133, "m": 37, "N": 197, "K": 4},
                      {"P": 5, "M": 1, "m": 1, "N": 1, "K": 4}):
            out.append(Driver("bank_mxv_pop", (("config", c), ("width", 4)),
                              shape))
            out.append(Driver("bank_qmm_pop", (("config", c),), shape))
    for bits in (2, 4, 8):
        out.append(Driver("quant_matmul", (("bits", bits), ("mt", 8),
                                           ("vec", False)),
                          {"M": 5, "K": 1036, "N": 1001}))
        out.append(Driver("quant_matmul", (("bits", bits), ("mt", 4),
                                           ("vec", True)),
                          {"M": 3, "K": 2053, "N": 520}))
    out.append(Driver("sru_scan_pop", (), {"P": 1, "B": 1, "T": 1, "n": 1}))
    out.append(Driver("sru_scan_pop", (), {"P": 2, "B": 3, "T": 17,
                                           "n": 301}))
    return out


def large_cases() -> List[Tuple[Driver, str]]:
    """``large_shapes()`` as drivers with their labels: the LM heads at
    int8 (the heads' width), the bank GEMM at the copy width of an aligned
    bank, the scan."""
    plan = launch_plan()
    out = []
    for kernel, key, shape, label in large_shapes():
        if kernel == "quant_matmul":
            key = (("bits", 8), ("mt", qmm_rows(plan, shape["M"])),
                   ("vec", shape["N"] % (plan.qmm_bn // 32) == 0))
        elif kernel == "bank_mxv_pop":
            key = (("config", key["config"]),
                   ("width", ops.copy_width(4 * shape["N"])))
            shape = {**shape, "K": 4}
        elif kernel == "bank_qmm_pop":
            key = (("config", key["config"]),)
        else:
            key = ()
        out.append((Driver(kernel, key, shape), label.strip(" ()")))
    return out


def case_bytes(d: Driver) -> int:
    """Device bytes a case holds at once: its inputs and two outputs (the
    default library's and the checked one's)."""
    s = d.shape
    if d.kernel == "sru_scan_pop":
        e = s["P"] * s["B"] * s["T"] * s["n"]
        return 4 * (3 * e + 2 * (2 * e + s["P"] * s["B"] * s["n"]))
    if d.kernel == "quant_matmul":
        return (4 * s["M"] * s["K"] + 5 * s["K"] * s["N"]
                + 8 * s["M"] * s["N"])
    x = 4 * s["P"] * s["M"] * s["m"]
    w = 4 * s["m"] * s["N"] * (2 + 4)        # w and its four bank rows
    return x + w + 8 * s["P"] * s["M"] * s["N"]


def read_record(lib) -> dict:
    """``repro_checked_report``'s record (the checked build's violations
    since the last read), decoded; the record is cleared."""
    out = (ctypes.c_longlong * RECORD)()
    err = lib.repro_checked_report(ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"repro_checked_report: error {err}")
    names = {file_id(f.name): f.name for f in CSRC.glob("*.cu*")}
    return {"violations": out[0], "kernel": KERNEL_IDS[out[1]]
            if 0 <= out[1] < len(KERNEL_IDS) else None, "line": out[2],
            "param": out[3], "offset": out[4], "width": out[5],
            "extent": out[6], "itemsize": out[7],
            "block": [out[8], out[9], out[10]], "thread": out[11],
            "file": names.get(out[12] & 0xFFFFFFFF, f"file {out[12]:#x}")}


def file_id(name: str) -> int:
    """``checked.cuh``'s ``ck::file_id``: 32-bit FNV-1a of a file name."""
    h = 2166136261
    for byte in name.encode():
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


def _violation(rec: dict, csrc: Path, label: str) -> Finding:
    kernel = rec["kernel"]
    params = pointer_params(csrc, kernel) if kernel else []
    what = (params[rec["param"]] if 0 <= rec["param"] < len(params)
            else "shared memory")
    size = max(rec["itemsize"], 1)
    return Finding("K2", _rel(Path(csrc) / rec["file"]), rec["line"],
                   f"{kernel} ({label}): {rec['violations']} out-of-bounds "
                   f"access(es); the first: {what}, "
                   f"{rec['width']} bytes at element {rec['offset'] // size} "
                   f"(byte {rec['offset']}) of an extent of "
                   f"{rec['extent'] // size} elements, block "
                   f"{tuple(rec['block'])} thread {rec['thread']}")


def check_bounds(device, csrc: Path = CSRC, cases=None, emit=None
                 ) -> Tuple[List[Finding], dict]:
    """K2's bounds half on the card: each case ((driver, label) pairs; by
    default ``drivers()``, ``ragged_cases()`` and every ``large_cases()``
    one whose bytes fit in ``CHECKED_FREE_SHARE`` of the free memory) runs
    once through the default library and once through the checked build of
    ``csrc``. A recorded violation is a finding at its access; so is an
    output that differs (bitwise for the bank kernels and the scan, past
    ``RTOL``/``ATOL`` for ``quant_matmul``). ``emit(row)`` gets each case's
    row as it ends."""
    t0 = time.perf_counter()
    build.build(checked=True, csrc=csrc)
    build_s = time.perf_counter() - t0
    if cases is None:
        cases = ([(d, "driver") for d in drivers()]
                 + [(d, "ragged") for d in ragged_cases()]
                 + large_cases())
    out, rows, skipped = [], [], []
    with build.checked(csrc) as lib:
        read_record(lib)                      # nothing left from before
    default = build.load()
    if default.repro_checked_report(ctypes.cast(
            (ctypes.c_longlong * RECORD)(), ctypes.c_void_p)) \
            != build.UNCHECKED:
        path, line = _find(Path(csrc), "checked.cu",
                           r"int repro_checked_report")
        out.append(Finding("K2", path, line, "the default library's "
                           "repro_checked_report is not unchecked"))
    for d, label in cases:
        if label not in ("driver", "ragged"):
            torch.cuda.empty_cache()        # the last case's blocks back
            free = torch.cuda.mem_get_info(device)[0]
            if case_bytes(d) > CHECKED_FREE_SHARE * free:
                skipped.append({"case": d.name, "label": label,
                                "bytes": case_bytes(d), "free": free})
                continue
        t = time.perf_counter()
        try:
            args, kwargs = driver_inputs(
                d, device, draw_on="cpu" if label in ("driver", "ragged")
                else device)
            fn = getattr(ops, d.kernel)
            want = _as_tuple(fn(*args, **kwargs))
            with build.checked(csrc) as lib:
                got = _as_tuple(fn(*args, **kwargs))
                rec = read_record(lib)
        except Exception as e:          # a crash is a finding, not an exit
            path, line = _find(Path(csrc), f"{d.kernel}.cu",
                               r'extern "C" int repro_')
            out.append(Finding("K2", path, line, f"{d.name} ({label}) "
                               f"crashed: {e!r}"))
            rows.append({"case": d.name, "label": label, "shape": d.shape,
                         "error": repr(e)})
            if emit is not None:
                emit(rows[-1])
            continue
        if d.kernel == "quant_matmul":
            equal = all(torch.allclose(g, w, rtol=RTOL, atol=ATOL)
                        for g, w in zip(got, want))
        else:
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
        row = {"case": d.name, "label": label, "shape": d.shape,
               "violations": rec["violations"], "equal": equal,
               "seconds": time.perf_counter() - t}
        rows.append(row)
        if emit is not None:
            emit(row)
        if rec["violations"]:
            out.append(_violation(rec, csrc, f"{d.name}, {label}"))
        if not equal:
            path, line = _find(Path(csrc), f"{d.kernel}.cu",
                               r'extern "C" int repro_')
            out.append(Finding("K2", path, line, f"{d.name} ({label}): the "
                               "checked build's output differs from the "
                               "default library's"))
        del args, want, got
    return out, {"build_s": build_s, "cases": len(rows),
                 "violations": sum(r.get("violations", 0) for r in rows),
                 "unequal": sum(r.get("equal") is False for r in rows),
                 "crashed": sum("error" in r for r in rows),
                 "skipped": skipped, "rows": rows,
                 "seconds": time.perf_counter() - t0}


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
    f, static = check_accessors()
    found["K2"] += f
    report["K2"].update(static)
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
