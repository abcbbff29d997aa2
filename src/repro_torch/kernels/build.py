"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

One ``nvcc -c`` per ``csrc/*.cu``, all started together, compiles the
sources for ``sm_90a``; one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/kernels/<hash>/`` at the repository root
(listed in ``.gitignore``), keyed by a hash of the sources, the flags and the
compiler, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.

The checked build (``build(checked=True)``) compiles the same sources with
``-DREPRO_CHECKED`` (``csrc/checked.cuh``: every global and shared access
held to its extent) into a library of its own. Only the kernel verifier
uses it, inside ``with checked():``, where ``load()`` returns it; outside
that block ``load()`` is the default library, and no wrapper falls from
one to the other.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# the checked build's: its macro, and no STB_GNU_UNIQUE symbols (a
# function's static, bank_gemm.cuh's allow_smem, would otherwise be one
# object for both libraries in one process, the same names coming from the
# same sources)
CHECKED_FLAGS = ("-DREPRO_CHECKED", "-Xcompiler", "-fno-gnu-unique")
# ... and NVVM at -O1, which compiles a checked source several times
# faster (the checks put a branch and a call on every access of the
# unrolled loops) and rounds every operation the kernels round explicitly
# (fmaf, __fmul_rn) the same; but at -O1 the bank GEMM's register tile
# stays in local memory (the xLSTM head's MxV ran about ten times slower on
# the H100), so its two sources keep -O3
CHECKED_QUICK = ("-Xcicc", "-O1")
CHECKED_FULL_OPT = ("bank_mxv_pop.cu", "bank_qmm_pop.cu")
# ... linked to bind its own symbols before any other library's
CHECKED_LINK_FLAGS = ("-Xlinker", "-Bsymbolic")
# what csrc/checked.cuh's C entries return in the default build
UNCHECKED = -1

# The ctypes of the C entries' parameter kinds: every pointer, the stream
# included, is c_void_p, or ctypes would pass it as a 32-bit int
CTYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
          "long long": ctypes.c_longlong}
_PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')

_libs: Dict[Path, ctypes.CDLL] = {}          # by library path
_default: Optional[ctypes.CDLL] = None      # load()'s library
_checked: Optional[ctypes.CDLL] = None      # load()'s library inside checked()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit
    PyTorch found."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources(csrc: Path = CSRC):
    return sorted(Path(csrc).glob("*.cu"))


def param_kind(param: str) -> str:
    """"ptr", "int" or "long long" for a C parameter, else its text."""
    p = " ".join(param.split())
    if "*" in p:
        return "ptr"
    if re.search(r"\blong\s+long\b", p):
        return "long long"
    if re.match(r"(const\s+)?int\s+\w+$", p):
        return "int"
    return p


def prototypes(csrc: Path = CSRC) -> Dict[str, Tuple[Path, int, tuple]]:
    """Every ``extern "C" int name(...)`` of ``csrc/*.cu``: name -> (file,
    line, its parameters' ``param_kind``s in order)."""
    out = {}
    for f in sorted(csrc.glob("*.cu")):
        text = f.read_text()
        for m in _PROTOTYPE.finditer(text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = (f, text.count("\n", 0, m.start()) + 1,
                               tuple(param_kind(p) for p in params))
    return out


def signatures(csrc: Path = CSRC) -> Dict[str, list]:
    """Each C entry's ctypes ``argtypes``, read off its prototype; raises
    on a parameter whose kind has no ctypes (``CTYPES``)."""
    out = {}
    for name, (f, line, kinds) in prototypes(csrc).items():
        bad = [k for k in kinds if k not in CTYPES]
        if bad:
            raise ValueError(f"{f}:{line}: {name} has parameters of no "
                             f"ctypes kind: {bad}")
        out[name] = [CTYPES[k] for k in kinds]
    return out


def nvcc_flags(checked: bool = False, source: Optional[Path] = None
               ) -> tuple:
    """The compile flags of ``source`` in the default or the checked
    build."""
    if not checked:
        return NVCC_FLAGS
    quick = source is None or Path(source).name not in CHECKED_FULL_OPT
    return NVCC_FLAGS + CHECKED_FLAGS + (CHECKED_QUICK if quick else ())


def link_flags(checked: bool = False) -> tuple:
    return LINK_FLAGS + (CHECKED_LINK_FLAGS if checked else ())


def _digest(nvcc: str, checked: bool = False, csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for f in sorted(Path(csrc).glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    for f in sources(csrc):
        h.update(" ".join(nvcc_flags(checked, f)).encode())
    h.update(" ".join(link_flags(checked)).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run every command at once; returns [(cmd, returncode, output,
    seconds)] in the order given."""
    def run(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return (cmd, proc.returncode, proc.stdout + proc.stderr,
                time.perf_counter() - t0)
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        return list(pool.map(run, cmds))


def build(checked: bool = False, csrc: Path = CSRC) -> Path:
    """Compile the library of ``csrc`` (the default or, with ``checked``,
    the checked build) if it is missing; return its path. The compilers'
    output (``-Xptxas -v``: registers, shared memory, spills per kernel)
    and each command's wall seconds (a ``[<s> s]`` line) are kept beside it
    in ``build.log``. Objects and library go to a temporary directory that
    is renamed into place, so concurrent builders never load a half-written
    library; the temporary directory never outlives the call."""
    nvcc = nvcc_path()
    out = BUILD_ROOT / _digest(nvcc, checked, csrc) / LIB_NAME
    if out.exists():
        return out
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        srcs = sources(csrc)
        objs = [str(tmp / f"{src.stem}.o") for src in srcs]
        runs = _run_all([[nvcc, *nvcc_flags(checked, src), "-c", "-o", obj,
                          str(src)]
                         for obj, src in zip(objs, srcs)])
        if all(rc == 0 for _, rc, _, _ in runs):
            runs += _run_all([[nvcc, *link_flags(checked), "-o",
                               str(tmp / LIB_NAME), *objs]])
        log = "".join(f"{' '.join(cmd)}\n[{secs:.3f} s]\n{text}"
                      for cmd, _, text, secs in runs)
        if any(rc != 0 for _, rc, _, _ in runs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        (tmp / "build.log").write_text(log)
        try:
            os.replace(tmp, out.parent)
        except OSError:
            if not out.exists():      # else another builder finished first
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _open(path: Path, csrc: Path) -> ctypes.CDLL:
    """The library at ``path`` (loaded once), with every C function's
    ``argtypes`` (read off its prototype in ``csrc``) and ``restype``
    declared."""
    if path not in _libs:
        lib = ctypes.CDLL(str(path))
        for name, args in signatures(csrc).items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _libs[path] = lib
    return _libs[path]


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call): the default one,
    or inside ``checked()`` the checked one. Every wrapper calls it at
    every launch, so after the first call it hashes nothing."""
    global _default
    if _checked is not None:
        return _checked
    if _default is None:
        _default = _open(build(), CSRC)
    return _default


def checking() -> bool:
    """Whether ``load()`` returns the checked library (inside
    ``checked()``); the wrappers then pass their operands' extents before
    each launch."""
    return _checked is not None


@contextlib.contextmanager
def checked(csrc: Path = CSRC):
    """Inside the block ``load()`` returns the checked library of ``csrc``
    (built first; a failed build raises, nothing falls back). Yields it."""
    global _checked
    lib = _open(build(checked=True, csrc=csrc), csrc)
    outer, _checked = _checked, lib
    try:
        yield lib
    finally:
        _checked = outer
