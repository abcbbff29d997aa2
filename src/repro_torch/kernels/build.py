"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

One ``nvcc -c`` per ``csrc/*.cu``, all started together, compiles the
sources for ``sm_90a``; one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``build/kernels/<hash>/`` at the repository root
(listed in ``.gitignore``), keyed by a hash of the sources, the flags and the
compiler, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of csrc/*.cu: every pointer and the stream are c_void_p, or
# ctypes would pass them as 32-bit ints
SIGNATURES = {
    "repro_sru_scan_pop": [_P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _P],
    "repro_bank_mxv_pop": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_bank_qmm_pop": [_P, _P, _P, _P, _P, _P, _I, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_bank_config_info": [_I, _P],
    "repro_quant_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_quant_matmul_occupancy": [_I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


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


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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


def build() -> Path:
    """Compile the library if it is missing; return its path. The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) and each command's wall seconds (a ``[<s> s]`` line) are kept
    beside it in ``build.log``. Objects and library go to a temporary
    directory that is renamed into place, so concurrent builders never load
    a half-written library; the temporary directory never outlives the
    call."""
    nvcc = nvcc_path()
    out = BUILD_ROOT / _digest(nvcc) / LIB_NAME
    if out.exists():
        return out
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        srcs = sources()
        objs = [str(tmp / f"{src.stem}.o") for src in srcs]
        runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                         for obj, src in zip(objs, srcs)])
        if all(rc == 0 for _, rc, _, _ in runs):
            runs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp / LIB_NAME),
                               *objs]])
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


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every C
    function's ``argtypes`` and ``restype`` declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
