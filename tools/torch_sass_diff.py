"""Compare the machine code of two builds of the port's kernel library.

    python tools/torch_sass_diff.py LIB_A LIB_B
    python tools/torch_sass_diff.py --compile SOURCE.cu --times 8

Disassembles both ``librepro_torch_kernels.so`` files with ``cuobjdump
-sass`` (from the CUDA toolkit beside ``nvcc``) and compares them kernel by
kernel, instruction by instruction, addresses and encodings left out.
Kernel names are matched with the hash that nvcc puts in an anonymous
namespace's name (it follows the source file's text) replaced by the file's
name. Prints one line a kernel that differs (its instruction counts and
first differing instructions), then the kernels and instructions of each
library and the count that differ; exits 1 if any differs.

``--compile`` compiles one source ``--times`` times at once with the
default build's flags (``build.NVCC_FLAGS``) and prints, for each kernel,
how many different instruction sequences those compiles gave: a measure of
the compiler's own run-to-run variation, against which a difference
between two libraries is read.
"""
from __future__ import annotations

import argparse
import difflib
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build  # noqa: E402

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+")


def kernels(lib: Path) -> dict:
    """Each kernel's instructions, by its name with the anonymous
    namespace's hash replaced by its file's name."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _ANON.sub(r"anon_\1", m.group(1))
            out[name] = []
        elif line.startswith(("Fatbin ", "=====")):
            name = None                  # the next module's header
        elif name is not None:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "",
                         line).strip()
            if ins:
                out[name].append(ins)
    return out


def compile_variants(source: Path, times: int) -> dict:
    """Kernel name -> the number of different instruction sequences that
    ``times`` compiles of ``source``, run at once, gave."""
    with tempfile.TemporaryDirectory() as tmp:
        def one(i):
            obj = Path(tmp) / f"{i}.o"
            subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-c", "-o",
                            str(obj), str(source)], capture_output=True,
                           check=True)
            return kernels(obj)
        with ThreadPoolExecutor(times) as pool:
            runs = list(pool.map(one, range(times)))
    return {name: len({tuple(r[name]) for r in runs}) for name in runs[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("lib_a", type=Path, nargs="?")
    ap.add_argument("lib_b", type=Path, nargs="?")
    ap.add_argument("--compile", type=Path, metavar="SOURCE")
    ap.add_argument("--times", type=int, default=8)
    args = ap.parse_args(argv)
    if args.compile:
        variants = compile_variants(args.compile, args.times)
        for name, n in sorted(variants.items()):
            print(f"{n} variant(s) in {args.times} compiles: {name}")
        return int(any(n > 1 for n in variants.values()))
    a, b = kernels(args.lib_a), kernels(args.lib_b)
    differ = 0
    for name in sorted(set(a) | set(b)):
        x, y = a.get(name, []), b.get(name, [])
        if x != y:
            differ += 1
            lines = [ln for ln in difflib.unified_diff(x, y, lineterm="", n=0)
                     if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
            print(f"differs: {name} ({len(x)} / {len(y)} instructions): "
                  + " || ".join(lines[:6]))
    print(f"kernels {len(a)} / {len(b)}, instructions "
          f"{sum(map(len, a.values()))} / {sum(map(len, b.values()))}, "
          f"kernels that differ {differ}")
    return int(differ > 0)


if __name__ == "__main__":
    sys.exit(main())
