"""The kernel build's bookkeeping, driven by a stand-in compiler (the CPU
has no ``nvcc``): one timed compile per ``csrc/*.cu`` plus one link, a
cached library on the second call, and no temporary directory left behind
when a command fails."""
import re
import sys

import pytest

from repro_torch.kernels import build

STAND_IN = """#!{python}
import sys
args = sys.argv[1:]
if {refuse!r} in args[-1]:
    sys.exit("stand-in compiler: refused " + args[-1])
with open(args[args.index("-o") + 1], "w") as f:
    f.write("object")
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    def make(refuse):
        nvcc = tmp_path / "nvcc"
        nvcc.write_text(STAND_IN.format(python=sys.executable, refuse=refuse))
        nvcc.chmod(0o755)
        root = tmp_path / "kernels"
        monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
        monkeypatch.setattr(build, "BUILD_ROOT", root)
        return root
    return make


def test_build_compiles_each_source_then_links_once(stand_in):
    root = stand_in(refuse="no-such-source")
    lib = build.build()
    assert lib.exists() and lib.parent.parent == root
    log = (lib.parent / "build.log").read_text()
    n = len(build.sources())
    assert log.count(" -c -o ") == n and log.count(" -shared ") == 1
    assert len(re.findall(r"^\[\d+\.\d{3} s\]$", log, re.M)) == n + 1
    assert [d.name for d in root.iterdir()] == [lib.parent.name]
    assert build.build() == lib                  # cached: nothing rebuilt


def test_failed_build_raises_and_leaves_no_temporary_directory(stand_in):
    root = stand_in(refuse="quant_matmul.cu")
    with pytest.raises(RuntimeError, match="refused .*quant_matmul.cu"):
        build.build()
    assert list(root.iterdir()) == []
