"""Tests for the checked build of the port's kernels (``csrc/checked.cuh``)
and the kernel verifier's rule K2 over it.

Without a card: the static rule finds every global and shared access of
the real sources behind ``checked.cuh``'s accessors, and exactly one
finding at the right line in a copy with one accessor unwrapped (also a
dereference, a raw ``__ldg`` and a raw ``cp_async``, one copy each); each
kernel's ``enum Param`` is its C entry's pointer parameters; the default
build's flags carry no ``REPRO_CHECKED`` and the checked build hashes to
another directory; ``build.checked()`` is scoped; the wrappers' extents
follow their tensors. On a card (``gpu``, skipped here): every driver,
ragged case and large shape reads no violation and equals the default
library, and a copy of ``csrc`` with ``BCopier``'s column mask dropped is
caught at its copy."""
import ctypes
import shutil

import pytest
import torch

from repro_torch.analysis import kernel_rules as kr
from repro_torch.kernels import build, ops


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def csrc(tmp_path):
    """A copy of the kernel sources to sabotage."""
    dst = tmp_path / "csrc"
    shutil.copytree(kr.CSRC, dst)
    return dst


def _edit(path, old, new):
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


def _line(path, needle):
    text = path.read_text()
    return text.count("\n", 0, text.index(needle)) + 1


# ---------------------------------------------------------------- static

def test_real_sources_read_every_access_through_the_accessors():
    findings, report = kr.check_accessors()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert report["accessor_sites"] >= 45
    assert report["entries_checked"] == 4


@pytest.mark.parametrize("name, old, new, needle, what", [
    ("sru_scan_pop.cu", "CK_ST(C_LAST, c_last + (pb * n + j), c);",
     "c_last[pb * n + j] = c;", "c_last[pb * n + j] = c;", "c_last[...]"),
    ("bank_qmm_pop.cu", "for (int j = 0; j < G::COLS; ++j) CK_SH_ST(dst + j, "
     "v[j]);", "for (int j = 0; j < G::COLS; ++j) dst[j] = v[j];",
     "dst[j] = v[j];", "dst[...]"),
    ("bank_gemm.cuh", "const float4 v = CK_SH_LD(reinterpret_cast<const "
     "float4*>(p));", "const float4 v = *reinterpret_cast<const "
     "float4*>(p);", "const float4 v = *reinterpret_cast",
     "*reinterpret_cast"),
    ("quant_matmul.cu", "w[0] = CK_LDG(PACKED, reinterpret_cast<const "
     "unsigned int*>(p));", "w[0] = __ldg(reinterpret_cast<const unsigned "
     "int*>(p));", "w[0] = __ldg(", "__ldg"),
    ("bank_gemm.cuh", "CK_CP_ASYNC(4, XP, dst + dst0 + i * STEP, ok ? p : "
     "src, ok ? 4 : 0);", "cp_async<4>(dst + dst0 + i * STEP, ok ? p : src, "
     "ok ? 4 : 0);", "cp_async<4>(dst + dst0", "cp_async"),
    ("quant_matmul.cu", "if (r < rows && sector < N) CK_PREFETCH(PACKED, "
     "packed + r * N + sector);", "if (r < rows && sector < N) asm "
     "volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(packed + r * N + "
     "sector));", "asm volatile(\"prefetch.global.L2", "L2 prefetch"),
])
def test_one_unwrapped_access_is_one_finding(csrc, name, old, new, needle,
                                             what):
    _edit(csrc / name, old, new)
    findings, _ = kr.check_accessors(csrc)
    assert len(findings) == 1, [f.format() for f in findings]
    (f,) = findings
    assert f.rule == "K2" and f.path.endswith(f"csrc/{name}")
    assert f.line == _line(csrc / name, needle)
    assert f"raw access {what}" in f.message


def test_register_alias_and_address_of_are_not_accesses():
    """``&red[...]`` computes an address and ``v = &acc[i][h * 4]`` points
    at registers: neither is a memory access."""
    qm = kr.CSRC / "quant_matmul.cu"
    assert "&red[" in qm.read_text()
    assert "const float* v = &acc[" in (kr.CSRC / "bank_gemm.cuh").read_text()
    assert kr.raw_accesses(qm) == []


def test_param_enum_follows_the_c_entry(csrc):
    assert kr.pointer_params(kr.CSRC, "bank_qmm_pop") == [
        "x", "q2", "q4", "q8", "q16", "scale", "idx", "out"]
    assert kr.pointer_params(kr.CSRC, "sru_scan_pop") == [
        "uw", "uf", "ur", "vf", "vr", "bf", "br", "h", "r", "c_last"]
    qm = csrc / "quant_matmul.cu"
    _edit(qm, "enum Param { X, PACKED, SCALES, OUT };",
          "enum Param { X, SCALES, PACKED, OUT };")
    findings, _ = kr.check_accessors(csrc)
    assert len(findings) == 1, [f.format() for f in findings]
    assert findings[0].line == _line(qm, "enum Param")
    assert "pointer parameters ['X', 'PACKED', 'SCALES', 'OUT']" in \
        findings[0].message


def test_static_rules_run_from_the_cli_on_the_cpu(capsys):
    from repro_torch.analysis import __main__ as cli
    assert cli.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"rule": "K2"' in out and '"accessor_sites"' in out


# ---------------------------------------------------------------- build

def test_default_flags_carry_no_checked_macro():
    assert not any("REPRO_CHECKED" in f for f in build.NVCC_FLAGS)
    assert build.nvcc_flags() == build.NVCC_FLAGS
    assert build.nvcc_flags(checked=True)[:len(build.NVCC_FLAGS) + 1] == \
        build.NVCC_FLAGS + ("-DREPRO_CHECKED",)
    assert build.link_flags() == build.LINK_FLAGS
    assert build._digest("nvcc") != build._digest("nvcc", checked=True)
    assert build._digest("nvcc") == build._digest("nvcc", csrc=kr.CSRC)


def test_checked_build_keeps_the_bank_gemm_optimized():
    """The checked build's NVVM runs at -O1 but for the bank GEMM's two
    sources, whose register tile needs the unrolled loops; the default
    build's flags are the same for every source."""
    quick = ("-Xcicc", "-O1")
    for src in build.sources():
        flags = build.nvcc_flags(True, src)
        assert "-DREPRO_CHECKED" in flags
        joined = " ".join(flags)
        assert (" ".join(quick) in joined) == (
            src.name not in ("bank_mxv_pop.cu", "bank_qmm_pop.cu")), src
        assert build.nvcc_flags(False, src) == build.NVCC_FLAGS


def test_checked_build_hashes_its_sources(csrc):
    assert build._digest("nvcc", True, csrc) == build._digest("nvcc", True)
    _edit(csrc / "checked.cuh", "constexpr int MAX_PARAMS = 12;",
          "constexpr int MAX_PARAMS = 13;")
    assert build._digest("nvcc", True, csrc) != build._digest("nvcc", True)


def test_new_entries_exist_in_both_builds():
    """The checked build's C entries are plain prototypes (not behind
    ``#ifdef``), so the default library declares them too."""
    sigs = build.signatures()
    assert sigs["repro_checked_extents"] == [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert sigs["repro_checked_report"] == [ctypes.c_void_p]
    text = (kr.CSRC / "checked.cu").read_text()
    assert "#ifdef" not in text and "REPRO_CHECKED" not in text


def test_checked_switch_is_scoped(monkeypatch):
    """Inside ``build.checked()`` ``load()`` is the checked library, and
    after the block (even one that raised) the default one again."""
    libs = {}

    def fake_build(checked=False, csrc=kr.CSRC):
        return f"lib-{'checked' if checked else 'default'}-{csrc.name}"

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "_open",
                        lambda path, csrc: libs.setdefault(path, object()))
    monkeypatch.setattr(build, "_default", None)
    default = build.load()
    assert not build.checking()
    with build.checked() as lib:
        assert build.checking() and build.load() is lib is not default
    assert build.load() is default and not build.checking()
    with pytest.raises(KeyError):
        with build.checked():
            raise KeyError("inside")
    assert build.load() is default and not build.checking()
    assert sorted(libs) == ["lib-checked-csrc", "lib-default-csrc"]


def test_load_hashes_nothing_after_the_first_call(monkeypatch):
    """Every wrapper calls ``build.load()`` at every launch: after the first
    call it returns the library without building (hashing the sources)."""
    calls = []

    def fake_build(checked=False, csrc=kr.CSRC):
        calls.append(checked)
        return "lib"

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "_open", lambda path, csrc: object())
    monkeypatch.setattr(build, "_default", None)
    first = build.load()
    assert all(build.load() is first for _ in range(3)) and calls == [False]


def test_failed_checked_build_raises(monkeypatch):
    def refuse(checked=False, csrc=kr.CSRC):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(build, "build", refuse)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        with build.checked():
            pass
    assert not build.checking()


def test_file_ids_are_fnv1a_of_the_name():
    """The record names its file by ``checked.cuh``'s ``file_id`` (32-bit
    FNV-1a); the sources' names hash apart."""
    assert kr.file_id("") == 0x811C9DC5 and kr.file_id("a") == 0xE40C292C
    names = [f.name for f in kr.CSRC.glob("*.cu*")]
    assert len({kr.file_id(n) for n in names}) == len(names)
    assert "2166136261u" in (kr.CSRC / "checked.cuh").read_text()


def test_extents_follow_the_tensors():
    """A contiguous operand's extent is its own bytes; a column slice's is
    what its storage holds past its offset."""
    u = torch.zeros((2, 3, 5, 12))
    assert ops.extent_bytes(u) == u.numel() * 4
    assert ops.extent_bytes(u[..., :4]) == u.numel() * 4
    assert ops.extent_bytes(u[..., 8:]) == (u.numel() - 8) * 4
    q = torch.zeros((7, 3), dtype=torch.int16)
    assert ops.extent_bytes(q[2:]) == 5 * 3 * 2


def test_ragged_cases_dispatch_to_their_keys():
    """The ragged cases are multiples of no tile and reach the narrow
    copies, both x staging paths and both ``quant_matmul`` load paths."""
    plan = kr.launch_plan()
    cases = kr.ragged_cases()
    for d in cases:
        args, kwargs = kr.driver_inputs(d, "cpu")
        assert kr.dispatch_key(plan, d.kernel, args, kwargs) == d.key, d.name
    bank = [d.shape for d in cases if d.kernel == "bank_mxv_pop"]
    for c in plan.tiles:
        assert any(s["M"] % c.bm and s["m"] % c.bk and s["N"] % c.bn
                   for s in bank)
    assert {dict(d.key)["width"] for d in cases
            if d.kernel == "bank_mxv_pop"} == {4}
    qmm = [d for d in cases if d.kernel == "quant_matmul"]
    assert {dict(d.key)["vec"] for d in qmm} == {True, False}
    assert {d.shape["K"] % 4 == 0 for d in qmm} == {True, False}


def test_large_cases_are_the_large_shapes():
    large = kr.large_cases()
    assert len(large) == len(kr.large_shapes())
    heads = [d for d, _ in large if d.kernel == "quant_matmul"]
    assert heads and all(dict(d.key)["bits"] == 8 for d in heads)
    assert max(kr.case_bytes(d) for d, _ in large) < 40e9


# ---------------------------------------------------------------- card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the checked build's kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_checked_pass_reads_no_violation(dev):
    cases = ([(d, "driver") for d in kr.drivers()]
             + [(d, "ragged") for d in kr.ragged_cases()])
    findings, report = kr.check_bounds(dev, cases=cases)
    assert findings == [], "\n".join(f.format() for f in findings)
    assert report["cases"] == len(cases)
    assert report["violations"] == 0 and report["unequal"] == 0


@pytest.mark.gpu
def test_dropped_column_mask_is_caught_at_its_copy(dev, csrc):
    gemm = csrc / "bank_gemm.cuh"
    _edit(gemm, "const bool ok = col_ok && k0 + r + i * STEP < rows;",
          "const bool ok = k0 + r + i * STEP < rows;")
    cases = [(d, "driver") for d in kr.drivers()
             if d.kernel == "bank_mxv_pop"]
    findings, report = kr.check_bounds(dev, csrc=csrc, cases=cases)
    assert report["violations"] > 0 and findings
    lines = {(f.path, f.line) for f in findings}
    want = _line(gemm, "CK_CP_ASYNC(W, SRCP")
    assert lines == {(kr._rel(gemm), want)}, [f.format() for f in findings]
    assert all("the first: bank," in f.message for f in findings)
