"""Tests for the port's kernel verifier (``repro_torch.analysis``), the
counterpart of ``tests/test_kernel_rules.py``.

Positive direction: the real sources pass K0, K1 and K4 on the CPU, and
the instantiations read off the sources are exactly the driver list.
Negative direction (detector liveness): copies of the sources written
under ``tmp_path`` with one seeded defect each (an extra ``case 3:`` in
``with_config``, a prototype parameter of no ctypes kind), a launch whose
grid passes 65,535 and a producer that packs the high bits first must each
give exactly one finding, at the right file and line. The ctypes
signatures and the bank tiles are read off the sources, not mirrored: an
``int`` turned to ``long long`` in a prototype, or another BN in a
``Tile<>`` line, is followed. The driven rules (K0's launches, K2, K3,
K4's identity products) need a card: those tests are marked ``gpu`` and
skip here."""
import ctypes
import re
import shutil

import pytest
import torch

from repro_torch.analysis import kernel_rules as kr
from repro_torch.kernels import ops
from repro_torch.kernels import ref


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread keeps them off the other test
    workers' cores."""
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
    return text.index(old)


def _line(path, needle):
    text = path.read_text()
    return text.count("\n", 0, text.index(needle)) + 1


# ---------------------------------------------------------------- clean

def test_real_sources_pass_the_static_rules():
    findings, report = kr.run_kernel_checks("cpu")
    assert findings == [], "\n".join(f.format() for f in findings)
    assert report["K0"] == {"instantiations": 25, "drivers": 25,
                            "findings": 0}
    assert report["K1"]["prototypes"] == 9
    assert report["K1"]["launch_plans"] > 25


def test_instantiations_equal_the_driver_list():
    insts = kr.instantiations()
    assert {(i.kernel, i.key) for i in insts} == {
        (d.kernel, d.key) for d in kr.drivers()}
    by_kernel = {}
    for i in insts:
        by_kernel[i.kernel] = by_kernel.get(i.kernel, 0) + 1
    # 3 tile configs x 3 copy widths; 3 configs; bits x rows x vector; 1
    assert by_kernel == {"bank_mxv_pop": 9, "bank_qmm_pop": 3,
                         "quant_matmul": 12, "sru_scan_pop": 1}
    assert all(p.startswith("src/repro_torch/csrc/")
               for i in insts for p, _ in i.sites)


def test_drivers_dispatch_to_their_instantiation():
    """The mirror of the wrappers' dispatch (copy width from N and the
    bank's base, rows a block from M, vector loads from N and the packed
    base) sends each driver's CPU inputs to the instantiation it names."""
    plan = kr.launch_plan()
    for d in kr.drivers():
        args, kwargs = kr.driver_inputs(d, "cpu")
        assert kr.dispatch_key(plan, d.kernel, args, kwargs) == d.key, d.name


def test_plan_reads_the_sources():
    plan = kr.launch_plan()
    assert plan.tiles == ops.BANK_CONFIGS == (
        ops.BankConfig(128, 128, 16, 16, 4, 128, 2),
        ops.BankConfig(128, 64, 16, 8, 3, 128, 3),
        ops.BankConfig(16, 64, 16, 2, 4, 64, 8))
    assert plan.qmm_bn == 256 and plan.scan_block == 256
    assert kr.qmm_rows(plan, 4) == 4 and kr.qmm_rows(plan, 5) == 8


def test_large_shapes_hold_every_head_at_the_dry_run_shapes():
    from repro_torch.configs import ARCH_IDS
    labels = [lbl for k, _, _, lbl in kr.large_shapes()
              if k == "quant_matmul"]
    for arch in ARCH_IDS:
        assert any(f"{arch} prefill_32k head" in lbl for lbl in labels)
    assert kr.check_launch_plans(kr.launch_plan(), kr.large_shapes()) == []


def test_finding_format():
    f = kr.Finding("K1", "src/repro_torch/csrc/quant_matmul.cu", 7, "m")
    assert f.format() == "src/repro_torch/csrc/quant_matmul.cu:7 K1 m"
    assert f.to_json()["rule"] == "K1"


# ------------------------------------------------------- seeded defects

def test_extra_config_case_is_undriven(csrc):
    gemm = csrc / "bank_gemm.cuh"
    _edit(gemm, "    case 2: return f(Config2{});\n",
          "    case 2: return f(Config2{});\n"
          "    case 3: return f(Config2{});\n")
    findings = kr.check_coverage(csrc)
    assert len(findings) == 1, [f.format() for f in findings]
    (f,) = findings
    assert f.rule == "K0" and f.path.endswith("csrc/bank_gemm.cuh")
    assert f.line == _line(gemm, "case 3: return")
    assert "bank_mxv_pop[config=3,width=16]" in f.message
    assert "bank_qmm_pop[config=3]" in f.message


def _proto_edit(path, name, old, new):
    """Replace ``old`` by ``new`` inside the prototype of ``name``."""
    text = path.read_text()
    start = text.index(f'extern "C" int {name}(')
    end = text.index(")", start)
    path.write_text(text[:start] + text[start:end].replace(old, new, 1)
                    + text[end:])


def test_signatures_follow_the_prototypes(csrc):
    """The ctypes are read off the prototypes: an ``int`` turned to ``long
    long`` is declared ``c_longlong``, and nothing else moves."""
    from repro_torch.kernels import build
    real = build.signatures()
    assert real["repro_sru_scan_pop"][3] is ctypes.c_longlong
    assert real["repro_quant_matmul"][5] is ctypes.c_int
    _proto_edit(csrc / "quant_matmul.cu", "repro_quant_matmul", "int K,",
                "long long K,")
    got = build.signatures(csrc)
    assert got["repro_quant_matmul"][5] is ctypes.c_longlong
    got["repro_quant_matmul"][5] = ctypes.c_int
    assert got == real
    assert kr.check_interface(csrc) == []


def test_parameter_of_no_ctypes_kind_is_one_finding(csrc):
    from repro_torch.kernels import build
    qm = csrc / "quant_matmul.cu"
    _proto_edit(qm, "repro_quant_matmul", "int K,", "size_t K,")
    assert kr.check_coverage(csrc) == []
    findings = kr.check_interface(csrc)
    assert len(findings) == 1, [f.format() for f in findings]
    (f,) = findings
    assert f.rule == "K1" and f.path.endswith("csrc/quant_matmul.cu")
    assert f.line == _line(qm, 'extern "C" int repro_quant_matmul(')
    assert "#5 'size_t K'" in f.message
    with pytest.raises(ValueError, match="repro_quant_matmul"):
        build.signatures(csrc)


def test_bank_configs_follow_the_tile_lines(csrc):
    """The bank tiles are read off ``bank_gemm.cuh``: another BN in
    ``Config1``'s ``Tile<>`` line is followed, threads and all; a gap in
    the ``ConfigN`` numbering raises."""
    gemm = csrc / "bank_gemm.cuh"
    _edit(gemm, "using Config1 = Tile<128, 64, 8, 3, 3>;",
          "using Config1 = Tile<128, 128, 8, 3, 3>;")
    got = ops.bank_configs(csrc)
    assert got[1] == ops.BankConfig(128, 128, 16, 8, 3, 256, 3)
    assert got[0] == ops.BANK_CONFIGS[0] and got[2] == ops.BANK_CONFIGS[2]
    assert kr.launch_plan(csrc).tiles == got
    _edit(gemm, "using Config2 =", "using Config3 =")
    with pytest.raises(ValueError, match="Config0, Config1"):
        ops.bank_configs(csrc)


def test_grid_past_65535_is_out_of_cuda_limits():
    """70,000 lanes of the bank GEMM: grid.z is the population."""
    plan = kr.launch_plan()
    shape = {"P": 70000, "M": 16, "m": 8, "N": 64}
    findings = kr.check_launch_plans(
        plan, [("bank_mxv_pop", {"config": 2}, shape, "")])
    assert len(findings) == 1, [f.format() for f in findings]
    (f,) = findings
    assert f.rule == "K1" and f.path.endswith("csrc/bank_gemm.cuh")
    assert f.line == _line(kr.CSRC / "bank_gemm.cuh",
                           "inline dim3 grid_for")
    assert "grid.z 70000 > 65535" in f.message
    assert kr.check_launch_plans(
        plan, [("bank_mxv_pop", {"config": 2}, {**shape, "P": 65535},
                "")]) == []


def test_high_bits_first_producer_breaks_the_round_trip():
    def high_first(q, bits):
        if bits == 8:
            return ref.pack_weights(q, bits)
        per = 8 // bits
        K, N = q.shape
        q = torch.cat([q, q.new_zeros(((-K) % per, N))])
        u = (q.to(torch.int32) & ((1 << bits) - 1)).reshape(-1, per, N)
        out = torch.zeros((u.shape[0], N), dtype=torch.int32)
        for r in range(per):
            out |= u[:, r] << (bits * (per - 1 - r))
        return out.to(torch.uint8).view(torch.int8)

    findings = kr.check_packing(pack_fn=high_first)
    assert len(findings) == 1, [f.format() for f in findings]
    (f,) = findings
    assert f.rule == "K4" and f.path.endswith("csrc/quant_matmul.cu")
    assert f.line == _line(kr.CSRC / "quant_matmul.cu", "float code_f(")
    assert re.search(r"bits=2: .*bits=4: ", f.message)
    assert kr.check_packing() == []


def test_cli_defaults_to_the_card(monkeypatch, capsys):
    """``python -m repro_torch.analysis`` asks for the card and raises
    where there is none; ``--device cpu`` runs the static rules."""
    from repro_torch.analysis import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
    assert cli.main(["--device", "cpu"]) == 0
    assert '"rule": "K1"' in capsys.readouterr().out


# ------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the driven rules launch the CUDA "
                    "kernels, which have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_every_driver_launches_once_and_agrees(dev):
    findings, rows = kr.run_drivers(dev)
    assert findings == [], "\n".join(f.format() for f in findings)
    assert len(rows) == 25 and all(r["launches"] == 1 for r in rows)


@pytest.mark.gpu
def test_indices_and_lanes_on_the_card(dev):
    findings, report = kr.check_path_indices(dev)
    assert findings == [] and report["bank_calls_checked"] > 0
    findings, report = kr.check_lanes(dev)
    assert findings == [], "\n".join(f.format() for f in findings)


@pytest.mark.gpu
def test_resources_of_every_instantiation(dev):
    findings, rows = kr.check_resources(kr.instantiations())
    assert findings == [], "\n".join(f.format() for f in findings)
    assert len(rows) == 25 and all(r["spill_bytes"] == 0 for r in rows)


@pytest.mark.gpu
def test_identity_products_give_the_banks_bitwise(dev):
    findings, report = kr.check_packing_on_card(dev)
    assert findings == [], "\n".join(f.format() for f in findings)
