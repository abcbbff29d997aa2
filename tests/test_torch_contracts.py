"""The port's contract harnesses and checker against the reference's.

``repro_torch.core.target_registry`` registers the same two targets as the
reference's; each port harness, on the reference harness's own params
(carried across with the existing converters), gives the reference's
``forward_pop`` and ``forward_decode`` within rtol 1e-4 / atol 1e-3 (the
matmul tolerance of ``tests/test_kernels.py``), and every contract holds on
both. The sabotaged forwards mirror ``tests/test_analysis.py``'s: a
requantizing banked lane trips C1, an f32 leak in the packed lane trips
C1-packed, and an output flipped along the population axis or normalised
by a cross-lane mean trips C5. The reference harnesses are built once per
module, and their forwards run jitted, as the reference's evaluator runs
them."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import batched_eval as RBE
from repro.core import target_registry as RTR
from repro_torch.core import batched_eval as TBE
from repro_torch.core import contracts as C
from repro_torch.core import target_registry as TTR
from repro_torch.models import sru as TS
from repro_torch.models import xlstm as TX

TARGETS = ("sru", "xlstm")
CONVERT = {"sru": TS.params_from_numpy, "xlstm": TX.params_from_numpy}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These runs are many small ops: one intra-op thread keeps them off
    the other test workers' cores (with six workers on eight cores a
    multithreaded small op waits on its own threads)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harnesses():
    out = {}
    for name in TARGETS:
        ref = RTR.get_contract_harness(name)
        port = TTR.get_contract_harness(name, device="cpu")
        params = CONVERT[name](jax.tree.map(np.asarray, ref.target.params),
                               "cpu")
        out[name] = (ref, port, params)
    return out


@pytest.fixture(scope="module")
def sru_harness():
    return TTR.get_contract_harness("sru", device="cpu")


def test_registry_lists_both_targets():
    assert {"sru", "xlstm"} <= set(TTR.list_contract_targets())
    assert TTR.MARKER_DIM == RTR.MARKER_DIM == 3
    fields = [f.name for f in dataclasses.fields(TTR.ContractHarness)]
    assert fields == [f.name for f in dataclasses.fields(RTR.ContractHarness)]
    with pytest.raises(KeyError):
        TTR.get_contract_harness("nope", device="cpu")


def test_registry_custom_target(sru_harness):
    TTR.register_contract_target(
        "sru_copy", lambda device: dataclasses.replace(sru_harness,
                                                       name="sru_copy"))
    try:
        assert "sru_copy" in TTR.list_contract_targets()
        findings, reports = C.run_contracts(["sru_copy"], device="cpu")
        assert findings == [] and reports[0]["target"] == "sru_copy"
    finally:
        TTR._CUSTOM.pop("sru_copy")


def _ref_qp(ref, allocs):
    return RBE.stack_qps([ref.target.qp_for(a) for a in allocs],
                         list(ref.layer_names))


def _port_qp(port, allocs):
    return torch.from_numpy(TBE.stack_qps(
        [port.target.qp_for(a) for a in allocs], list(port.layer_names)))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", TARGETS)
def test_harness_matches_reference(harnesses, name):
    ref, port, params = harnesses[name]
    assert tuple(port.layer_names) == tuple(ref.layer_names)
    assert port.marker_dim == ref.marker_dim
    assert tuple(port.feats.shape) == tuple(ref.feats.shape)
    assert np.array_equal(port.feats.numpy(), np.asarray(ref.feats))
    assert (port.forward_decode is None) == (ref.forward_decode is None)
    allocs = C._contract_allocs(ref.layer_names, ref.target.menu)
    rqp, tqp = _ref_qp(ref, allocs), _port_qp(port, allocs)
    assert np.array_equal(tqp.numpy(), rqp)
    rp = ref.target.params
    lanes = [(ref.target.make_banks(rp), port.target.make_banks(params)),
             (None, None)]
    if name == "sru":
        lanes.append((ref.target.make_packed_banks(rp),
                      port.target.make_packed_banks(params)))
    # jitted, as the reference's evaluator runs it (ROADMAP fault 7: the
    # port's xLSTM norms follow the jitted reference)
    fwd = jax.jit(ref.forward_pop)
    dec = None if ref.forward_decode is None else jax.jit(ref.forward_decode)
    for rb, tb in lanes:
        want = fwd(rp, ref.feats, rqp, rb)
        got = port.forward_pop(params, port.feats, tqp, tb)
        assert got.shape == tuple(want.shape)
        _close(got, want)
        if ref.forward_decode is not None:
            P = len(allocs)
            rf = np.broadcast_to(np.asarray(ref.feats)[1:2],
                                 (P,) + tuple(ref.feats.shape[1:]))
            want = dec(rp, rf, rqp, rb)
            got = port.forward_decode(params, torch.from_numpy(rf.copy()),
                                      tqp, tb)
            _close(got, want)


@pytest.mark.parametrize("name", TARGETS)
def test_every_contract_holds(harnesses, name):
    port = harnesses[name][1]
    findings, report = C.check_harness(port)
    assert findings == [], [f.format() for f in findings]
    verdicts = report["contracts"]
    assert verdicts["C3"] == C.C3_NOT_APPLICABLE
    for c in ("C1", "C2", "C4", "C5"):
        assert verdicts[c] == "pass"
    assert verdicts["C1-packed"] == ("pass" if name == "sru" else
                                     "not applicable: no packed banks")
    assert report["dispatches_per_generation"] == 1
    assert report["readbacks_per_generation"] == 0   # the host is the device
    assert all(v == {} for v in report["launches"].values())


def test_expected_launches_follow_the_full_models_rule(harnesses):
    """The harness counts from the rule behind the full model's (4 Bi-SRU
    layers: 8 scans, 10 f32 MxVs in the evaluator, 12 packed; 24 xLSTM
    blocks at T 64: 853 MxVs)."""
    sru, xl = harnesses["sru"][1], harnesses["xlstm"][1]
    assert C.expected_launches(sru, "f32") == {"bank_mxv_pop": 6,
                                                "sru_scan_pop": 4}
    assert C.expected_launches(sru, "evaluator") == {"bank_mxv_pop": 4,
                                                      "sru_scan_pop": 4}
    assert C.expected_launches(sru, "packed") == {"bank_qmm_pop": 6,
                                                   "sru_scan_pop": 4}
    assert C.expected_launches(xl, "f32") == {"bank_mxv_pop": 11}
    full_sru = dataclasses.replace(sru, target=dataclasses.replace(
        sru.target, cfg=TS.SRUModelConfig()))
    assert C.expected_launches(full_sru, "evaluator") == {
        "bank_mxv_pop": 10, "sru_scan_pop": 8}
    assert C.expected_launches(full_sru, "packed")["bank_qmm_pop"] == 12
    names = tuple(f"{k}{g}" for g in range(12) for k in "ms") + ("head",)
    full_xl = dataclasses.replace(xl, layer_names=names, marker_dim=64)
    assert C.expected_launches(full_xl, "f32") == {"bank_mxv_pop": 853}


def _rules(findings):
    return {f.rule for f in findings}


def test_requantizing_forward_trips_c1(sru_harness):
    h = sru_harness
    cfg = h.target.cfg

    def requantizing(params, feats, qp_stack, banks=None):
        return TS.forward_population(params, cfg, feats, qp_stack,
                                     banks=None)

    bad = dataclasses.replace(h, forward_pop=requantizing,
                              supports_requant=False)
    findings, report = C.check_harness(bad)
    assert any(f.rule == "C1" and "re-quantized" in f.message
               for f in findings)
    assert report["contracts"]["C1"] == "fail"
    assert all(f.path == h.anchor_path for f in findings)


def test_f32_leak_in_packed_lane_trips_c1_packed(sru_harness):
    h = sru_harness
    cfg = h.target.cfg
    f32_banks = h.target.make_banks(h.target.params)

    def leaky(params, feats, qp_stack, banks=None):
        if banks is not None and isinstance(banks["L0"]["fwd"]["W"], dict):
            banks = f32_banks
        return TS.forward_population(params, cfg, feats, qp_stack,
                                     banks=banks)

    findings, report = C.check_harness(dataclasses.replace(
        h, forward_pop=leaky))
    assert any(f.rule == "C1-packed" and "reads f32 bank stacks"
               in f.message for f in findings)
    assert report["contracts"]["C1-packed"] == "fail"


@pytest.mark.parametrize("mix", ["flip", "cross_lane_mean"])
def test_lane_mixing_forward_trips_c5(sru_harness, mix):
    h = sru_harness
    cfg = h.target.cfg

    def mixing(params, feats, qp_stack, banks=None):
        out = TS.forward_population(params, cfg, feats, qp_stack,
                                    banks=banks)
        if mix == "flip":
            return out.flip(0)
        return out - out.mean(dim=0, keepdim=True)

    findings, report = C.check_harness(dataclasses.replace(
        h, forward_pop=mixing, forward_decode=None))
    c5 = [f for f in findings if f.rule == "C5"]
    assert any("not lane-independent" in f.message and "moved lanes"
               in f.message for f in c5), [f.format() for f in c5]
    assert report["contracts"]["C5"] == "fail"


def test_float64_in_the_forward_trips_c2(sru_harness):
    h = sru_harness
    fwd = h.forward_pop

    def widening(params, feats, qp_stack, banks=None):
        return fwd(params, feats, qp_stack, banks).double().float()

    findings, _ = C.check_harness(dataclasses.replace(
        h, forward_pop=widening))
    assert _rules(findings) == {"C2"}


def test_command_line_prints_one_line_per_target(capsys):
    assert C.main(["--targets", "xlstm", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["target"] == "xlstm" and rep["findings"] == []
    assert C.main(["--targets", "nope", "--device", "cpu"]) == 1
    assert "C0" in capsys.readouterr().out
