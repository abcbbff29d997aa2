"""The card smoke script's tie analysis (``chip_smoke.compare_by_ties``)
and its xLSTM lane comparison (``compare_xlstm_lanes``),
on the CPU at a small width: two summation orders of the scalar
``forward(qp=)`` may differ only where a rounding tie before an activation
grid falls the other way, and a real error of the MxV is refused."""
import numpy as np
import pytest
import torch

import chip_smoke as C
from repro_torch.core import sru_experiment as X
from repro_torch.models import sru

CFG = sru.SRUModelConfig(input_dim=23, hidden=64, proj=32, n_sru_layers=3,
                         n_outputs=64)


@pytest.fixture(scope="module")
def traced():
    target = X.build_untrained_sru(CFG, seed=0, device="cpu")
    qp = target.qp_for({n: (8, 8) for n in target.layer_names})
    rng = np.random.default_rng(0)
    chunks = [torch.from_numpy(rng.normal(size=(1, 16, 23))
                               .astype(np.float32)) for _ in range(200)]

    def run(mxv=None, n=len(chunks)):
        runs, old = [], sru._mxv
        if mxv is not None:
            sru._mxv = mxv
        try:
            with C.recording_act_quant(runs):
                for feats in chunks[:n]:
                    runs.append({"acts": []})
                    runs[-1]["logits"] = sru.forward(target.params, CFG,
                                                     feats, qp=qp)
        finally:
            sru._mxv = old
        return runs
    return run, run()


def test_act_names_follow_the_forward(traced):
    _, runs = traced
    assert C.act_names(CFG) == ["L0", "Pr1", "L1", "Pr2", "L2", "FC"]
    assert all(len(r["acts"]) == len(C.act_names(CFG)) for r in runs)


def test_other_summation_order_differs_only_at_ties(traced):
    run, base = traced
    st = C.compare_by_ties(base, base, C.act_names(CFG))
    assert st["lanes_bitwise"] == st["lanes"] == 200
    st = C.compare_by_ties(
        base, run(lambda x, w: (x.double() @ w.double()).float()),
        C.act_names(CFG))
    assert st["lanes_tie"] >= 1 and st["logits_out_of_tol"] > 0
    assert st["max_input_gap_steps"] <= 1e-3


def test_a_wrong_mxv_is_refused(traced):
    run, base = traced
    with pytest.raises(AssertionError):
        C.compare_by_ties(base[:20], run(lambda x, w: (x @ w) * 1.003, 20),
                          C.act_names(CFG))


# --------------------------------------------- the xLSTM lane comparison

@pytest.fixture(autouse=True)
def no_card_sync(monkeypatch):
    """The comparison synchronises with the card and frees its cache;
    nothing to wait for or free on the CPU."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def _counted(fn):
    """A stand-in for a kernel wrapper, with the wrapper's launch count."""
    fn.launches = 0
    return fn


@pytest.fixture(scope="module")
def xlstm_target():
    from repro_torch.core import xlstm_target as XT
    from repro_torch.models import xlstm
    cfg = XT.search_config()
    target = XT.target_from_params(cfg, xlstm.init_lm(0, cfg, "cpu"),
                                   device="cpu", val_batch=4, val_seq=16)
    rng = np.random.default_rng(1)
    allocs = [{n: (int(rng.choice((2, 4, 8, 16))),
                   int(rng.choice((2, 4, 8, 16))))
               for n in target.layer_names} for _ in range(10)]
    return target, allocs


def test_xlstm_lanes_agree_where_the_products_agree(xlstm_target):
    """On the CPU the kernel wrapper runs its plain version: every lane's
    block inputs stay bitwise equal, every leaf's MxV on the path's inputs
    has zero error, and the lane flip moves no other lane."""
    target, allocs = xlstm_target
    st = C.compare_xlstm_lanes(target, allocs)
    assert st["lanes"] == st["lanes_inputs_equal"] == 10
    assert st["argmax_agreement"] == 1.0
    assert st["lanes_with_error_change"] == 0
    assert set(st["path_mxv_max_abs_err"].values()) == {0.0}
    assert len(st["error_pct"]["float64"]) == 10      # the witness lane
    assert set(st["float64_vs_plain"]) == {
        "argmax_agreement", "lanes_with_error_change", "max_abs_error_pp"}
    assert len(st["path_mxv_max_abs_err"]) == 17    # every leaf of 5 layers
    assert st["lane_flip"] == {"lane0_moved": True,
                               "others_bitwise_equal": True}


def test_xlstm_lanes_other_summation_order(xlstm_target, monkeypatch):
    """Products summed in float64 on the kernel lane: a lane may part from
    the plain lane only after its first block, and no check fails."""
    target, allocs = xlstm_target
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "bank_mxv_pop", _counted(
        lambda x, bank, idx: torch.bmm(
            x.double(), bank.index_select(0, idx.long()).double()).float()))
    st = C.compare_xlstm_lanes(target, allocs)
    assert "m0" not in st["first_divergence_layers"]
    assert st["lanes"] == 10


def test_xlstm_wrong_mxv_is_refused(xlstm_target, monkeypatch):
    target, allocs = xlstm_target
    from repro_torch.kernels import ops, ref
    monkeypatch.setattr(ops, "bank_mxv_pop", _counted(
        lambda x, bank, idx: ref.bank_mxv_pop_ref(x, bank, idx) * 1.01))
    with pytest.raises(AssertionError):
        C.compare_xlstm_lanes(target, allocs)


def test_xlstm_checked_mxvs_keep_the_wrapper_count(xlstm_target,
                                                    monkeypatch):
    """The kernel wrapper counts through its module-level name, as on the
    card: the comparison's checking stand-in carries that count while it
    stands in and adds none back, so only the lane-flip forward (one
    launch per MxV: 5 a mLSTM block, 2 plus one per step an sLSTM block, 1
    for the head) counts."""
    from repro_torch.kernels import ops, ref
    target, allocs = xlstm_target

    def counted(x, bank, idx):
        ops.bank_mxv_pop.launches += 1
        return ref.bank_mxv_pop_ref(x, bank, idx)

    counted.launches = 5
    monkeypatch.setattr(ops, "bank_mxv_pop", counted)
    st = C.compare_xlstm_lanes(target, allocs)
    T, G = target.val_subsets[0][0].shape[1], target.cfg.n_layers // 2
    assert ops.bank_mxv_pop is counted
    assert counted.launches == 5 + G * (7 + T) + 1
    assert len(st["path_mxv_max_abs_err"]) == G * 8 + 1
