"""The card smoke script's tie analysis (``chip_smoke.compare_by_ties``),
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
