"""The plain references against the port at a small size on the CPU, where
both run plain PyTorch: every number the output check compares is nought to
rounding, and the control (the reference in TF32 or bf16 in the program's
place) reads more on each."""
import pytest

CELLS = ("sru_timit.search", "xlstm_350m.search")


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell, small_run):
    res = small_run(cell, 2 ** 31 + 17)
    assert res["correct"]
    for name, c in res["checks"].items():
        assert c["value"] <= 1e-6, (name, c)


# what each control must read above the program: the configuration's next
# lower precision (float32 -> TF32; the xLSTM's bf16 operands -> fp8), and
# the others that read at all
CONTROLS = [("sru_timit.search", "tf32",
             ("grid_rel", "bank_rel", "ubank_rel", "logit_rms",
              "logit_part", "logit_med_stable")),
            ("sru_timit.search", "bf16",
             ("grid_rel", "bank_rel", "ubank_rel", "logit_rms",
              "logit_part", "logit_med_stable")),
            ("xlstm_350m.search", "fp8",
             ("bank_rel", "cal_block_rms", "block_rms", "logit_rms",
              "logit_part")),
            ("xlstm_350m.search", "tf32",
             ("bank_rel", "cal_block_rms", "block_rms"))]


@pytest.mark.parametrize("cell,control,names", CONTROLS)
def test_control_reads_more(cell, control, names, small_run):
    prog = small_run(cell, 41)["_readings"]
    ctl = small_run(cell, 41, control=control)["_readings"]
    for name in names:
        assert ctl[name] > prog[name], name


def test_reference_forwards_are_the_papers_equations():
    """The SRU reference's recurrence on one step by hand."""
    import torch

    import discovery
    mod = discovery.config_module("sru_timit")
    n = 3
    u = torch.arange(1, 1 + 3 * n, dtype=torch.float32).reshape(1, 1, 1, 3 * n) / 10
    v = torch.full((2, n), 0.5)
    b = torch.full((2, n), -0.1)
    h, r = mod._scan(u, v, b)
    uw, uf, ur = u[..., :n], u[..., n:2 * n], u[..., 2 * n:]
    f = torch.sigmoid(uf - 0.1)                  # c_{-1} = 0
    rr = torch.sigmoid(ur - 0.1)
    c = (1 - f) * uw
    assert torch.allclose(h, rr * c) and torch.allclose(r, rr)


def test_tf32_rounding():
    import torch

    import refquant as RQ
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5,
                      float("inf")])
    y = RQ.round_tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 4 * 2 ** -11, -2.5, float("inf")]


def test_a_part_median_sees_one_lane_or_stretch():
    """A gap in one lane's quarter of one sequence leaves the median row
    sound but not the widest part's median."""
    import torch

    import refquant as RQ
    gaps = torch.zeros(4, 4, 300, dtype=torch.float64)
    gaps[2, 1, 225:] = 0.5              # the last quarter, one lane
    assert float(gaps.median()) == 0.0
    assert RQ.part_median(gaps) == 0.5
    gaps[2, 1, 225:263] = 0.0           # left on under half of it
    assert RQ.part_median(gaps) == 0.0


def test_row_gaps_are_relative_to_the_reference_row():
    import torch

    import refquant as RQ
    ref = torch.tensor([[[[3.0, 4.0], [0.0, 2.0]]]])       # (1, 1, 2, 2)
    prog = ref + torch.tensor([[[[0.0, 0.5], [0.0, 0.0]]]])
    g = RQ.row_gaps(prog, ref)
    assert g.shape == (1, 1, 2)
    assert abs(float(g[0, 0, 0]) - (0.125 ** 0.5) / (12.5 ** 0.5)) < 1e-12
    assert float(g[0, 0, 1]) == 0.0


def test_reduction_gaps_are_exact():
    import numpy as np
    import torch

    import refquant as RQ
    labels = torch.tensor([[0, 1, 2], [1, 1, 1]])          # 2 subsets
    argmax = torch.tensor([[[0, 1, 2], [1, 1, 0]],         # lane 0: 0, 1
                           [[2, 2, 2], [1, 1, 1]]])        # lane 1: 2, 0
    counts = np.array([[0, 1], [2, 0]])
    errors = [100 / 3, 200 / 3]
    assert RQ.reduction_gaps([{}, {}], argmax, labels, counts, errors,
                             2) == (0.0, 0.0)
    cg, eg = RQ.reduction_gaps([{}, {}], argmax, labels, counts + [[0, 1],
                                                                   [0, 0]],
                               errors, 2)
    assert abs(cg - 100 / 3) < 1e-9 and abs(eg - 100 / 3) < 1e-9


def test_stable_median_leaves_out_rows_that_rounding_moves():
    """Rows that the float64 witness moves are left out of the median; a
    sound program's chaotic rows then cannot carry it, while a gap on the
    stable rows still does."""
    import torch

    import refquant as RQ
    gaps = torch.full((4, 4, 10), 1e-7, dtype=torch.float64)
    witness = torch.full_like(gaps, 1e-7)
    gaps[:3] = 1e-3                     # three lanes of four chaotic
    witness[:3] = 1e-4
    assert float(gaps.median()) == 1e-3
    assert RQ.stable_median(gaps, witness) == 1e-7
    gaps[3] = 1e-3                      # and a gap on the stable lane
    assert RQ.stable_median(gaps, witness) == 1e-3
    witness[3] = 1.0                    # no stable row: every row counts
    assert RQ.stable_median(gaps, witness) == 1e-3


def test_f64_precision_keeps_float64():
    import torch

    import refquant as RQ
    x = torch.tensor([[1.0 + 2 ** -40, 0.3]], dtype=torch.float64)
    w = torch.eye(2, dtype=torch.float32)
    y = RQ.Precision("f64").mm(x, w)
    assert y.dtype == torch.float64 and float(y[0, 0]) == 1.0 + 2 ** -40
    q = RQ.fake_quant(x, 2.0 ** -45, -2.0 ** 50, 2.0 ** 50, ste=False)
    assert q.dtype == torch.float64 and float(q[0, 0]) == 1.0 + 2 ** -40
