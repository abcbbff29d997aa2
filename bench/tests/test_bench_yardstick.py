"""The frozen work formulas against counts made by hand."""
import json

import pytest

import discovery
import yardstick as Y


def _config(name):
    return discovery.config_module(name), discovery.config_spec(name)


def test_sru_timit_macs_a_frame_are_table_4s():
    mod, spec = _config("sru_timit")
    w = mod.layer_weights(spec)
    # L0: 2 directions x 3 matrices x 550 x 23; L1-L3: 2 x 3 x 550 x 256;
    # Pr1-Pr3: 1100 x 256; FC: 1100 x 1904
    assert w["L0"] == 2 * 3 * 550 * 23 == 75_900
    assert w["L1"] == w["L2"] == w["L3"] == 2 * 3 * 550 * 256 == 844_800
    assert w["Pr1"] == w["Pr2"] == w["Pr3"] == 1100 * 256 == 281_600
    assert w["FC"] == 1100 * 1904 == 2_094_400
    assert sum(w.values()) == 5_549_500 == spec["mxv_weights_per_frame"]


def test_xlstm_350m_macs_a_token():
    mod, spec = _config("xlstm_350m")
    w = mod.layer_weights(spec)
    m = 4 * 1024 * 2048 + 2048 * 1024            # wq wk wv wz, wo
    s = 1024 * 8192 + 4 * 512 * 2048 + 2048 * 1024   # wx, r, wo
    head = 1024 * 50432                           # the padded vocabulary
    assert w["m0"] == m and w["s11"] == s and w["head"] == head
    assert sum(w.values()) == 12 * (m + s) + head == 353_632_256
    assert sum(w.values()) == spec["mxv_weights_per_token"]


def test_bank_mxv_cost_by_hand():
    c = Y.bank_mxv_cost(P=3, M=5, m=7, N=11, K=4)
    assert c.flops == 2 * 3 * 5 * 7 * 11
    assert c.read_bytes == 4 * 3 * 5 * 7 + 4 * 3 * 7 * 11 + 4 * 3
    assert c.write_bytes == 4 * 3 * 5 * 11
    # more lanes than menu rows: each of the K rows is read once
    assert Y.bank_mxv_cost(P=9, M=1, m=2, N=3, K=4).read_bytes == \
        4 * 9 * 2 + 4 * 4 * 2 * 3 + 4 * 9


def test_scan_cost_by_hand_and_floor_is_bytes_bound():
    c = Y.scan_cost(P=2, B=3, T=5, n=7)
    elems = 2 * 3 * 5 * 7
    assert c.elementwise_flops == 21 * elems
    assert c.read_bytes == 3 * 4 * elems + 4 * 4 * 7
    assert c.write_bytes == 4 * (2 * elems + 2 * 3 * 7)
    assert c.floor_s() == pytest.approx(c.hbm_bytes / Y.PEAK_HBM_BYTES)


def test_sru_dispatch_work_counts_real_lanes_only():
    mod, spec = _config("sru_timit")

    class Cell(mod.Cell):
        def __init__(self):
            self.spec = spec
            self.n_subsets, self.subset_rows = 4, 24
    work = Cell().work(10)
    frames = 4 * 24 * 300
    # the kernel lane's MxVs: everything but L0 (gathered from the u-bank)
    flops = sum(c.flops for c in work["mxv"])
    assert flops == 2 * 10 * frames * (5_549_500 - 75_900)
    assert work["model_flops"] == 2 * 10 * frames * 5_549_500
    assert len(work["scan"]) == 8


def test_peaks_are_the_data_sheets():
    assert Y.PEAK_F32_FLOPS == 67e12
    assert Y.PEAK_HBM_BYTES == 3.35e12
    assert json.dumps(Y.PEAK_BF16_FLOPS) == "989400000000000.0"


def test_roofline_share_reads_nothing_without_a_trace():
    assert Y.roofline_share({"trace": None}, "mxv", "bank_mxv_pop") is None
    ctx = {"trace": {"ops": [("other", 0, 10)]}, "eval_sizes": [1],
           "work": lambda p: {"mxv": [Y.bank_mxv_cost(p, 8, 8, 8, 4)]}}
    assert Y.roofline_share(ctx, "mxv", "bank_mxv_pop") is None


def test_roofline_share_is_the_floor_over_the_kernels_time():
    cost = Y.bank_mxv_cost(2, 1024, 1024, 1024, 4)
    dev_ns = 2 * cost.floor_s() * 1e9
    ctx = {"trace": {"ops": [("bank_mxv_pop_kernel<1>", 0, dev_ns / 2),
                             ("add", 0, 5e9),
                             ("bank_mxv_pop_kernel<2>", 0, dev_ns / 2)]},
           "eval_sizes": [2], "work": lambda p: {"mxv": [cost]}}
    assert abs(Y.roofline_share(ctx, "mxv", "bank_mxv_pop") - 50.0) < 1e-6
