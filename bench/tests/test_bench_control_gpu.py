"""On the card, at a size a test run holds: the program passes the output
check and the control (the reference in the configuration's next lower
precision, in the program's place) fails it. The cell's own size is read by
``bench/readings.py --control``.

    python -m pytest -m gpu bench/tests/test_bench_control_gpu.py
"""
import pytest

pytestmark = pytest.mark.gpu

SIZES = {"sru_timit.search": dict(utterances_per_subset=4),
         "xlstm_350m.search": dict(n_layers=4, sequences_per_subset=2)}
CONTROL = {"sru_timit.search": "tf32", "xlstm_350m.search": "fp8"}


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return "cuda"


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("seed", (2 ** 31 + 5, 77, 123456))
def test_program_passes_and_control_fails(cell, seed, card):
    import harness
    prog = harness.run_cell(cell, seed, 1.0, False, device=card,
                            spec_override=SIZES[cell], log=lambda s: None)
    assert prog["correct"] is True, prog["checks"]
    ctl = harness.run_cell(cell, seed, 1.0, False, device=card,
                           control=CONTROL[cell], spec_override=SIZES[cell],
                           log=lambda s: None)
    assert ctl["correct"] is False, ctl["checks"]
