"""The benchmark's tests: its modules and the port on the path, and the
small sizes at which a whole run fits a CPU test."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "sru_timit.search": dict(hidden=16, proj=8, n_outputs=12, input_dim=5,
                             utterances_per_subset=4, frames=8),
    "xlstm_350m.search": dict(n_layers=4, d_model=16, n_heads=2,
                              vocab_size=40, tokens=6,
                              sequences_per_subset=2),
}


@pytest.fixture
def small_run():
    """``small_run(cell, seed, **kw)``: one run of the cell on the CPU at
    the small size (the plain lanes stand in for the kernels there)."""
    import harness

    def run(cell, seed, seconds=0.5, trace=False, **kw):
        if "spec_override" not in kw:
            kw["spec_override"] = SMALL[cell]
        kw.setdefault("log", lambda s: None)
        return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                                **kw)
    return run
