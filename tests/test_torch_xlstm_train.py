"""The port's own xLSTM training at the search config, on the CPU.

Kept apart from ``test_torch_xlstm.py`` (which holds the port to the
reference on the reference's arrays) so that the tier-1 run's
``--dist loadfile`` can put it on another worker; it uses no fixture of
that file."""
import numpy as np
import pytest
import torch

from repro_torch.core import xlstm_target as TXT


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: with six test workers on eight cores a
    multithreaded op waits on its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_small_xlstm_on_cpu():
    """The port's own training at the search config: deterministic for a
    seed, the loss falls, and the target it builds scores below 75 %
    (measured 62.5 % after 40 steps; the task's floor is 50 %)."""
    runs = []
    for _ in range(2):
        losses = []
        t = TXT.train_small_xlstm(40, batch=8, seq=17, device="cpu",
                                  log=lambda i, l: losses.append(float(l)))
        runs.append((t, losses))
    (a, la), (b, lb) = runs
    assert la == lb and a.act_ranges == b.act_ranges
    assert np.isfinite(la).all() and np.mean(la[-3:]) < np.mean(la[:3])
    assert a.supports_retrain and a.baseline_val_error < 75.0
    assert len(a.val_subsets) == 4 and a.val_subsets[0][0].shape == (2, 16)
