"""The population mesh's ``"process_group"`` mode on the CPU: two gloo
ranks spawned with ``torch.multiprocessing.spawn`` (a ``file://`` store
under ``tmp_path``, so concurrent test workers never share a port), each
running the same host program from the same seed on its half of every
generation. Their counts (P 5, 13 and 32; f32 and packed banks) and
silago front must equal the port's in-process
unsharded run, and a device loss 2 -> 1 must leave rank 1 out and rank 0
on the unsharded front. The ranks get the fixture's arrays as numpy arrays
through a file (``_torch_pop_ranks.py``)."""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_pop_ranks import rank_main
from repro_torch.core import api as TA
from repro_torch.models import sru as TM
from test_torch_sru import CFGS, port_target, random_allocs, \
    reference_target

SEARCH_KW = dict(generations=3, pop=6, initial=12, seed=0)


@pytest.fixture(scope="module")
def port():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield port_target(reference_target(CFGS["no_highway"]))
    torch.set_num_threads(n)


def _arrays(target, populations):
    def sets(pairs):
        return [(f.numpy(), l.numpy()) for f, l in pairs]
    return {"cfg": dataclasses.asdict(target.cfg),
            "params": TM.params_to_numpy(target.params),
            "val": sets(target.val_subsets),
            "test": sets(target.test_batches),
            "act_ranges": target.act_ranges, "wclips": target.wclips,
            "wranges": target.wranges, "populations": populations,
            "search_kw": SEARCH_KW}


def _json(x):
    return json.loads(json.dumps(x))


def test_two_gloo_ranks_equal_the_unsharded_run(port, tmp_path):
    populations = [random_allocs(port.layer_names, p, seed=200 + p)
                   for p in (5, 13, 32)]
    with open(tmp_path / "arrays.pkl", "wb") as f:
        pickle.dump(_arrays(port, populations), f)
    mp.spawn(rank_main, args=(2, str(tmp_path / "store"), str(tmp_path)),
             nprocs=2, join=True)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]

    want_errors = [port.val_error_batch(a, bank_format=fmt)
                   for fmt in ("f32", "packed") for a in populations]
    want_front = _json(TA.SearchSession(
        dataclasses.replace(port, shared_error_memo={}), "silago",
        share_memo=False).run(**SEARCH_KW).front_key())
    for r, got in enumerate(ranks):
        assert got["shards"] == 2 and got["physical_devices"] == 1
        assert got["errors"] == want_errors, r
        assert got["front"] == want_front, r
        assert got["fault_log"] == [{"event": "device_loss",
                                     "from_shards": 2, "to_shards": 1}]
    assert ranks[0]["loss_front"] == want_front
    assert ranks[1]["loss_front"] == "left"
    assert np.isfinite(want_errors[0]).all()
    assert not os.path.exists(tmp_path / "rank2.json")
