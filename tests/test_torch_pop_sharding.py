"""The port's population mesh (``launch/mesh.py``,
``distributed/pop_sharding.py``) on CPU shards, in one process.

A lane's error count must be the same bits however many lanes share its
shard, so a sharded generation is held to the port's own unsharded run bit
for bit: error counts at P 5, 13 and 32 on 1, 2 and 4 shards in f32 and
packed banks, the search fronts of the paper's three platforms, the rebind
after a device loss, a beacon search, a resume across shard counts and the
xLSTM harness's target. Against the reference the port is held only where
the reference's own mesh passes on this box: its 1-device mesh.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.mesh import make_population_mesh as ref_population_mesh
from repro_torch.core import api as TA
from repro_torch.core import checkpointing as ckpt
from repro_torch.core import faults as TF
from repro_torch.core import sru_experiment as TX
from repro_torch.core import target_registry as TR
from repro_torch.core.hardware import get_platform
from repro_torch.distributed import pop_sharding as PS
from repro_torch.launch import mesh as TM
from test_torch_search import EXPERIMENTS
from test_torch_sru import CFGS, port_cfg, port_target, random_allocs, \
    reference_target


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the products are small, and six test workers
    share eight cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    ref = reference_target(CFGS["no_highway"])
    return ref, port_target(ref)


@pytest.fixture(scope="module")
def trained():
    """The port's own trained tiny SRU (``test_torch_checkpointing``'s
    fixture): it retrains beacons, which an untrained model never does."""
    return TX.train_small_sru(60, cfg=port_cfg(CFGS["no_highway"]), batch=4,
                              seq=24, device="cpu")


def cpu_mesh(n):
    return TM.make_population_mesh(n, device="cpu")


def fresh(target):
    """The same target with empty evaluator caches and its own memo."""
    return dataclasses.replace(target, shared_error_memo={})


# ------------------------------------------------------------------ unit

def test_padded_pop():
    assert PS.padded_pop(1, 4) == 4
    assert PS.padded_pop(8, 4) == 8
    assert PS.padded_pop(16, 3) == 18
    assert PS.padded_pop(5, 1) == 5
    assert PS.padded_pop(64, 4) == 64


def test_mesh_shape_and_axis():
    mesh = cpu_mesh(4)
    assert mesh.axis_names == ("pop",)
    assert mesh.shape == {"pop": 4}
    assert mesh.physical_devices == 1
    assert mesh.describe()["shards"] == 4
    assert PS.pop_axis_size(None) == 1
    assert PS.pop_axis_size(mesh) == 4
    with pytest.raises(ValueError, match="axis"):
        PS.pop_axis_size(mesh, axis="data")
    assert cpu_mesh(4) == mesh and hash(cpu_mesh(4)) == hash(mesh)


def test_mesh_on_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_population_mesh()


@pytest.mark.parametrize("mode", ["magic", "gspmd"])
def test_bad_partition_mode(mode):
    with pytest.raises(ValueError) as err:
        PS.shard_population(lambda x: x, cpu_mesh(2), n_replicated=0,
                            mode=mode)
    if mode == "gspmd":
        assert "process_group" in str(err.value)


def test_process_group_mode_needs_a_group():
    with pytest.raises(ValueError, match="process-group mesh"):
        PS.shard_population(lambda x: x, cpu_mesh(2), n_replicated=0,
                            mode="process_group")
    with pytest.raises(RuntimeError, match="process group"):
        TM.make_process_group_mesh(device="cpu")


def test_shrink_mesh():
    mesh = cpu_mesh(4)
    assert PS.shrink_mesh(mesh, 2) == cpu_mesh(2)
    for keep in (0, 4, 5):
        with pytest.raises(ValueError, match="shrink"):
            PS.shrink_mesh(mesh, keep)


def test_sharded_call_concatenates_in_lane_order():
    call = PS.shard_population(lambda w, x: x * w, cpu_mesh(4),
                               n_replicated=1)
    x = torch.arange(8.0)
    assert torch.equal(call(torch.tensor(2.0), x), 2 * x)
    assert len(call.last_launches) == 4
    with pytest.raises(ValueError, match="multiple"):
        call(torch.tensor(2.0), torch.arange(6.0))


# -------------------------------------------------- against the reference

@pytest.mark.parametrize("bank_format", ["f32", "packed"])
def test_one_device_mesh_equals_the_reference_mesh(pair, bank_format):
    """The fixture's allocations (``test_evaluator_error_counts_equal``)
    through the reference's 1-device mesh and the port's."""
    ref, port = pair
    allocs = random_allocs(port.layer_names, 11, seed=2)
    want = ref.val_error_batch(allocs, mesh=ref_population_mesh(),
                               bank_format=bank_format)
    got = port.val_error_batch(allocs, mesh=cpu_mesh(1),
                               bank_format=bank_format)
    assert got == want


# --------------------------------------------- against the port unsharded

@pytest.mark.parametrize("bank_format", ["f32", "packed"])
@pytest.mark.parametrize("p", [5, 13, 32])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_errors_bit_identical(pair, shards, p, bank_format):
    _, port = pair
    allocs = random_allocs(port.layer_names, p, seed=100 + p)
    want = port.val_error_batch(allocs, bank_format=bank_format)
    mesh = cpu_mesh(shards)
    got = port.val_error_batch(allocs, mesh=mesh, bank_format=bank_format)
    assert got == want
    ev = port.batched_evaluator(bank_format=bank_format, mesh=mesh)
    assert len(ev._sharded.last_launches) == shards


@pytest.mark.parametrize("platform", sorted(EXPERIMENTS))
def test_search_fronts_sharded(pair, platform):
    _, port = pair
    kw = dict(generations=2, pop=6, initial=12, seed=0)
    objectives = EXPERIMENTS[platform]
    want = TA.SearchSession(port, platform, objectives,
                            share_memo=False).run(**kw)
    got = TA.SearchSession(port, platform, objectives, mesh=cpu_mesh(4),
                           share_memo=False).run(**kw)
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals


def test_device_loss_rebinds_to_the_survivors(pair):
    """``LoseDevices(at=2, keep=2)`` on a 4-shard search: the generation
    re-runs on 2 shards and the front is the unsharded one."""
    _, port = pair
    kw = dict(generations=3, pop=10, initial=40, seed=0)
    want = TA.SearchSession(fresh(port), "silago").run(**kw)
    target, mesh = fresh(port), cpu_mesh(4)
    ev = target.batched_evaluator(mesh=mesh)
    ev.faults = TF.FaultInjector([TF.LoseDevices(at=2, keep=2)])
    got = TA.SearchSession(target, "silago", mesh=mesh).run(**kw)
    assert got.front_key() == want.front_key()
    assert ev.fault_log == [{"event": "device_loss", "from_shards": 4,
                             "to_shards": 2}]
    assert ev.mesh == cpu_mesh(2)
    with pytest.raises(RuntimeError, match="does not shrink"):
        ev._survive_device_loss(2)


def test_beacon_search_sharded(trained):
    """Beacon-grouped routing: every grouped call is a population sharded
    over 2 shards; the same retrains, beacons and front."""
    kw = dict(generations=4, pop=6, initial=8, seed=0, beacons=True,
              retrain_steps=3, distance_threshold=4.0)
    sram = int((sum(trained.layer_weights.values()) * 8.0
                + trained.vector_weights * 16) / 8)
    runs = [TA.SearchSession(fresh(trained), "bitfusion",
                             ("error", "speedup"), sram_override=sram,
                             mesh=mesh).run(**kw)
            for mesh in (None, cpu_mesh(2))]
    want, got = (r.beacon_search for r in runs)
    assert want.n_retrains >= 1
    assert got.n_retrains == want.n_retrains
    assert [b.alloc for b in got.beacons] == [b.alloc for b in want.beacons]
    assert runs[1].front_key() == runs[0].front_key()
    assert runs[1].n_evals == runs[0].n_evals


def test_resume_across_shard_counts(tmp_path, trained):
    """Checkpointed on 4 shards, cut back to generation 1, resumed on 2:
    the store's key leaves the mesh out, and the front is the unsharded
    run's."""
    kw = dict(generations=3, pop=6, initial=8, seed=0)

    def session(mesh):
        return TA.SearchSession(fresh(trained), "mem-only",
                                ("error", "memory"), mesh=mesh,
                                share_memo=False)
    want = session(None).run(**kw)
    d = str(tmp_path / "store")
    session(cpu_mesh(4)).run(checkpoint_dir=d, **kw)
    key = ckpt.search_key(trained, get_platform("mem-only"), 0)
    settings = {"generations": 3, "pop": 6, "initial": 8,
                "objectives": ["error", "memory"], "beacons": False,
                "retrain_steps": 0, "distance_threshold": 0.0}
    store = ckpt.SearchStore(d)
    store.discard_after(key, settings, 1)
    lines = []
    got = session(cpu_mesh(2)).run(checkpoint_dir=d, resume=True,
                                   log=lines.append, **kw)
    assert any("resumed from checkpoint" in ln for ln in lines)
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals


@pytest.mark.parametrize("p", [5, 13])
def test_xlstm_harness_target_on_two_shards(p):
    h = TR.get_contract_harness("xlstm", device="cpu")
    target = h.target
    allocs = random_allocs(target.layer_names, p, seed=7 + p)
    want = target.val_error_batch(allocs)
    got = target.val_error_batch(allocs, mesh=cpu_mesh(2))
    assert got == want
    ev = target.batched_evaluator(mesh=cpu_mesh(2))
    assert [sum(d.values()) for d in ev._sharded.last_launches] == [0, 0]
    assert np.isfinite(got).all()
