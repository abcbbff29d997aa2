"""Crash-safe checkpointing in the port (``repro_torch.core.checkpointing``,
``repro_torch.core.durable_io``, ``repro_torch.training.checkpoint``), the
cases of ``tests/test_checkpointing.py`` on the port's modules, and stores
and training checkpoints carried across the two packages:

  (a) durable_io: the checksummed round trip, every corruption mode
      raising ``CorruptFileError``, atomic writes with the tmp sweep,
      flatten/unflatten against the digest (dtype and device kept, bf16
      through its raw bytes);
  (b) the search state's round trip with beacons, the required template,
      garbage rejected, beacon params copied to the host at capture;
  (c) ``SearchStore``: save, load, discard and keep; fallback past a
      corrupt newest file; an empty store; a key mismatch raising;
      ``search_key`` identities;
  (d) ``SearchSession.run``: in-process resume parity (beacons off and
      on), ``resume`` without a directory, an empty store running fresh,
      ``checkpoint_every``; ``front_from_store``;
  (e) training checkpoints: checksummed round trip, corruption raising,
      the async checkpointer;
  (f) across packages, on ``test_torch_search``'s ``no_highway`` fixture:
      stores and training checkpoints written by either package load in
      the other, and the port resumes a store the reference began to the
      reference's own front.

The port's targets here are tiny Bi-SRUs trained on the CPU for 60 steps
(enough for Algorithm 1 to retrain beacons; 40 steps retrain none)."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import checkpointing as ckpt
from repro_torch.core import durable_io as dio
from repro_torch.core import sru_experiment as TX
from repro_torch.core.api import SearchSession
from repro_torch.core.hardware import get_platform
from repro_torch.core.nsga2 import Individual
from repro_torch.serving import convert as TC
from repro_torch.training import checkpoint as tc
from test_torch_sru import CFGS, port_cfg, port_target, reference_target

BEACON_KW = dict(generations=4, pop=6, initial=8, seed=0, beacons=True,
                 retrain_steps=3, distance_threshold=4.0)


@pytest.fixture(scope="module")
def trained():
    return TX.train_small_sru(60, cfg=port_cfg(CFGS["no_highway"]), batch=4,
                              seq=24, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The reference's calibrated ``no_highway`` target and the port's on
    the same arrays (``test_torch_search``'s fixture)."""
    ref = reference_target(CFGS["no_highway"])
    return ref, port_target(ref)


def _mem_only():
    return get_platform("mem-only")


def _sram(target):
    return int((sum(target.layer_weights.values()) * 8.0
                + target.vector_weights * 16) / 8)


def _mem_settings(generations):
    return {"generations": generations, "pop": 6, "initial": 8,
            "objectives": ["error", "memory"], "beacons": False,
            "retrain_steps": 0, "distance_threshold": 0.0}


def _equal_params(a, b):
    flat_a, flat_b = dio.flatten_tree(a), dio.flatten_tree(b)
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        assert flat_a[k].device == flat_b[k].device
        assert torch.equal(flat_a[k], flat_b[k]), k


# ------------------------------------------------------------ durable_io

def test_checksummed_round_trip(tmp_path):
    p = str(tmp_path / "blob.ckpt")
    payload = b"\x00\x01payload\xffbytes" * 100
    dio.write_checksummed(p, payload)
    assert dio.read_checksummed(p) == payload


@pytest.mark.parametrize("mangle", [
    lambda b: b[:-3],                               # truncated payload
    lambda b: b"garbage header\n" + b.split(b"\n", 1)[1],   # bad magic
    lambda b: b.replace(b"payload", b"pAyload", 1),  # flipped bits
    lambda b: b"",                                   # empty file
])
def test_checksummed_corruption_raises(tmp_path, mangle):
    p = str(tmp_path / "blob.ckpt")
    dio.write_checksummed(p, b"payload" * 50)
    with open(p, "rb") as f:
        raw = f.read()
    with open(p, "wb") as f:
        f.write(mangle(raw))
    with pytest.raises(dio.CorruptFileError):
        dio.read_checksummed(p)


def test_atomic_write_and_tmp_sweep(tmp_path):
    p = str(tmp_path / "f.json")
    dio.atomic_write_bytes(p, b"v1")
    dio.atomic_write_bytes(p, b"v2")
    assert open(p, "rb").read() == b"v2"
    # a dead writer's torn tmp file is swept, the real file untouched
    torn = str(tmp_path / "f.json.tmp-99999")
    open(torn, "wb").write(b"torn")
    assert dio.sweep_tmp_files(str(tmp_path)) == 1
    assert not os.path.exists(torn)
    assert open(p, "rb").read() == b"v2"
    assert dio.sweep_tmp_files(str(tmp_path / "missing")) == 0


def test_tree_flatten_digest_round_trip(trained):
    flat = dio.flatten_tree(trained.params)
    assert flat and all(isinstance(k, str) for k in flat)
    rebuilt = dio.unflatten_like(trained.params, {
        k: dio.leaf_array(v) for k, v in flat.items()})
    _equal_params(rebuilt, trained.params)
    assert dio.tree_digest(rebuilt) == dio.tree_digest(trained.params)
    # a numpy tree digests like the tensor tree it was copied from
    assert dio.tree_digest(dio.host_tree(trained.params)) == \
        dio.tree_digest(trained.params)
    # digests react to any leaf change
    k0 = sorted(flat)[0]
    mutated = {k: dio.leaf_array(v) for k, v in flat.items()}
    mutated[k0] = mutated[k0] + 1
    assert dio.tree_digest(dio.unflatten_like(trained.params, mutated)) \
        != dio.tree_digest(trained.params)


def test_unflatten_keeps_dtypes_and_bf16_bytes(tmp_path):
    """bf16 crosses ``np.savez`` as raw void bytes and comes back bitwise
    in the template leaf's dtype; other leaves keep their dtype."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": {"w": torch.randn((3, 4), generator=g).to(torch.bfloat16)},
            "b": [torch.arange(5, dtype=torch.int16),
                  torch.randn((2,), generator=g, dtype=torch.float64)]}
    path = str(tmp_path / "t.npz")
    np.savez(path, **{k: dio.leaf_array(v)
                      for k, v in dio.flatten_tree(tree).items()})
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    assert flat["a/w"].dtype.kind == "V"
    back = dio.unflatten_like(tree, flat)
    assert isinstance(back["b"], list)
    for got, want in zip(dio.flatten_tree(back).values(),
                         dio.flatten_tree(tree).values()):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert dio.tree_digest(back) == dio.tree_digest(tree)


# ------------------------------------------------------- (de)serialization

def _toy_state(target, with_beacons=False):
    rng = np.random.default_rng(0)
    L = len(list(target.layer_names))
    inds = [Individual(rng.integers(0, 4, 2 * L),
                       np.asarray([50.0 + i, 3.0], float), 0.0, i % 2,
                       float(i))
            for i in range(5)]
    memo = {(("l0", (4, 8)),): 42.5, (("l0", (2, 2)),): float("nan")}
    state = ckpt.SearchState(
        next_gen=3, population=inds, history=list(inds), n_cache_hits=2,
        memo=memo, memo_hits=1, n_error_evals=7,
        quarantine_log=[{"alloc": {"l0": [2, 2]}, "raw_error": None,
                         "action": "quarantined"}],
        n_quarantined=1, front_idx=[0, 2])
    if with_beacons:
        alloc = {n: (4, 8) for n in target.layer_names}
        state.beacon_allocs = [alloc]
        state.beacon_params = [target.params]
        state.beacon_digests = [dio.tree_digest(target.params)]
        state.n_retrains = 1
    return state


def _assert_states_equal(got, want):
    assert got.next_gen == want.next_gen
    assert got.n_cache_hits == want.n_cache_hits
    assert (got.memo_hits, got.n_error_evals) == \
        (want.memo_hits, want.n_error_evals)
    assert got.front_idx == want.front_idx
    assert got.n_retrains == want.n_retrains
    for mine, theirs in ((got.population, want.population),
                         (got.history, want.history)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert np.array_equal(a.genome, b.genome)
            assert np.array_equal(a.objectives, b.objectives)
            assert (a.violation, a.rank, a.crowding) == \
                (b.violation, b.rank, b.crowding)
    assert got.memo.keys() == want.memo.keys()
    for k, v in want.memo.items():
        assert got.memo[k] == v or (np.isnan(v) and np.isnan(got.memo[k]))
    assert got.beacon_allocs == want.beacon_allocs
    assert got.beacon_digests == want.beacon_digests
    assert [dio.tree_digest(p) for p in got.beacon_params] == \
        want.beacon_digests


def test_state_round_trip(trained):
    key = ckpt.search_key(trained, _mem_only(), 0)
    settings = {"generations": 4}
    st = _toy_state(trained, with_beacons=True)
    payload = ckpt.serialize_state(st, key, settings)
    back, manifest = ckpt.deserialize_state(payload,
                                            params_template=trained.params)
    assert manifest["key"] == key and manifest["settings"] == settings
    assert back.next_gen == 3 and back.n_retrains == 1
    _assert_states_equal(back, st)
    # NaN memo values survive the JSON manifest
    assert np.isnan(back.memo[(("l0", (2, 2)),)])
    # beacon params come back as tensors on the template's device
    _equal_params(back.beacon_params[0], trained.params)


def test_deserialize_requires_template_for_beacons(trained):
    st = _toy_state(trained, with_beacons=True)
    payload = ckpt.serialize_state(st, {}, {})
    with pytest.raises((ckpt.CheckpointMismatchError, dio.CorruptFileError)):
        ckpt.deserialize_state(payload, params_template=None)


def test_deserialize_rejects_garbage():
    with pytest.raises(dio.CorruptFileError):
        ckpt.deserialize_state(b"not an npz at all")


def test_capture_copies_beacons_to_the_host_once(trained):
    """Captured beacon params are numpy trees (the saver's thread reads no
    tensor), copied once per beacon and digested like the tensors."""
    from repro_torch.core.beacon import Beacon
    from repro_torch.core.mohaq import MOHAQProblem

    class Beacons:
        beacons = [Beacon({n: (4, 8) for n in trained.layer_names},
                          trained.params)]
        n_retrains = 1

    prob = MOHAQProblem(
        layer_names=list(trained.layer_names),
        layer_macs=dict(trained.layer_macs),
        layer_weights=dict(trained.layer_weights),
        vector_weights=trained.vector_weights, hardware=_mem_only(),
        error_fn=lambda a: 0.0, baseline_error=0.0)
    ga = {"next_gen": 0, "population": [], "history": [], "n_cache_hits": 0}
    cache = []
    first = ckpt.capture_state(ga, prob, Beacons, beacon_cache=cache)
    second = ckpt.capture_state(ga, prob, Beacons, beacon_cache=cache)
    leaves = dio.flatten_tree(first.beacon_params[0]).values()
    assert all(isinstance(v, np.ndarray) for v in leaves)
    assert second.beacon_params[0] is first.beacon_params[0]
    assert first.beacon_digests == [dio.tree_digest(trained.params)]


# ------------------------------------------------------------ SearchStore

def test_store_save_load_discard_keep(tmp_path, trained):
    store = ckpt.SearchStore(str(tmp_path), keep=2)
    key = ckpt.search_key(trained, _mem_only(), 0)
    settings = {"generations": 9}
    for g in (0, 1, 2, 3):
        st = _toy_state(trained)
        st.next_gen = g
        store.save(key, settings, st)
    # keep=2 pruned the oldest
    assert store.generations(key, settings) == [2, 3]
    got = store.load_latest(key, settings)
    assert got is not None and got.next_gen == 3
    assert store.discard_after(key, settings, 2) == 1
    assert store.load_latest(key, settings).next_gen == 2
    # KEY/SETTINGS sidecars record the address in the clear
    d = store.dir_for(key, settings)
    assert json.loads(open(os.path.join(
        os.path.dirname(d), "KEY.json")).read()) == key
    assert json.loads(open(os.path.join(
        d, "SETTINGS.json")).read()) == settings


def test_store_falls_back_past_corrupt_newest(tmp_path, trained):
    store = ckpt.SearchStore(str(tmp_path))
    key = ckpt.search_key(trained, _mem_only(), 0)
    settings = {}
    for g in (0, 1):
        st = _toy_state(trained)
        st.next_gen = g
        store.save(key, settings, st)
    newest = os.path.join(store.dir_for(key, settings), "gen_00001.ckpt")
    with open(newest, "r+b") as f:
        f.truncate(40)
    with pytest.warns(RuntimeWarning, match="corrupt checkpoint"):
        got = store.load_latest(key, settings)
    assert got is not None and got.next_gen == 0


def test_store_empty_returns_none(tmp_path, trained):
    store = ckpt.SearchStore(str(tmp_path))
    key = ckpt.search_key(trained, _mem_only(), 0)
    assert store.load_latest(key, {}) is None
    assert store.generations(key, {}) == []


def test_store_mismatch_raises_not_skips(tmp_path, trained):
    store = ckpt.SearchStore(str(tmp_path))
    key = ckpt.search_key(trained, _mem_only(), 0)
    settings = {"generations": 9}
    store.save(key, settings, _toy_state(trained))
    # a checkpoint copied under the hash directories of a DIFFERENT key:
    # the loader must refuse it, not silently resume from it
    other = dict(key, seed=99)
    src = store.dir_for(key, settings)
    dst = store.dir_for(other, settings)
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith(".ckpt"):
            with open(os.path.join(src, name), "rb") as f:
                data = f.read()
            with open(os.path.join(dst, name), "wb") as f:
                f.write(data)
    with pytest.raises(ckpt.CheckpointMismatchError):
        store.load_latest(other, settings)


def test_search_key_separates_identities(trained):
    hw = _mem_only()
    k1 = ckpt.search_key(trained, hw, 0)
    assert k1 == ckpt.search_key(trained, hw, 0)      # deterministic
    assert k1 != ckpt.search_key(trained, hw, 1)       # seed
    k_sram = ckpt.search_key(trained, hw, 0, sram_bytes=12345)
    assert k_sram["sram_bytes"] == 12345 and k1 != k_sram
    assert k1["sram_bytes"] is None                    # mem-only: unbounded
    other = TX.build_untrained_sru(trained.cfg, seed=5, device="cpu")
    assert ckpt.search_key(other, hw, 0) != k1         # other params


# ------------------------------------------------------ resume parity

@pytest.mark.parametrize("beacons", [False, True])
def test_resume_parity_in_process(tmp_path, trained, beacons):
    """Reference run vs checkpoint-every-generation run vs a run resumed
    from generation 1 with a cold memo: all three fronts identical by
    ``==``. With beacons, the retrains stored at generation 1 come back
    from disk and only the later ones run again."""
    if beacons:
        kw = BEACON_KW

        def session():
            return SearchSession(trained, "bitfusion", ("error", "speedup"),
                                 sram_override=_sram(trained))
        key = ckpt.search_key(trained, get_platform("bitfusion"), 0,
                              sram_bytes=_sram(trained))
        settings = {"generations": 4, "pop": 6, "initial": 8,
                    "objectives": ["error", "speedup"], "beacons": True,
                    "retrain_steps": 3, "distance_threshold": 4.0}
    else:
        kw = dict(generations=3, pop=6, initial=8, seed=0)

        def session():
            return SearchSession(trained, "mem-only", ("error", "memory"),
                                 share_memo=False)
        key = ckpt.search_key(trained, _mem_only(), 0)
        settings = _mem_settings(3)

    ref = session().run(**kw)
    d = str(tmp_path / "store")
    full = session().run(checkpoint_dir=d, **kw)
    assert full.front_key() == ref.front_key()
    assert full.n_evals == ref.n_evals
    assert full.checkpoint_stats["n_saves"] == kw["generations"] + 1

    store = ckpt.SearchStore(d)
    assert store.generations(key, settings) == list(
        range(kw["generations"] + 1))
    store.discard_after(key, settings, 1)
    mid = store.load_latest(key, settings, params_template=trained.params)

    retrains = []
    real = trained.beacon_retrainer

    def counting(steps, **skw):
        fn = real(steps, **skw)

        def retrain(alloc, base):
            retrains.append(dict(alloc))
            return fn(alloc, base)
        return retrain

    lines = []
    trained.beacon_retrainer = counting
    try:
        res = session().run(checkpoint_dir=d, resume=True, log=lines.append,
                            **kw)
    finally:
        del trained.beacon_retrainer
    assert any("resumed from checkpoint" in ln for ln in lines)
    assert res.front_key() == ref.front_key()
    assert res.n_evals == ref.n_evals
    # the resumed run re-writes the tail it replayed
    assert store.generations(key, settings) == list(
        range(kw["generations"] + 1))
    if beacons:
        rb, gb = ref.beacon_search, res.beacon_search
        assert 0 < mid.n_retrains < rb.n_retrains
        assert gb.n_retrains == rb.n_retrains
        assert len(retrains) == rb.n_retrains - mid.n_retrains
        assert [b.alloc for b in gb.beacons] == [b.alloc for b in rb.beacons]
        assert [dio.tree_digest(b.params) for b in gb.beacons] == \
            [dio.tree_digest(b.params) for b in rb.beacons]


def test_resume_without_dir_raises(trained):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        SearchSession(trained, "mem-only", ("error", "memory")).run(
            generations=1, resume=True)


def test_resume_with_empty_store_runs_fresh(tmp_path, trained):
    kw = dict(generations=2, pop=6, initial=8, seed=0)
    ref = SearchSession(trained, "mem-only", ("error", "memory"),
                        share_memo=False).run(**kw)
    res = SearchSession(trained, "mem-only", ("error", "memory"),
                        share_memo=False).run(
        checkpoint_dir=str(tmp_path / "empty"), resume=True, **kw)
    assert res.front_key() == ref.front_key()


def test_checkpoint_every_thins_saves(tmp_path, trained):
    d = str(tmp_path / "store")
    res = SearchSession(trained, "mem-only", ("error", "memory"),
                        share_memo=False).run(
        generations=4, pop=6, initial=8, seed=0,
        checkpoint_dir=d, checkpoint_every=2)
    key = ckpt.search_key(trained, _mem_only(), 0)
    # every 2nd generation plus the final one
    assert ckpt.SearchStore(d).generations(key, _mem_settings(4)) == \
        [0, 2, 4]
    assert res.checkpoint_stats["n_saves"] == 3


def test_front_from_store_is_the_run_front(tmp_path, trained):
    d = str(tmp_path / "store")
    res = SearchSession(trained, "bitfusion", ("error", "speedup"),
                        sram_override=_sram(trained)).run(
        checkpoint_dir=d, **BEACON_KW)
    allocs, rows = TC.front_from_store(d, trained)
    want = res.rows()
    assert sorted(map(_alloc_key, allocs)) == \
        sorted({_alloc_key(r["alloc"]) for r in want})
    assert [r["error"] for r in rows] == sorted(r["error"] for r in rows)
    assert all(r["speedup"] > 0 for r in rows)
    other = TX.build_untrained_sru(trained.cfg, seed=5, device="cpu")
    with pytest.raises(FileNotFoundError, match="fingerprint"):
        TC.front_from_store(d, other)


def _alloc_key(alloc):
    return tuple(sorted((n, tuple(v)) for n, v in alloc.items()))


# ------------------------------------------- training checkpoint durability

def test_training_checkpoint_checksum_round_trip(tmp_path, trained):
    d = str(tmp_path / "train")
    tc.save(d, 7, trained.params)
    manifest = json.load(open(os.path.join(d, "step_00000007",
                                           "manifest.json")))
    assert "checksums" in manifest and "arrays.npz" in manifest["checksums"]
    template = TX.build_untrained_sru(trained.cfg, seed=9,
                                      device="cpu").params
    restored, step = tc.restore(d, template)
    assert step == 7 and tc.latest_step(d) == 7
    _equal_params(restored, trained.params)
    assert dio.tree_digest(restored) == dio.tree_digest(trained.params)


def test_training_checkpoint_corruption_raises(tmp_path, trained):
    d = str(tmp_path / "train")
    tc.save(d, 1, trained.params)
    arrays = os.path.join(d, "step_00000001", "arrays.npz")
    with open(arrays, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(dio.CorruptFileError):
        tc.restore(d, trained.params)


def test_training_checkpoint_async_keeps_newest(tmp_path, trained):
    d = str(tmp_path / "train")
    saver = tc.AsyncCheckpointer(d, keep=2)
    for step in (1, 2, 3):
        saver.save(step, trained.params, extra={"loss": float(step)})
        saver.wait()
    assert saver.saved_steps == [1, 2, 3]
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    restored, step = tc.restore(d, trained.params)
    assert step == 3
    assert dio.tree_digest(restored) == dio.tree_digest(trained.params)


# --------------------------------------------------------- across packages

def _ref_state(ref):
    """A search state written by the reference, with a beacon."""
    from repro.core import checkpointing as RC
    from repro.core.nsga2 import Individual as RI
    rng = np.random.default_rng(1)
    L = len(list(ref.layer_names))
    inds = [RI(rng.integers(1, 5, 2 * L), np.asarray([40.0 + i, 2.0]), 0.0,
               i % 2, float(i)) for i in range(4)]
    alloc = {n: (4, 8) for n in ref.layer_names}
    from repro.core import durable_io as RD
    return RC.SearchState(
        next_gen=2, population=inds, history=list(inds), n_cache_hits=1,
        memo={tuple((n, (4, 8)) for n in ref.layer_names): 37.5},
        memo_hits=3, n_error_evals=5, front_idx=[0, 2],
        beacon_allocs=[alloc], beacon_params=[ref.params],
        beacon_digests=[RD.tree_digest(ref.params)], n_retrains=1)


def test_reference_store_and_training_checkpoint_load_in_port(tmp_path,
                                                              pair):
    from repro.core import checkpointing as RC
    from repro.core.hardware import get_platform as ref_platform
    from repro.training import checkpoint as rtc
    ref, port = pair
    key = RC.search_key(ref, ref_platform("mem-only"), 0)
    assert ckpt.search_key(port, _mem_only(), 0) == key
    settings = _mem_settings(4)
    want = _ref_state(ref)
    RC.SearchStore(str(tmp_path / "store")).save(key, settings, want)
    got = ckpt.SearchStore(str(tmp_path / "store")).load_latest(
        key, settings, params_template=port.params)
    _assert_states_equal(got, want)
    _equal_params(got.beacon_params[0], port.params)

    rtc.save(str(tmp_path / "train"), 5, ref.params)
    restored, step = tc.restore(str(tmp_path / "train"), port.params)
    assert step == 5
    _equal_params(restored, port.params)


def test_port_store_and_training_checkpoint_load_in_reference(tmp_path,
                                                              pair):
    from repro.core import checkpointing as RC
    from repro.core import durable_io as RD
    from repro.core.hardware import get_platform as ref_platform
    from repro.training import checkpoint as rtc
    ref, port = pair
    key = ckpt.search_key(port, _mem_only(), 0)
    settings = _mem_settings(4)
    want = _toy_state(port, with_beacons=True)
    ckpt.SearchStore(str(tmp_path / "store")).save(key, settings, want)
    got = RC.SearchStore(str(tmp_path / "store")).load_latest(
        RC.search_key(ref, ref_platform("mem-only"), 0), settings,
        params_template=ref.params)
    _assert_states_equal(got, want)
    assert RD.tree_digest(got.beacon_params[0]) == \
        RD.tree_digest(ref.params)

    tc.save(str(tmp_path / "train"), 6, port.params)
    restored, step = rtc.restore(str(tmp_path / "train"), ref.params)
    assert step == 6
    assert RD.tree_digest(restored) == RD.tree_digest(ref.params)


def test_port_resumes_a_reference_store(tmp_path, pair):
    """The reference searches mem-only with a checkpoint; its store is cut
    back to generation 1, and the port resumes it to 2 generations: the
    reference's uninterrupted front and evaluation count."""
    from repro.core import api as RA
    from repro.core import checkpointing as RC
    ref, port = pair
    d = str(tmp_path / "store")
    kw = dict(generations=2, pop=6, initial=8, seed=0)
    want = RA.SearchSession(ref, "mem-only", ("error", "memory"),
                            share_memo=False).run(checkpoint_dir=d, **kw)
    key = ckpt.search_key(port, _mem_only(), 0)
    settings = _mem_settings(2)
    assert RC.SearchStore(d).discard_after(key, settings, 1) == 1
    lines = []
    got = SearchSession(port, "mem-only", ("error", "memory"),
                        share_memo=False).run(
        checkpoint_dir=d, resume=True, log=lines.append, **kw)
    assert any("resumed from checkpoint: 1 generation" in ln for ln in lines)
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals
    # and the reference's own reader takes the port's final generation
    from tools.convert_checkpoint import front_from_store
    assert front_from_store(d, ref) == TC.front_from_store(d, port)
