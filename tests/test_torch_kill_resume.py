"""Kill-and-resume of the port's search across real process boundaries:
the choreography of ``tests/test_kill_resume.py``, driving only
``repro_torch`` on the CPU.

One child process per lifecycle stage. Each child restores the same
trained tiny Bi-SRU from a training checkpoint written once by this
module (``repro_torch.training.checkpoint``), calibrates it
(``target_from_params``) and runs the same search into a store:

  reference   the search runs to its end with checkpointing on; its final
              front is the ground truth;
  SIGKILL     a second child running the identical search dies right
              after committing generation K's checkpoint (the "power cut
              between generations" case), or in the middle of a
              checkpoint write with the tmp file on disk and the rename
              never issued (``REPRO_CKPT_CRASH_AFTER_TMP``, the torn
              write);
  resume      a third child resumes from what the dead one left behind
              and must finish with a front equal (``==``) to the
              reference's, the same evaluation count, and for the beacon
              search the same retrains and beacon digests, the retrains
              stored before the kill restored from disk rather than run
              again.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = textwrap.dedent("""
    import json, os, signal

    import torch

    from repro_torch.core import checkpointing as ckpt
    from repro_torch.core import durable_io
    from repro_torch.core import sru_experiment as X
    from repro_torch.core.api import SearchSession
    from repro_torch.models import sru
    from repro_torch.training import checkpoint as tc

    mode = os.environ["REPRO_TEST_MODE"]                 # run | resume
    beacons = os.environ.get("REPRO_TEST_BEACONS") == "1"
    store_dir = os.environ["REPRO_TEST_STORE"]
    kill_after = int(os.environ.get("REPRO_TEST_KILL_AFTER_GEN", -1))

    if kill_after >= 0:
        # commit generation ``kill_after``'s checkpoint, then die the way
        # a power cut does: no exception, no cleanup, no atexit
        real_save = ckpt.SearchStore.save
        def save_then_die(self, key, settings, state, **kw):
            path = real_save(self, key, settings, state, **kw)
            if state.next_gen == kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
            return path
        ckpt.SearchStore.save = save_then_die

    cfg = sru.SRUModelConfig(**json.loads(os.environ["REPRO_TEST_CFG"]))
    template = sru.init_params(torch.Generator().manual_seed(9), cfg,
                               device="cpu")
    params, _ = tc.restore(os.environ["REPRO_TEST_TRAINED"], template)
    trained = X.target_from_params(cfg, params, device="cpu")
    retrains = []
    real_retrainer = trained.beacon_retrainer
    def counting_retrainer(steps, **kw):
        fn = real_retrainer(steps, **kw)
        def retrain(alloc, base):
            retrains.append(alloc)
            return fn(alloc, base)
        return retrain
    trained.beacon_retrainer = counting_retrainer

    if beacons:
        sram = int((sum(trained.layer_weights.values()) * 8.0
                    + trained.vector_weights * 16) / 8)
        session = SearchSession(trained, "bitfusion", ("error", "speedup"),
                                sram_override=sram)
        kw = dict(generations=4, pop=6, initial=8, seed=0, beacons=True,
                  retrain_steps=3, distance_threshold=4.0)
    else:
        session = SearchSession(trained, "mem-only", ("error", "memory"))
        kw = dict(generations=3, pop=6, initial=8, seed=0)

    lines = []
    res = session.run(checkpoint_dir=store_dir, resume=(mode == "resume"),
                      log=lines.append, **kw)
    bs = res.beacon_search
    print("RESULT " + json.dumps({
        "front": res.front_key(),
        "n_evals": res.n_evals,
        "n_retrains": bs.n_retrains if bs else 0,
        "retrains_run": len(retrains),
        "beacon_digests": ([durable_io.tree_digest(b.params)
                            for b in bs.beacons] if bs else []),
        "resumed": any("resumed from checkpoint" in l for l in lines),
    }))
""")

BEACON_SETTINGS = {"generations": 4, "pop": 6, "initial": 8,
                   "objectives": ["error", "speedup"], "beacons": True,
                   "retrain_steps": 3, "distance_threshold": 4.0}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny Bi-SRU every child searches (60 CPU steps: enough for
    Algorithm 1 to retrain), saved once as a training checkpoint."""
    import dataclasses
    from repro_torch.core import sru_experiment as X
    from repro_torch.models import sru
    from repro_torch.training import checkpoint as tc
    cfg = sru.SRUModelConfig(name="tiny", input_dim=5, hidden=8, proj=6,
                             n_sru_layers=3, n_outputs=7)
    target = X.train_small_sru(60, cfg=cfg, batch=4, seq=24, device="cpu")
    d = str(tmp_path_factory.mktemp("trained"))
    tc.save(d, 60, target.params)
    return target, d, json.dumps(dataclasses.asdict(cfg))


def _spawn(trained, store, mode, *, beacons=False, kill_after_gen=None,
           crash_after_tmp=None, timeout=300):
    _, ckpt_dir, cfg = trained
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env["REPRO_TEST_MODE"] = mode
    env["REPRO_TEST_BEACONS"] = "1" if beacons else "0"
    env["REPRO_TEST_STORE"] = store
    env["REPRO_TEST_TRAINED"] = ckpt_dir
    env["REPRO_TEST_CFG"] = cfg
    env.pop("REPRO_CKPT_CRASH_AFTER_TMP", None)
    env.pop("REPRO_TEST_KILL_AFTER_GEN", None)
    if kill_after_gen is not None:
        env["REPRO_TEST_KILL_AFTER_GEN"] = str(kill_after_gen)
    if crash_after_tmp is not None:
        env["REPRO_CKPT_CRASH_AFTER_TMP"] = str(crash_after_tmp)
    return subprocess.run([sys.executable, "-c", DRIVER], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _assert_sigkilled(proc):
    assert proc.returncode == -signal.SIGKILL, (
        f"expected SIGKILL death, got rc={proc.returncode}\n"
        + proc.stderr[-2000:])
    assert not any(ln.startswith("RESULT ")
                   for ln in proc.stdout.splitlines())


def _files(store):
    out = []
    for dirpath, _, names in os.walk(store):
        out += [os.path.join(dirpath, n) for n in names]
    return out


def _same_run(got, want):
    assert got["front"] == want["front"]
    assert got["n_evals"] == want["n_evals"]
    assert got["n_retrains"] == want["n_retrains"]
    assert got["beacon_digests"] == want["beacon_digests"]


# ----------------------------------------------------------- plain search

@pytest.fixture(scope="module")
def plain(tmp_path_factory, trained):
    root = tmp_path_factory.mktemp("kill_resume_plain")
    ref = _result(_spawn(trained, str(root / "ref"), "run"))

    killed_dir = str(root / "killed")
    killed = _spawn(trained, killed_dir, "run", kill_after_gen=1)
    resumed = _result(_spawn(trained, killed_dir, "resume"))

    torn_dir = str(root / "torn")
    # write_checksummed calls: generation 0's save is the 1st, so the 3rd
    # dies with generation 2's tmp file on disk and generations 0-1 saved
    torn = _spawn(trained, torn_dir, "run", crash_after_tmp=3)
    torn_leftovers = [p for p in _files(torn_dir) if ".tmp-" in p]
    torn_resumed = _result(_spawn(trained, torn_dir, "resume"))
    return dict(ref=ref, killed=killed, resumed=resumed, torn=torn,
                torn_dir=torn_dir, torn_leftovers=torn_leftovers,
                torn_resumed=torn_resumed)


class TestPlainKillResume:
    def test_reference_completed(self, plain):
        assert plain["ref"]["front"] and not plain["ref"]["resumed"]

    def test_children_really_died_by_sigkill(self, plain):
        _assert_sigkilled(plain["killed"])
        _assert_sigkilled(plain["torn"])

    def test_resume_after_midsearch_kill_is_bit_identical(self, plain):
        assert plain["resumed"]["resumed"]
        _same_run(plain["resumed"], plain["ref"])

    def test_torn_write_left_tmp_then_resume_is_bit_identical(self, plain):
        assert plain["torn_leftovers"], \
            "the torn-write kill should leave a .tmp- file behind"
        assert plain["torn_resumed"]["resumed"]
        _same_run(plain["torn_resumed"], plain["ref"])
        # the resume swept the dead writer's tmp file
        assert not any(".tmp-" in p for p in _files(plain["torn_dir"]))


# ---------------------------------------------------------- beacon search

@pytest.fixture(scope="module")
def beacon(tmp_path_factory, trained):
    from repro_torch.core import checkpointing as ckpt
    from repro_torch.core.hardware import get_platform
    target = trained[0]
    root = tmp_path_factory.mktemp("kill_resume_beacon")
    ref = _result(_spawn(trained, str(root / "ref"), "run", beacons=True))

    killed_dir = str(root / "killed")
    killed = _spawn(trained, killed_dir, "run", beacons=True,
                    kill_after_gen=1)
    # what the dead process managed to persist (retrains at the cut)
    sram = int((sum(target.layer_weights.values()) * 8.0
                + target.vector_weights * 16) / 8)
    key = ckpt.search_key(target, get_platform("bitfusion"), 0,
                          sram_bytes=sram)
    mid = ckpt.SearchStore(killed_dir).load_latest(
        key, BEACON_SETTINGS, params_template=target.params)
    resumed = _result(_spawn(trained, killed_dir, "resume", beacons=True))
    return dict(ref=ref, killed=killed, mid=mid, resumed=resumed)


class TestBeaconKillResume:
    def test_reference_actually_retrains(self, beacon):
        assert beacon["ref"]["n_retrains"] >= 2
        assert beacon["ref"]["retrains_run"] == beacon["ref"]["n_retrains"]

    def test_child_died_with_retrains_on_disk(self, beacon):
        _assert_sigkilled(beacon["killed"])
        mid = beacon["mid"]
        assert mid is not None and mid.next_gen == 1
        # the kill lands between retrains, so the resumed search both
        # restores beacons and fast-forwards the retraining stream
        assert 0 < mid.n_retrains < beacon["ref"]["n_retrains"]
        assert len(mid.beacon_params) == mid.n_retrains
        assert mid.beacon_digests == \
            beacon["ref"]["beacon_digests"][:mid.n_retrains]

    def test_beacon_resume_is_bit_identical(self, beacon):
        assert beacon["resumed"]["resumed"]
        _same_run(beacon["resumed"], beacon["ref"])
        # only the retrains the store did not hold ran again
        assert beacon["resumed"]["retrains_run"] == \
            beacon["ref"]["n_retrains"] - beacon["mid"].n_retrains
