"""The port's serving tier against the reference's: the packed deployment
artifact in both directions (the port reads what the reference's
``tools/convert_checkpoint.py`` wrote, and the reference reads what the
port's ``serving/convert.py`` wrote), seeded routing, and the continuous
batcher over the packed banks.

The model is the reference's small calibrated target of
``test_torch_sru.reference_target`` carried across with
``params_from_numpy``. On the CPU the served step and the scalar
``forward(qp=)`` both run the plain PyTorch lanes, so a served chunk equals
the scalar forward on it bitwise; against the reference's served logits
the argmax agrees apart from exact ties (ROADMAP.md queue 3, fault 1)."""
import numpy as np
import pytest
import torch

from repro import serving as RS
from repro.core import durable_io as RD
from repro_torch import serving as TS
from repro_torch.core import durable_io as TD
from repro_torch.models import sru as TM
from test_torch_sru import CFGS, port_target, reference_target
from tools import convert_checkpoint as CC

CHUNK = 8
SLOS = ("premium", "standard", "economy")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ref = reference_target(CFGS["no_highway"])
    port = port_target(ref)
    names = list(ref.layer_names)
    allocs = [{n: (b, 8) for n in names} for b in (2, 4, 8, 16)]
    objs = [{"error": 9.0, "speedup": 30.0}, {"error": 5.0, "speedup": 9.0},
            {"error": 2.0, "speedup": 3.0}, {"error": 1.0, "speedup": 1.0}]
    ref_dir = str(tmp_path_factory.mktemp("ref_art"))
    port_dir = str(tmp_path_factory.mktemp("port_art"))
    ref_manifest = CC.pack_deployment(ref, allocs, ref_dir, objectives=objs)
    port_manifest = TS.pack_deployment(port, allocs, port_dir,
                                       objectives=objs)
    return dict(ref=ref, port=port, allocs=allocs, ref_dir=ref_dir,
                port_dir=port_dir, ref_manifest=ref_manifest,
                port_manifest=port_manifest,
                art=TS.DeploymentArtifact.load(ref_dir))


def _requests(mod, dim, sizes, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, slo=SLOS[i % 3],
                        feats=rng.normal(size=(n, dim)).astype(np.float32))
            for i, n in enumerate(sizes)]


def _serve(mod, engine, art, sizes, seed, batcher="ContinuousBatcher",
           max_lanes=4):
    bat = getattr(mod, batcher)(engine, mod.Router(art), max_lanes=max_lanes,
                                chunk=CHUNK, collect=True)
    for r in _requests(mod, art.cfg.input_dim, sizes, seed):
        bat.submit(r)
    return bat, bat.run_until_idle()


def _scalar_chunked(port, alloc, feats):
    """The parity oracle: the port's scalar ``forward(qp=)`` per chunk,
    with fresh state per chunk."""
    qp = port.qp_for(alloc)
    return np.concatenate([
        TM.forward(port.params, port.cfg,
                   torch.from_numpy(feats[s:s + CHUNK])[None], qp=qp)[0]
        .numpy() for s in range(0, feats.shape[0], CHUNK)])


def _equal_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_tree(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


# ----------------------------------------------------------------- artifact

def test_port_reads_the_reference_artifact(setup):
    art = setup["art"]
    manifest, banks, extras = RS.load_deployment(setup["ref_dir"])
    assert TD.tree_digest({"banks": art.banks, "extras": art.extras}) == \
        manifest["tree_digest"] == RD.tree_digest({"banks": banks,
                                                   "extras": extras})
    _equal_tree(art.banks, banks)
    assert np.array_equal(art.qp, RS.qp_stack(manifest))
    ref_art = RS.DeploymentArtifact.load(setup["ref_dir"])
    assert art.allocs == ref_art.allocs and art.n_allocs == 4
    assert art.objectives == ref_art.objectives


def test_reference_reads_the_port_artifact(setup):
    manifest, banks, extras = RS.load_deployment(setup["port_dir"])
    ref_manifest, ref_banks, ref_extras = RS.load_deployment(setup["ref_dir"])
    _equal_tree(banks, ref_banks)
    _equal_tree(extras, ref_extras)
    assert manifest == ref_manifest
    assert setup["port_manifest"]["tree_digest"] == \
        setup["ref_manifest"]["tree_digest"]


def test_tree_digest_over_tensors_equals_the_reference(setup):
    """The digest of the port's own packed banks (tensors) equals the
    reference's digest of its banks (JAX arrays)."""
    banks = setup["port"].make_packed_banks(setup["port"].params)
    ref_banks = setup["ref"].make_packed_banks(setup["ref"].params)
    assert TD.tree_digest(banks) == RD.tree_digest(ref_banks)
    nested = {"a": [torch.zeros(2, dtype=torch.bfloat16), None],
              "b": (np.int32(3),)}
    import jax.numpy as jnp
    assert TD.tree_digest(nested) == RD.tree_digest(
        {"a": [jnp.zeros(2, jnp.bfloat16), None], "b": (np.int32(3),)})


def test_corrupt_payload_raises(setup, tmp_path):
    import shutil
    d = tmp_path / "art"
    shutil.copytree(setup["port_dir"], d)
    blob = (d / "packed_banks.bin").read_bytes()
    (d / "packed_banks.bin").write_bytes(blob[:-3] + b"xyz")
    with pytest.raises(TD.CorruptFileError, match="sha256"):
        TS.DeploymentArtifact.load(str(d))


# ------------------------------------------------------------------- router

@pytest.mark.parametrize("spread", [False, True])
def test_seeded_routing_equals_the_reference(setup, spread):
    art = setup["art"]
    ref_art = RS.DeploymentArtifact.load(setup["ref_dir"])
    port_r = TS.Router(art, seed=5, spread=spread, max_queue=6, shed_depth=3)
    ref_r = RS.Router(ref_art, seed=5, spread=spread, max_queue=6,
                      shed_depth=3)
    got, want = [], []
    for i in range(48):
        slo, depth = SLOS[i % 3], i % 8
        got.append(port_r.route(slo, queue_depth=depth))
        want.append(ref_r.route(slo, queue_depth=depth))
    assert [(d.alloc, d.shed, d.degraded, d.fallback) for d in got] == \
        [(d.alloc, d.shed, d.degraded, d.fallback) for d in want]


# ------------------------------------------------------------------ batcher

@pytest.fixture(scope="module")
def engine(setup):
    return TS.ServingEngine(setup["art"], device="cpu")


def test_served_logits_equal_the_scalar_forward_bitwise(setup, engine):
    """Ragged lane counts (pad lanes) and ragged tails (11 = 8 + 3,
    5 = one short chunk): every served chunk equals the scalar forward."""
    art, port = setup["art"], setup["port"]
    bat, log = _serve(TS, engine, art, [8, 11, 16, 5, 13], seed=1)
    assert len(log.completed()) == 5
    for rid, out in bat.results.items():
        rec = log.requests[rid]
        feats = _requests(TS, art.cfg.input_dim, [8, 11, 16, 5, 13],
                          1)[rid].feats
        want = _scalar_chunked(port, art.allocs[rec.alloc], feats)
        assert out.dtype == np.float32 and out.shape == want.shape
        assert np.array_equal(out, want), rid


def test_served_argmax_equals_the_reference_server(setup, engine):
    """The reference's own server on the same artifact and traffic: argmax
    equal on every frame but exact reference ties; logits within the
    matmul tolerance."""
    sizes = [16, 11, 24, 8, 19, 16]
    bat, _ = _serve(TS, engine, setup["art"], sizes, seed=2)
    ref_art = RS.DeploymentArtifact.load(setup["ref_dir"])
    ref_bat, _ = _serve(RS, RS.ServingEngine(ref_art), ref_art, sizes,
                        seed=2)
    frames = 0
    for rid, want in ref_bat.results.items():
        got = bat.results[rid]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        for t in np.flatnonzero(got.argmax(-1) != want.argmax(-1)):
            top = np.sort(want[t])[::-1]
            assert top[0] - top[1] <= 1e-6, (rid, t, top[:2])
        frames += want.shape[0]
    assert frames == sum(sizes)


def test_serial_baseline_same_logits_more_dispatches(setup, engine):
    art = setup["art"]
    cont, lc = _serve(TS, engine, art, [16] * 6, seed=3, max_lanes=8)
    ser, ls = _serve(TS, engine, art, [16] * 6, seed=3, max_lanes=8,
                     batcher="SerialGroupBatcher")
    for rid in cont.results:
        assert np.array_equal(cont.results[rid], ser.results[rid])
    nd_c = sum(s.n_dispatches for s in lc.steps)
    nd_s = sum(s.n_dispatches for s in ls.steps)
    assert nd_s == 3 * nd_c                     # 3 SLO classes, 3 allocations
    assert all(s.n_dispatches == 1 for s in lc.steps)
    s = lc.summary()
    assert s["n_completed"] == 6 and s["tokens"] == 96


def test_flipping_one_lane_moves_no_other_lane(setup, engine):
    """Lane independence of the served step: another allocation in lane 2
    changes lane 2's logits and no other lane's, bit for bit."""
    art = setup["art"]
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(5, CHUNK, art.cfg.input_dim)).astype(np.float32)
    lanes = [0, 1, 2, 3, 0]
    base = engine.step(feats, art.qp_rows(lanes))
    flipped = engine.step(feats, art.qp_rows([0, 1, 3, 3, 0]))
    assert not np.array_equal(base[2], flipped[2])
    for lane in (0, 1, 3, 4):
        assert np.array_equal(base[lane], flipped[lane]), lane


def test_decode_step_rejects_batched_feats(setup, engine):
    art = setup["art"]
    with pytest.raises(ValueError, match=r"\(P, T, m\)"):
        TM.forward_decode_step(
            engine.params, art.cfg,
            torch.zeros((2, 1, 8, art.cfg.input_dim)),
            torch.from_numpy(art.qp[:2]), banks=None)
