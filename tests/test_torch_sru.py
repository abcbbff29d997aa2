"""The port's SRU model against the reference's, on the reference's own
arrays: a reference ``TrainedSRU`` built without training (random params
from ``PRNGKey(0)``, ``speech_eval_sets(batch=2, seq=12)``, calibration,
MMSE clips, weight ranges) is carried across with ``params_from_numpy``.

Two tiny configurations between them reach every gate: ``no_highway``
(input, projection and hidden widths all differ: the L0 u-bank is live)
and ``highway`` (``input_dim == proj == hidden``: the highway skip at every
layer, the u-bank gated off). Tolerances are the reference's: rtol 1e-4 /
atol 1e-3 for logits, bitwise for banks and grids."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_eval as RB
from repro.core import sru_experiment as RX
from repro.data import synthetic as RS
from repro.models import sru as RM
from repro_torch.core import batched_eval as TB
from repro_torch.core import sru_experiment as TX
from repro_torch.data import synthetic as TS
from repro_torch.models import sru as TM

CFGS = {
    "no_highway": RM.SRUModelConfig(name="tiny", input_dim=5, hidden=8,
                                    proj=6, n_sru_layers=3, n_outputs=7),
    "highway": RM.SRUModelConfig(name="tiny_hw", input_dim=8, hidden=8,
                                 proj=8, n_sru_layers=2, n_outputs=7),
}
MENU = (2, 4, 8, 16)
# the reference's forwards, compiled once per shape (eager JAX re-traces
# every lax.scan call)
_ref_forward = jax.jit(RM.forward, static_argnums=(1,))
_ref_population = jax.jit(RM.forward_population, static_argnums=(1,))
_REF_LOGITS = {}


def reference_target(cfg):
    """The reference's calibrated ``TrainedSRU``, untrained (training costs
    tens of seconds even at a few steps)."""
    task = RS.SpeechTask(input_dim=cfg.input_dim, n_states=cfg.n_outputs)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    raw_subsets, raw_test = RS.speech_eval_sets(task, batch=2, seq=12)

    def stack(bs):
        return (jnp.concatenate([b["feats"] for b in bs]),
                jnp.concatenate([b["labels"] for b in bs]))

    cal_feats = [b["feats"] for s in raw_subsets for b in s]
    act_ranges = RM.calibrate(params, cfg, cal_feats)
    wclips = {(n, b): c for b in (2, 4, 8) for n, c in RM.weight_clips(
        params, cfg, {n: b for n in cfg.layer_names()}).items()}
    ref = RX.TrainedSRU(cfg, params, task, [stack(s) for s in raw_subsets],
                        [stack(raw_test)], act_ranges, wclips,
                        RM.weight_ranges(params, cfg), 0.0, 0.0)
    ref.baseline_val_error = ref.val_error()
    ref.baseline_test_error = ref.test_error()
    ref.cal_feats = cal_feats
    return ref


def port_cfg(cfg):
    return TM.SRUModelConfig(**dataclasses.asdict(cfg))


def _sets(pairs):
    return [(torch.from_numpy(np.array(f)),
             torch.from_numpy(np.array(l)).long()) for f, l in pairs]


def port_target(ref):
    """The port's target on exactly the reference's arrays."""
    params = TM.params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    target = TX.TrainedSRU(port_cfg(ref.cfg), params, None,
                           _sets(ref.val_subsets), _sets(ref.test_batches),
                           dict(ref.act_ranges), dict(ref.wclips),
                           dict(ref.wranges))
    target.baseline_val_error = target.val_error()
    target.baseline_test_error = target.test_error()
    return target


def random_allocs(names, n, seed):
    rng = np.random.default_rng(seed)
    return [{nm: (int(rng.choice(MENU)), int(rng.choice(MENU)))
             for nm in names} for _ in range(n)]


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    ref = reference_target(CFGS[request.param])
    return request.param, ref, port_target(ref)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


def _equal_tree(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _equal_tree(port[k], ref[k])
        return
    ref = torch.from_numpy(np.array(ref))
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert torch.equal(port, ref)


def test_params_carry_across_and_back(pair):
    _, ref, port = pair
    back = TM.params_to_numpy(port.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref.params):
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == np.float32
        assert np.array_equal(node, np.asarray(leaf))
    fresh = TM.init_params(torch.Generator().manual_seed(0), port.cfg, "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref.params)
    assert TM._tree_map(lambda t: tuple(t.shape), fresh) == shapes


def test_calibration_clips_and_ranges(pair):
    _, ref, port = pair
    cal = [torch.from_numpy(np.asarray(f)) for f in ref.cal_feats]
    ranges = TM.calibrate(port.params, port.cfg, cal)
    assert set(ranges) == set(ref.act_ranges)
    for k, v in ref.act_ranges.items():
        assert ranges[k] == pytest.approx(v, rel=1e-5)
    for bits in (2, 4, 8):
        clips = TM.weight_clips(port.params, port.cfg,
                                {n: bits for n in port.cfg.layer_names()})
        assert clips == {n: ref.wclips[(n, bits)] for n in clips}
    assert TM.weight_ranges(port.params, port.cfg) == ref.wranges


@pytest.mark.parametrize("packed", [False, True])
def test_whole_model_banks_bitwise(pair, packed):
    """Every layer's bank, every menu entry, and the 16-bit vectors."""
    _, ref, port = pair
    want = RM.build_weight_banks(ref.params, ref.cfg, ref.wclips, ref.wranges,
                                 packed=packed)
    got = TM.build_weight_banks(port.params, port.cfg, port.wclips,
                                port.wranges, packed=packed)
    _equal_tree(got, want)


def test_qp_menu_tables_bitwise(pair):
    _, ref, port = pair
    for got, want in zip(port.qp_menu_tables(), ref.qp_menu_tables()):
        assert np.array_equal(got, want)


def test_forward_matches_reference(pair):
    _, ref, port = pair
    feats = ref.val_subsets[0][0]
    _close(TM.forward(port.params, port.cfg, torch.from_numpy(np.asarray(feats))),
           _ref_forward(ref.params, ref.cfg, feats))
    for alloc in random_allocs(port.cfg.layer_names(), 3, seed=1):
        _close(TM.forward(port.params, port.cfg,
                          torch.from_numpy(np.asarray(feats)),
                          qp=port.qp_for(alloc)),
               _ref_forward(ref.params, ref.cfg, feats, qp=ref.qp_for(alloc)))


LANES = ["requant", "f32", "packed", "f32+u0"]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("lane", LANES)
def test_forward_population_lanes(pair, lane, use_kernel):
    """Every lane of the port's population forward (plain, and the kernel
    lane with the kernels' plain versions) against the reference's banked
    population forward on the same lane."""
    name, ref, port = pair
    if lane == "f32+u0" and name == "highway":
        # the u-bank is invalid under the L0 highway skip: refused, and the
        # evaluator wires no extend hook (as the reference's)
        with pytest.raises(ValueError, match="highway"):
            TM.extend_banks_u0(port.make_banks(port.params), port.cfg,
                               port.val_subsets[0][0],
                               port.qp_menu_tables()[1][0])
        assert port.batched_evaluator()._extend_banks is None
        assert ref.batched_evaluator()._extend_banks is None
        return
    allocs = random_allocs(port.cfg.layer_names(), 5, seed=3)
    names = list(port.cfg.layer_names())
    stack = RB.stack_qps([ref.qp_for(a) for a in allocs], names)
    feats = ref.val_subsets[1][0]
    tfeats = torch.from_numpy(np.asarray(feats))
    r_banks = t_banks = None
    if lane != "requant":
        packed = lane == "packed"
        r_banks = RM.build_weight_banks(ref.params, ref.cfg, ref.wclips,
                                        ref.wranges, packed=packed)
        t_banks = TM.build_weight_banks(port.params, port.cfg, port.wclips,
                                        port.wranges, packed=packed)
    if lane == "f32+u0":
        a_trips = ref.qp_menu_tables()[1][0]
        r_banks = RM.extend_banks_u0(r_banks, ref.cfg, feats, a_trips)
        t_banks = TM.extend_banks_u0(t_banks, port.cfg, tfeats, a_trips,
                                     use_kernel=use_kernel)
        _close(t_banks["L0"]["fwd"]["U"], r_banks["L0"]["fwd"]["U"])
    if (name, lane) not in _REF_LOGITS:       # shared by both port lanes
        _REF_LOGITS[name, lane] = _ref_population(
            ref.params, ref.cfg, feats, jnp.asarray(stack), banks=r_banks)
    want = _REF_LOGITS[name, lane]
    got = TM.forward_population(port.params, port.cfg, tfeats,
                                torch.from_numpy(stack), banks=t_banks,
                                use_kernel=use_kernel)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_per_lane_feats_and_lane_independence(pair):
    """(P, B, T, m) inputs score lane i's frames under lane i's grids, and
    changing one lane's allocation changes no other lane's logits."""
    _, ref, port = pair
    names = list(port.cfg.layer_names())
    allocs = random_allocs(names, 4, seed=8)
    banks = port.make_banks(port.params)
    stack = torch.from_numpy(TB.stack_qps([port.qp_for(a) for a in allocs],
                                          names))
    feats = port.val_subsets[0][0]
    base = TM.forward_population(port.params, port.cfg, feats, stack,
                                 banks=banks)
    per_lane = TM.forward_population(
        port.params, port.cfg, feats.expand((4,) + tuple(feats.shape)), stack,
        banks=banks)
    assert torch.equal(per_lane, base)
    flipped = dict(allocs[2])
    flipped[names[0]] = (2, 2) if allocs[2][names[0]] != (2, 2) else (16, 16)
    stack2 = torch.from_numpy(TB.stack_qps(
        [port.qp_for(a) for a in allocs[:2] + [flipped] + allocs[3:]], names))
    moved = TM.forward_population(port.params, port.cfg, feats, stack2,
                                  banks=banks)
    for lane in (0, 1, 3):
        assert torch.equal(moved[lane], base[lane])
    assert not torch.equal(moved[2], base[2])


def test_synthetic_speech_task():
    """The teacher is the reference's exactly; batches are pure functions
    of (seed, step, host) (their features differ from the reference's
    threefry draws by design, see repro_torch.data.synthetic)."""
    ref_task = RS.SpeechTask(input_dim=5, n_states=7)
    task = TS.SpeechTask(input_dim=5, n_states=7)
    for got, want in zip(task.teacher(), ref_task.teacher()):
        assert np.array_equal(got, np.asarray(want))
    a = TS.speech_batch(task, 2, 12, seed=77, step=3, device="cpu")
    b = TS.speech_batch(task, 2, 12, seed=77, step=3, device="cpu")
    c = TS.speech_batch(task, 2, 12, seed=77, step=4, device="cpu")
    assert torch.equal(a["feats"], b["feats"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["feats"], c["feats"])
    assert a["feats"].shape == (2, 12, 5) and a["labels"].shape == (2, 12)
    subsets, test = TS.speech_eval_sets(task, batch=2, seq=12, device="cpu")
    assert len(subsets) == 4 and all(len(s) == 2 for s in subsets)
    assert len(test) == 8


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(torch.Generator().manual_seed(0), port_cfg(
            CFGS["highway"]))
