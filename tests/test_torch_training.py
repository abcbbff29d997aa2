"""The port's training path against the reference's, on the reference's
own arrays: the static-``qspec`` quantization primitives, the
differentiable forward and its gradients, AdamW and its schedules,
binary-connect retraining, the retraining stream, ``train_small_sru``, and
the beacon-based search (paper §4.3, Algorithm 1) end to end.

The port's synthetic features differ from the reference's (numpy streams
against threefry), so every comparison feeds the port the reference's
batches; the retraining stream is swapped with ``monkeypatch`` for one
that yields them. Tolerances are stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as RA
from repro.core import quantization as RQ
from repro.core import sru_experiment as RX
from repro.data import synthetic as RS
from repro.models import sru as RM
from repro.training import optimizer as RO
from repro.training import qat as RT
from repro_torch.core import api as TA
from repro_torch.core import quantization as Q
from repro_torch.core import sru_experiment as TX
from repro_torch.data import synthetic as TS
from repro_torch.models import sru as TM
from repro_torch.training import optimizer as TO
from repro_torch.training import qat as TT
from test_torch_sru import CFGS, port_cfg, port_target, reference_target

MENU = (2, 4, 8, 16)
# an allocation that takes every menu entry for weights and activations
ALLOC = {"L0": (16, 8), "Pr1": (8, 4), "L1": (4, 16), "Pr2": (2, 8),
         "L2": (8, 2), "FC": (4, 4)}
ALLOC_HW = {"L0": (4, 8), "Pr1": (2, 16), "L1": (16, 4), "FC": (8, 2)}


def _alloc(cfg):
    return ALLOC if cfg.n_sru_layers == 3 else ALLOC_HW


def _np(t):
    return t.detach().cpu().numpy()


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


def _torch_batch(batch):
    return {"feats": torch.from_numpy(np.array(batch["feats"])),
            "labels": torch.from_numpy(np.array(batch["labels"])).long()}


def _ref_stream(task, batch, seq, seed, start_step=0):
    for b in RS.speech_batches(task, batch, seq, seed=seed,
                               start_step=start_step):
        yield _torch_batch(b)


def _wclips(target, alloc):
    return {n: target.wclips[(n, a[0])] for n, a in alloc.items()
            if a[0] != 16}


@pytest.fixture(scope="module")
def trained_ref():
    """A reference Bi-SRU trained for 30 steps: an untrained model's
    candidates never reach the retraining window of Algorithm 1."""
    return RX.train_small_sru(30, cfg=CFGS["no_highway"])


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    """``highway``: the untrained ``reference_target``; ``no_highway``: the
    trained reference (each reference fixture costs ~10 s to build)."""
    if request.param == "highway":
        ref = reference_target(CFGS["highway"])
    else:
        ref = request.getfixturevalue("trained_ref")
    return ref, port_target(ref)


def _ref_loss(cfg, alloc, wclips, act_ranges):
    """The reference's retraining loss: value, gradient and logits."""
    def loss(p, feats, labels):
        logits = RM.forward(p, cfg, feats, qspec=alloc, wclips=wclips,
                            act_ranges=act_ranges)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        gold = jnp.take_along_axis(logp, labels[..., None], -1)
        return -jnp.mean(gold), logits
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("bits", MENU)
def test_qspec_primitives_bitwise_with_unit_ste_gradient(bits):
    """Bitwise equal values for every bit-width (clips and ranges as host
    floats, as the search passes them), and the STE gradient exactly 1."""
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((37, 29)) * 0.4).astype(np.float32)
    a = (rng.standard_normal((3, 11, 17)) * 2.5).astype(np.float32)
    clip = RQ.mmse_clip(w, bits) if bits != 16 else None
    a_range = float(np.median(np.abs(a).max(axis=(1, 2))))
    tw, ta = torch.from_numpy(w), torch.from_numpy(a)
    pairs = [(Q.quantize_weight(tw, bits, clip),
              RQ.quantize_weight(w, bits, clip)),
             (Q.quantize_weight(tw, bits), RQ.quantize_weight(w, bits)),
             (Q.ste_quantize_weight(tw, bits, clip),
              RQ.ste_quantize_weight(w, bits, clip)),
             (Q.quantize_activation(ta, bits, a_range),
              RQ.quantize_activation(a, bits, a_range))]
    if bits != 16:
        pairs.append((Q.quantize_int(tw, bits, clip),
                      RQ.quantize_int(w, bits, clip)))
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert np.array_equal(_np(got), np.asarray(want))
    for fn, x in ((lambda t: Q.ste_quantize_weight(t, bits, clip), w),
                  (lambda t: Q.quantize_activation(t, bits, a_range), a)):
        t = torch.from_numpy(x).requires_grad_(True)
        fn(t).sum().backward()
        assert torch.equal(t.grad, torch.ones_like(t))
    ref_grad = jax.grad(lambda x: jnp.sum(
        RQ.ste_quantize_weight(x, bits, clip)))(w)
    assert np.array_equal(np.asarray(ref_grad), np.ones_like(w))


# --------------------------------------------------- forward and gradients

def test_forward_qspec_logits_loss_and_gradients(pair):
    """``forward(qspec=)`` and the full-precision training forward: logits
    at rtol 1e-4 / atol 1e-3; the retraining loss at rtol 1e-5; each
    gradient leaf within 1e-4 of its largest |gradient| (the two packages
    sum the products in different orders). v and b have zero gradients in
    both packages: ``fixed_point_16`` rounds them without STE."""
    ref, port = pair
    alloc = _alloc(ref.cfg)
    wclips = _wclips(ref, alloc)
    feats, labels = ref.val_subsets[0]
    tf = torch.from_numpy(np.array(feats))
    tl = torch.from_numpy(np.array(labels)).long()
    kw = dict(wclips=wclips, act_ranges=ref.act_ranges)
    (want_loss, want), want_g = _ref_loss(ref.cfg, alloc, wclips,
                                          ref.act_ranges)(ref.params, feats,
                                                          labels)
    got = TM.forward(port.params, port.cfg, tf, qspec=alloc, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(
        _np(TM.forward_train(port.params, port.cfg, tf)),
        np.asarray(jax.jit(RM.forward, static_argnums=(1,))(
            ref.params, ref.cfg, feats)), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="qspec"):
        TM.forward(port.params, port.cfg, tf, qspec=alloc,
                   qp=port.qp_for(alloc))
    got_loss, got_g = TO.value_and_grad(
        lambda p, f, l: TT.frame_nll(TM.forward(p, port.cfg, f, qspec=alloc,
                                                **kw), l),
        port.params, tf, tl)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    for g, w in zip(TO.tree_leaves(got_g), _leaves(want_g)):
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))
    for i in range(ref.cfg.n_sru_layers):
        for d in ("fwd", "bwd"):
            for k in ("v", "b"):
                assert not got_g[f"L{i}"][d][k].any()
                assert not np.asarray(want_g[f"L{i}"][d][k]).any()


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_schedule_lr_matches_reference(schedule):
    """Every step of a 40-step schedule within rtol 1e-6, or within 1e-6
    of the peak rate where ``1 + cos`` cancels near the cosine's end
    (``torch.cos`` and ``jnp.cos`` may differ in the last bit)."""
    cfg = dict(lr=3e-3, schedule=schedule, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray(RO.schedule_lr(RO.AdamWConfig(**cfg),
                                     jnp.asarray(steps)))
    got = _np(TO.schedule_lr(TO.AdamWConfig(**cfg), torch.from_numpy(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 3e-3)


def test_adamw_three_steps_match_reference():
    """Three updates on the same gradients, the first two clipped (norm >
    1) and weight decay on (so only the 2-D leaves decay): params, moments
    and metrics within rtol 1e-5 / atol 1e-8, counts equal."""
    rng = np.random.default_rng(5)
    shapes = {"a": {"W": (6, 5), "v": (2, 5)}, "b": {"b": (7,)},
              "c": {"W": (4, 3)}}

    def tree(scale):
        return {k: {n: (rng.standard_normal(s) * scale).astype(np.float32)
                    for n, s in d.items()} for k, d in shapes.items()}

    params = tree(1.0)
    grads = [tree(3.0), tree(1.0), tree(0.01)]
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=10)
    r_p, r_o = params, RO.init_opt_state(params)
    t_p = TM.params_from_numpy(params, "cpu")
    t_o = TO.init_opt_state(t_p)
    for g in grads:
        r_p, r_o, r_m = RO.adamw_update(RO.AdamWConfig(**cfg), r_p, g, r_o)
        t_p, t_o, t_m = TO.adamw_update(TO.AdamWConfig(**cfg), t_p,
                                        TM.params_from_numpy(g, "cpu"), t_o)
        for key in ("grad_norm", "lr"):
            assert float(t_m[key]) == pytest.approx(float(r_m[key]),
                                                    rel=1e-6)
        for got, want in ((t_p, r_p), (t_o["m"], r_o["m"]),
                          (t_o["v"], r_o["v"])):
            for a, b in zip(TO.tree_leaves(got), _leaves(want)):
                np.testing.assert_allclose(_np(a), b, rtol=1e-5, atol=1e-8)
        assert int(t_o["count"]) == int(r_o["count"])
    assert float(r_m["grad_norm"]) < 1.0 < float(RO.global_norm(grads[0]))


# ------------------------------------------------------------ retraining

def test_retrain_sru_matches_reference(pair):
    """Three binary-connect steps on the reference's batches. Adam turns a
    gradient's sign into a step of ~lr, so an element whose gradient is at
    the rounding floor (|g| <= 1e-5 of its leaf's largest) may move the
    other way in the other package: every element off by more than 1e-6 must
    be one of those. v and b come back unchanged in both packages."""
    ref, port = pair
    alloc = _alloc(ref.cfg)
    wclips = _wclips(ref, alloc)
    kw = dict(steps=3, act_ranges=ref.act_ranges, wclips=wclips)
    want = RT.retrain_sru(ref.params, ref.cfg, alloc,
                          RS.speech_batches(ref.task, 8, 48, seed=3), **kw)
    got = TT.retrain_sru(port.params, port.cfg, alloc,
                         _ref_stream(ref.task, 8, 48, seed=3), **kw)
    first = next(RS.speech_batches(ref.task, 8, 48, seed=3))
    _, g0 = _ref_loss(ref.cfg, alloc, wclips, ref.act_ranges)(
        ref.params, first["feats"], first["labels"])
    moved = 0
    for a, b, g, base in zip(TO.tree_leaves(got), _leaves(want),
                             _leaves(g0), _leaves(ref.params)):
        off = np.abs(_np(a) - b) > 1e-6
        floor = 1e-5 * float(np.abs(g).max())
        assert (np.abs(g[off]) <= floor).all(), np.abs(g[off]).max()
        moved += int((b != base).sum())
    assert moved > 0
    for i in range(ref.cfg.n_sru_layers):
        for d in ("fwd", "bwd"):
            for k in ("v", "b"):
                assert torch.equal(got[f"L{i}"][d][k],
                                   port.params[f"L{i}"][d][k])
                assert np.array_equal(np.asarray(want[f"L{i}"][d][k]),
                                      np.asarray(ref.params[f"L{i}"][d][k]))


def test_skip_retrains_fast_forwards_the_stream():
    """The first retrain after skipping one sees exactly the batches of the
    second retrain of an unskipped stream: bitwise equal beacons."""
    cfg = port_cfg(CFGS["highway"])
    target = TX.build_untrained_sru(cfg, seed=2, device="cpu")
    alloc = _alloc(cfg)
    plain = target.beacon_retrainer(2)
    first, second = (plain(alloc, target.params) for _ in range(2))
    skipped = target.beacon_retrainer(2, skip_retrains=1)(alloc,
                                                          target.params)
    for a, b, c in zip(TO.tree_leaves(skipped), TO.tree_leaves(second),
                       TO.tree_leaves(first)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, c) for a, c in zip(
        TO.tree_leaves(skipped), TO.tree_leaves(first)))


def test_train_small_sru_on_cpu():
    """Deterministic for a seed, another seed draws other weights, and the
    loss falls (the mean of the last 10 of 30 steps below the first 10)."""
    cfg = port_cfg(CFGS["no_highway"])
    runs = []
    for seed in (0, 0, 1):
        losses = []
        target = TX.train_small_sru(30, cfg=cfg, batch=4, seq=24, seed=seed,
                                    device="cpu",
                                    log=lambda i, l: losses.append(float(l)))
        runs.append((target, losses))
    (a, la), (b, lb), (c, _) = runs
    assert la == lb and a.act_ranges == b.act_ranges
    assert all(torch.equal(x, y) for x, y in zip(TO.tree_leaves(a.params),
                                                 TO.tree_leaves(b.params)))
    assert not torch.equal(a.params["FC"]["W"], c.params["FC"]["W"])
    assert np.isfinite(la).all() and np.mean(la[-10:]) < np.mean(la[:10])
    assert a.supports_retrain
    assert 0.0 <= a.baseline_val_error < 100.0


# ----------------------------------------------------------- beacon search

def test_beacon_search_matches_reference(trained_ref, monkeypatch):
    """Experiment 3's beacon-based search on the trained fixture in both
    packages: the same beacons in the same order, the same retrains,
    evaluations and front."""
    ref, port = trained_ref, port_target(trained_ref)
    calls = []

    def stream(task, batch, seq, *, seed, start_step=0, device):
        calls.append((batch, seq, seed, start_step, str(device)))
        return _ref_stream(ref.task, batch, seq, seed, start_step)

    monkeypatch.setattr(TS, "speech_batches", stream)
    kw = dict(generations=2, pop=6, initial=12, seed=2, beacons=True,
              retrain_steps=3)
    want = RA.SearchSession(ref, "bitfusion", ("error", "speedup")).run(**kw)
    got = TA.SearchSession(port, "bitfusion", ("error", "speedup")).run(**kw)
    rb, tb = want.beacon_search, got.beacon_search
    assert rb.n_retrains >= 2          # 2 on this fixture and seed
    assert tb.n_retrains == rb.n_retrains
    assert [b.alloc for b in tb.beacons] == [b.alloc for b in rb.beacons]
    assert calls == [(8, 48, 3, 0, "cpu")]
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals

