"""Decision parity of the port's search path with the reference: integer
error counts of the scalar path and of the population evaluator (f32 banks,
packed banks, requantizing lanes), and the Pareto fronts of
``SearchSession`` on the paper's experiments 1, 2 and 3 (inference-only),
on the reference's own arrays (see ``test_torch_sru.reference_target``).
Also the evaluator's fault hooks and the search surface's argument
checks."""
import dataclasses

import numpy as np
import pytest

from repro.core import api as RA
from repro_torch.core import api as TA
from repro_torch.core import faults as TF
from test_torch_sru import (CFGS, port_target, random_allocs,
                            reference_target)

# (platform, objectives) of the paper's experiments, run inference-only
EXPERIMENTS = {
    "mem-only": ("error", "memory"),
    "silago": ("error", "speedup", "energy"),
    "bitfusion": ("error", "speedup"),
}


@pytest.fixture(scope="module")
def pair():
    ref = reference_target(CFGS["no_highway"])
    return ref, port_target(ref)


def _explain(port, ref, allocs, got, want):
    """On a mismatch: the lane, and per flipped frame its logit margin."""
    import torch
    from repro_torch.models import sru as TM
    lines = []
    for lane, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        lines.append(f"lane {lane} alloc {allocs[lane]}: port {g} ref {w}")
        for s, (feats, labels) in enumerate(port.val_subsets):
            logits = TM.forward(port.params, port.cfg, feats,
                                qp=port.qp_for(allocs[lane]))
            top2 = torch.topk(logits, 2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1]).flatten()
            lines.append(f"  subset {s}: smallest top-2 logit margins "
                         f"{sorted(margin.tolist())[:3]}")
    return "\n".join(lines)


def test_baselines_and_scalar_errors_equal(pair):
    ref, port = pair
    assert port.baseline_val_error == ref.baseline_val_error
    assert port.baseline_test_error == ref.baseline_test_error
    allocs = random_allocs(port.layer_names, 6, seed=2)
    want = [ref.val_error(a) for a in allocs]
    got = [port.val_error(a) for a in allocs]
    assert got == want, _explain(port, ref, allocs, got, want)


def test_argmax_differences_are_reference_ties(pair):
    """Known fault (ROADMAP queue 3): at coarse FC grids many logits tie
    exactly in the reference (multiples of one grid step that cancel to
    0.0), and the CPU GEMM's fused, reordered sums leave ~1e-9 residues
    instead, so the argmax of a tied frame can differ. Every frame whose
    argmax differs must be such a tie; any other difference is a bug."""
    import jax
    import torch
    from repro.models import sru as RM
    from repro_torch.models import sru as TM
    ref, port = pair
    ref_forward = jax.jit(RM.forward, static_argnums=(1,))
    flipped = frames = 0
    for alloc in random_allocs(port.layer_names, 12, seed=11):
        for feats, _ in ref.val_subsets:
            ref_logits = np.asarray(ref_forward(ref.params, ref.cfg, feats,
                                                qp=ref.qp_for(alloc)))
            port_logits = TM.forward(port.params, port.cfg,
                                     torch.from_numpy(np.array(feats)),
                                     qp=port.qp_for(alloc)).numpy()
            np.testing.assert_allclose(port_logits, ref_logits, rtol=1e-4,
                                       atol=1e-3)
            differ = ref_logits.argmax(-1) != port_logits.argmax(-1)
            frames += differ.size
            for b, t in np.argwhere(differ):
                top = np.sort(ref_logits[b, t])[::-1]
                assert top[0] - top[1] <= 1e-6, (alloc, b, t, top[:2])
                flipped += 1
    assert frames == 12 * 4 * 48
    print(f"{flipped} of {frames} frames flip, all at reference ties")


@pytest.mark.parametrize("lane", [
    dict(use_banks=True, bank_format="f32"),
    dict(use_banks=True, bank_format="packed"),
    dict(use_banks=False),
    dict(use_banks=True, bank_format="f32", use_kernel=True),
    dict(use_banks=True, bank_format="packed", use_kernel=True)])
def test_evaluator_error_counts_equal(pair, lane):
    """Odd population (padding lanes) through every evaluator lane."""
    ref, port = pair
    allocs = random_allocs(port.layer_names, 11, seed=2)
    want = ref.val_error_batch(allocs, bank_format=lane.get("bank_format",
                                                            "f32"))
    got = port.val_error_batch(allocs, **lane)
    assert got == want, _explain(port, ref, allocs, got, want)


@pytest.mark.parametrize("platform", sorted(EXPERIMENTS))
def test_search_fronts_equal(pair, platform):
    ref, port = pair
    objectives = EXPERIMENTS[platform]
    kw = dict(generations=2, pop=6, initial=12, seed=0)
    want = RA.SearchSession(ref, platform, objectives).run(**kw)
    got = TA.SearchSession(port, platform, objectives).run(**kw)
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals
    assert got.format(with_test=False) == want.format(with_test=False)


def test_search_surface_waiting_for_later_ports(pair):
    """The reference's contract for checkpointed runs: ``resume=True``
    without a ``checkpoint_dir`` raises ``ValueError``. Beacons need a
    target that retrains, and one whose ``supports_retrain`` is false
    still raises."""
    _, port = pair
    sess = TA.SearchSession(port, "bitfusion", ("error", "speedup"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        sess.run(generations=1, pop=2, initial=2, resume=True)
    frozen = dataclasses.replace(port)
    frozen.supports_retrain = False
    with pytest.raises(NotImplementedError, match="retrain"):
        TA.SearchSession(frozen, "bitfusion", ("error", "speedup")).run(
            generations=1, pop=2, initial=2, beacons=True)


def test_fault_hooks(pair):
    """Transient dispatch failures retry to the same errors, poisoned lanes
    come back as NaN, and a device loss cannot be survived on one device."""
    _, port = pair
    allocs = random_allocs(port.layer_names, 3, seed=4)
    ev = port.batched_evaluator(bank_format="packed")
    clean = ev.errors(allocs, port.params)
    ev.faults = TF.FaultInjector([TF.FailDispatch(at=1, times=2)])
    ev.retry_backoff_s = 0.0
    assert ev.errors(allocs, port.params) == clean
    assert [e["event"] for e in ev.fault_log] == ["retry", "retry"]
    ev.faults = TF.FaultInjector([TF.PoisonLanes(at=1, lanes=(1,))])
    poisoned = ev.errors(allocs, port.params)
    assert np.isnan(poisoned[1]) and poisoned[0] == clean[0]
    ev.faults = TF.FaultInjector([TF.LoseDevices(at=1, keep=1)])
    with pytest.raises(RuntimeError, match="device loss"):
        ev.errors(allocs, port.params)
    ev.faults = None


def test_untrained_target_searches_on_cpu():
    """``build_untrained_sru`` (the entry point ``chip_smoke.py`` drives at
    full width) on a tiny config: seeded, calibrated, searchable, and the
    kernel lane (the kernels' plain versions here) scores like the plain
    lane and the packed banks like the f32 ones."""
    from repro_torch.core import sru_experiment as TX
    from test_torch_sru import port_cfg
    cfg = port_cfg(CFGS["no_highway"])
    target = TX.build_untrained_sru(cfg, seed=3, device="cpu")
    again = TX.build_untrained_sru(cfg, seed=3, device="cpu")
    assert target.act_ranges == again.act_ranges
    assert target.wclips == again.wclips
    assert [f.shape for f, _ in target.val_subsets] == [(8, 48, 5)] * 4
    assert 0.0 <= target.baseline_val_error <= 100.0
    res = TA.SearchSession(target, "silago").run(generations=1, pop=4,
                                                 initial=8, seed=1)
    allocs = [row["alloc"] for row in res.rows()]
    errs = target.val_error_batch(allocs)
    assert errs == [row["error"] for row in res.rows()]
    assert target.val_error_batch(allocs, use_kernel=True) == errs
    assert target.val_error_batch(allocs, bank_format="packed") == errs
