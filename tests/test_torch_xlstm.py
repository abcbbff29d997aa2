"""The port's xLSTM search target against the reference's, on the
reference's own arrays: the bf16 quantizers, bank rows, the bigram token
task, the model's blocks, the target's forwards and its three population
lanes, error counts and Pareto fronts, binary-connect retraining and the
beacon search.

The fixture trains the reference's ``train_small_xlstm(steps=100)`` once
and converts its params, evaluation sets, activation ranges and weight
grids (the port's token streams and initial weights differ from the
reference's: numpy and ``torch.Generator`` against threefry).

The reference runs jitted on the CPU, where XLA keeps the float32 sum of a
bf16 residual add that feeds a norm (``models/common.py::add_rms_norm``);
the port follows it, so the population logits agree within ~1e-6 in most
lanes. A lane can still diverge where a bf16 rounding before a coarse grid
falls the other way (the norms sum in another order). Decisions are held
by the rule of ROADMAP's third parity tier: a frame whose argmax differs
must have a reference top-2 margin below its lane's measured logit gap,
and every such flip is printed with its margin."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as RA
from repro.core import batched_eval as RBE
from repro.core import quantization as RQ
from repro.core import xlstm_target as RXT
from repro.data import synthetic as RS
from repro.models import registry as RREG
from repro.models import xlstm as RM
from repro.training import qat as RT
from repro_torch.configs.base import ArchConfig
from repro_torch.core import api as TA
from repro_torch.core import quantization as Q
from repro_torch.core import xlstm_target as TXT
from repro_torch.data import synthetic as TS
from repro_torch.models import registry as TREG
from repro_torch.models import xlstm as TM
from repro_torch.training import optimizer as TO
from repro_torch.training import qat as TT

MENU = (2, 4, 8, 16)
EXPERIMENTS = {"bitfusion": ("error", "speedup"),
               "mem-only": ("error", "memory"),
               "silago": ("error", "speedup", "energy")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: with six test workers on eight cores a
    multithreaded op waits on its own threads (the tier-1 run's
    ``--dist loadfile`` puts this whole file on one worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _bits(a):
    """Raw bits of a bf16/f32 array or tensor, for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        a = TM.params_to_numpy(a) if a.dtype == torch.bfloat16 else _np(a)
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _tokens(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


def random_allocs(names, n, seed):
    rng = np.random.default_rng(seed)
    return [{nm: (MENU[rng.integers(4)], MENU[rng.integers(4)])
             for nm in names} for _ in range(n)]


def port_target(ref):
    """The port's target on the reference's params, sets and grids."""
    val = [(_tokens(t), _tokens(l)) for t, l in ref.val_subsets]
    test = [(_tokens(t), _tokens(l)) for t, l in ref.test_batches]
    target = TXT.XLSTMTarget(
        _port_cfg(ref.cfg),
        TM.params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu"),
        val, test, dict(ref.act_ranges), dict(ref.wclips),
        dict(ref.wranges))
    target.baseline_val_error = target.val_error()
    target.baseline_test_error = target.test_error()
    return target


@pytest.fixture(scope="module")
def pair():
    ref = RXT.train_small_xlstm(steps=100)
    return ref, port_target(ref)


def _flips(ref_logits, port_logits):
    """Frames whose argmax differs, each with its reference top-2 margin,
    and each lane's logit gap (max |difference|); logits (P, ..., V)."""
    ref_logits = np.asarray(ref_logits, np.float32)
    differ = ref_logits.argmax(-1) != port_logits.argmax(-1)
    top = np.sort(ref_logits, -1)
    margin = top[..., -1] - top[..., -2]
    gap = np.abs(ref_logits - port_logits).reshape(
        len(ref_logits), -1).max(1)
    return [(int(p), float(margin[(p,) + tuple(rest)]), float(gap[p]))
            for p, *rest in np.argwhere(differ)]


def _assert_flips_at_ties(flips):
    for lane, margin, gap in flips:
        assert margin < gap, (lane, margin, gap)
    if flips:
        print(f"{len(flips)} argmax flips (lane, reference margin, lane "
              f"gap): {flips}")


# ------------------------------------------------------- bf16 quantizers

@pytest.mark.parametrize("bits", MENU)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantizers_bitwise_in_value_and_dtype(bits, dtype):
    """Every quantizer on bf16 and f32 data, bitwise in value and dtype
    against the reference jitted: a float32-array grid widens bf16 data
    (``fake_quant_triple``), a Python-float grid keeps bf16 arithmetic with
    a bf16 scale (``quantize_int`` and its callers), a numpy-scalar clip
    widens it and returns float32."""
    rng = np.random.default_rng(bits)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    w = jnp.asarray((rng.standard_normal((256, 512)) * 0.05
                     ).astype(np.float32)).astype(jdt)
    a = jnp.asarray((rng.standard_normal((8, 32, 512)) * 1.7
                     ).astype(np.float32)).astype(jdt)
    tw = TM.params_from_numpy(np.asarray(w), "cpu")
    ta = TM.params_from_numpy(np.asarray(a), "cpu")
    clip = float(RQ.mmse_clip(np.asarray(w, np.float32), min(bits, 8)))
    a_range = float(np.median(np.abs(np.asarray(a, np.float32)).max((1, 2))))
    trip = [np.float32(v) for v in RQ.quant_triple(bits, a_range)]
    pairs = [
        (Q.ste_quantize_weight(tw, bits, clip),
         jax.jit(lambda x: RQ.ste_quantize_weight(x, bits, clip))(w)),
        (Q.quantize_activation(ta, bits, a_range),
         jax.jit(lambda x: RQ.quantize_activation(x, bits, a_range))(a))]
    if bits != 16:
        for c in (clip, np.float64(clip)):   # weakly, strongly typed
            pairs.append((Q.quantize_int(tw, bits, c),
                          jax.jit(lambda x: RQ.quantize_int(x, bits, c))(w)))
    for ste in (True, False):
        pairs.append((Q.fake_quant_triple(ta, *trip, use_ste=ste),
                      jax.jit(lambda x, s, lo, hi: RQ.fake_quant_triple(
                          x, s, lo, hi, use_ste=ste))(a, *trip)))
    for got, want in pairs:
        assert str(got.dtype) == f"torch.{np.asarray(want).dtype}"
        assert np.array_equal(_bits(got), _bits(want))


def test_build_weight_bank_rows_bitwise(pair):
    """Every leaf's bank (bf16 rows for bf16 leaves, f32 for ``r``) equals
    the reference's rows bitwise; the port holds them widened to f32."""
    ref, port = pair
    want, got = ref.make_banks(ref.params), port.make_banks(port.params)
    assert set(got) == set(want) == set(port.layer_names)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key, bank in want[name].items():
            g = got[name][key]
            assert g.dtype == torch.float32 and g.is_contiguous()
            assert g.shape == bank.shape
            dt = torch.bfloat16 if bank.dtype == jnp.bfloat16 else \
                torch.float32
            assert np.array_equal(_bits(g.to(dt)), _bits(bank))
    assert want["s0"]["r"].dtype == jnp.float32
    assert want["m0"]["wq"].dtype == jnp.bfloat16


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_device_mmse_search_picks_the_host_clip(bits):
    """The MMSE clip search that runs on a card (float64, the host's
    candidates and grid) picks the host's clip; run here on CPU tensors."""
    rng = np.random.default_rng(bits)
    for scale in (0.05, 1.3):
        w = (rng.standard_normal(30000) * scale).astype(np.float32)
        assert Q._mmse_clip_on_device(torch.from_numpy(w), bits, 64) == \
            RQ.mmse_clip(w, bits)


def test_bank_cache_keeps_the_latest_parameter_sets(pair):
    """The xLSTM evaluator keeps the banks of at most two parameter sets
    (the least recently used go first); a rebuilt set scores the same."""
    _, port = pair
    ev = port.batched_evaluator()
    allocs = random_allocs(port.layer_names, 3, seed=9)
    want = ev.errors(allocs, port.params)
    others = [dict(port.params) for _ in range(2)]
    for p in others + [port.params] + others[:1]:
        ev.errors(allocs, p)
    assert [id(v[0]) for v in ev._banks.values()] == [
        id(port.params), id(others[0])]
    assert ev.errors(allocs, others[1]) == want


# ------------------------------------------------------------ the data

def _check_bigram(tokens, labels, vocab, n_noise):
    tokens, labels = np.asarray(tokens), np.asarray(labels)
    noise = (tokens[:, 1:] - 5 * tokens[:, :-1]) % vocab
    assert ((noise >= 0) & (noise < n_noise)).all()
    assert np.array_equal(labels[:, :-1], tokens[:, 1:])
    assert (labels[:, -1] == -1).all()
    assert ((tokens >= 0) & (tokens < vocab)).all()


def test_lm_batch_follows_the_reference_rule():
    """The reference's arrays and the port's obey the same bigram rule
    (next = (5 * prev + noise) % vocab, noise < n_noise, labels shifted);
    the port's batches are a pure function of (seed, step, host), and
    ``lm_batches`` starts at ``start_step``."""
    ref = RS.lm_batch(64, 4, 17, seed=77, step=2, n_noise=2)
    _check_bigram(ref["tokens"], ref["labels"], 64, 2)
    for n_noise in (2, 7):
        b = TS.lm_batch(64, 4, 17, seed=77, step=2, n_noise=n_noise,
                        device="cpu")
        assert b["tokens"].shape == (4, 17) and b["tokens"].dtype == \
            torch.int64
        _check_bigram(b["tokens"], b["labels"], 64, n_noise)
    one, again, other = (TS.lm_batch(64, 4, 17, seed=77, step=s,
                                     n_noise=2, device="cpu")
                         for s in (2, 2, 3))
    assert torch.equal(one["tokens"], again["tokens"])
    assert not torch.equal(one["tokens"], other["tokens"])
    stream = TS.lm_batches(64, 4, 17, seed=77, start_step=3, n_noise=2,
                           device="cpu")
    assert torch.equal(next(stream)["tokens"], other["tokens"])


# ----------------------------------------------------------- the model

def test_blocks_and_training_forward_match_reference(pair):
    """mLSTM (one chunk, and chunks of 5 over 13 steps with padding, its
    state too) and sLSTM bitwise in bf16 against the reference's blocks;
    the training forward's bf16 logits within 0.05 (one bf16 step at the
    logits' scale)."""
    ref, port = pair
    cfg, tcfg = ref.cfg, port.cfg
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 13, cfg.d_model)).astype(
        np.float32)).astype(jnp.bfloat16)
    tx = TM.params_from_numpy(np.asarray(x), "cpu")
    bp = jax.tree.map(lambda a: a[1], ref.params["pairs"])
    tbp = TM.pair(port.params, 1)
    for chunk in (128, 5):
        want, want_s = RM.mlstm_fwd(bp["mlstm"], cfg, x, chunk=chunk,
                                    return_state=True)
        got, got_s = TM.mlstm_fwd(tbp["mlstm"], tcfg, tx, chunk=chunk,
                                  return_state=True)
        assert np.array_equal(_bits(got), _bits(want))
        for k in want_s:
            np.testing.assert_allclose(_np(got_s[k]), np.asarray(want_s[k]),
                                       rtol=1e-5, atol=1e-5)
    assert np.array_equal(_bits(TM.slstm_fwd(tbp["slstm"], tcfg, tx)),
                          _bits(RM.slstm_fwd(bp["slstm"], cfg, x)))
    toks = ref.val_subsets[0][0]
    want = jax.jit(lambda p, t: RM.forward(p, cfg, t))(ref.params, toks)
    got = TM.forward(port.params, tcfg, _tokens(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want, np.float32), atol=0.05)


def test_registry_ssm_model(pair):
    """``get_model`` serves the ssm family: init in the reference's layout
    (shapes and dtypes of every leaf), a finite loss; audio builds its own
    model (``models/encdec.py``)."""
    ref, port = pair
    m = TREG.get_model(port.cfg, "cpu")
    params = m.init(0)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                          ref.params)
    got = TM.params_to_numpy(params)
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        got) == shapes
    batch = RS.lm_batch(ref.cfg.vocab_size, 2, 9, n_noise=2)
    loss = m.loss(port.params, {k: _tokens(v) for k, v in batch.items()})
    assert loss.ndim == 0 and torch.isfinite(loss)
    want = RREG.get_model(ref.cfg).loss(ref.params, batch)
    assert float(loss) == pytest.approx(float(want), rel=1e-3)
    audio = dataclasses.replace(port.cfg, family="audio")
    assert TREG.get_model(audio, "cpu").cfg.family == "audio"


# ---------------------------------------------------------- the target

def test_calibration_and_grids_match_the_reference(pair):
    """Calibration (op by op, as the reference's), MMSE clips and weight
    ranges of the converted params equal the reference's; so do the
    baseline errors and the hardware counts."""
    ref, port = pair
    t = port
    assert TXT.calibrate(port.params, port.cfg,
                         [tk for tk, _ in port.val_subsets]) == \
        ref.act_ranges
    assert TXT.weight_grids(port.params, port.cfg) == (ref.wclips,
                                                       ref.wranges)
    assert t.baseline_val_error == ref.baseline_val_error
    assert t.baseline_test_error == ref.baseline_test_error
    assert t.layer_names == ref.layer_names
    assert t.layer_weights == ref.layer_weights
    assert t.vector_weights == ref.vector_weights
    assert t.fixed_ops == ref.fixed_ops
    assert isinstance(t, TA.SearchTarget)
    qp_w, qp_a = t.qp_menu_tables()
    rw, ra = ref.qp_menu_tables()
    assert np.array_equal(qp_w, rw) and np.array_equal(qp_a, ra)


def test_forward_plain_logits(pair):
    """The full-precision forward against the reference's jitted one:
    within 1e-5 (measured 1.9e-6 on this fixture: float32 sums in
    another order)."""
    ref, port = pair
    fwd = jax.jit(lambda p, t: RXT.forward_plain(p, ref.cfg, t))
    for toks, _ in ref.val_subsets:
        np.testing.assert_allclose(
            _np(TXT.forward_plain(port.params, port.cfg, _tokens(toks))),
            np.asarray(fwd(ref.params, toks)), rtol=0, atol=1e-5)


def test_population_lanes_match_each_other_and_reference(pair):
    """The requant, plain and kernel lanes (on the CPU the kernel wrapper
    runs its plain version) give bitwise the same logits; each lane against
    the reference's jitted ``forward_population`` with and without banks:
    at least 11 lanes of 12 within 1e-4 and every lane within 1e-3
    (measured: 11 or 12 lanes, the worst lane 3.4e-4 off where a bf16
    rounding before a coarse grid falls the other way), and no argmax
    flip."""
    ref, port = pair
    allocs = random_allocs(port.layer_names, 12, seed=3)
    stack = RBE.stack_qps([ref.qp_for(a) for a in allocs],
                          list(ref.layer_names))
    banks = port.make_banks(port.params)
    rbanks = ref.make_banks(ref.params)
    fwd = jax.jit(lambda p, t, s, b: RXT.forward_population(
        p, ref.cfg, t, s, banks=b))
    flips = []
    for toks, _ in ref.val_subsets[:2]:
        lanes = [TXT.forward_population(port.params, port.cfg, _tokens(toks),
                                        torch.from_numpy(stack), **kw)
                 for kw in (dict(), dict(banks=banks, use_kernel=False),
                            dict(banks=banks, use_kernel=True))]
        assert lanes[0].shape == (12,) + tuple(toks.shape) + (
            port.cfg.padded_vocab,)
        assert lanes[0].dtype == torch.float32
        assert torch.equal(lanes[0], lanes[1]) and torch.equal(lanes[1],
                                                               lanes[2])
        got = _np(lanes[1])
        for b in (None, rbanks):
            want = np.asarray(fwd(ref.params, toks, jnp.asarray(stack), b))
            close = np.isclose(got, want, rtol=1e-4, atol=1e-4).reshape(
                12, -1).all(1)
            assert close.sum() >= 11, close
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
            flips += _flips(want, got)
    assert flips == []


def test_lane_flip_moves_no_other_lane(pair):
    """Lane independence: changing one lane's allocation leaves every
    other lane's logits bitwise unchanged (kernel lane with banks, and the
    requant lane)."""
    _, port = pair
    allocs = random_allocs(port.layer_names, 6, seed=5)
    flipped = [dict(allocs[0])] + allocs[1:]
    flipped[0] = {n: ((2, 2) if a != (2, 2) else (16, 16))
                  for n, a in allocs[0].items()}
    toks = port.val_subsets[0][0]
    ev = port.batched_evaluator()
    for banks in (ev._banks_for(port.params), None):
        a, b = (TXT.forward_population(port.params, port.cfg, toks,
                                       ev._stack(x), banks=banks)
                for x in (allocs, flipped))
        assert not torch.equal(a[0], b[0])
        assert torch.equal(a[1:], b[1:])


def _explain(ref, port, allocs, got, want):
    """Each lane whose error differs: its flipped frames in the folded
    dispatch, each with the reference margin and the lane's gap."""
    rev, tev = ref.batched_evaluator(), port.batched_evaluator()
    fwd = jax.jit(lambda p, t, s, b: RXT.forward_population(
        p, ref.cfg, t, s, banks=b))
    want_l = np.asarray(fwd(ref.params, rev._feats_all,
                            jnp.asarray(rev._stack(allocs)),
                            rev._banks_for(ref.params)))
    got_l = _np(TXT.forward_population(port.params, port.cfg,
                                       tev._feats_all, tev._stack(allocs),
                                       banks=tev._banks_for(port.params)))
    lanes = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    return [f for f in _flips(want_l, got_l) if f[0] in lanes]


@pytest.mark.parametrize("lane", [dict(), dict(use_banks=False),
                                  dict(use_kernel=True)])
def test_evaluator_error_counts(pair, lane):
    """An odd population (padding lanes) through every evaluator lane: the
    reference's errors, or flips at reference near-ties."""
    ref, port = pair
    allocs = random_allocs(port.layer_names, 11, seed=2)
    want = ref.val_error_batch(allocs)
    got = port.val_error_batch(allocs, **lane)
    if got != want:
        _assert_flips_at_ties(_explain(ref, port, allocs, got, want))
    assert [port.val_error(a) for a in allocs[:3]] == got[:3]


@pytest.mark.parametrize("platform", sorted(EXPERIMENTS))
def test_search_fronts_equal(pair, platform):
    ref, port = pair
    objectives = EXPERIMENTS[platform]
    kw = dict(generations=2, pop=6, initial=10, seed=0)
    want = RA.SearchSession(ref, platform, objectives).run(**kw)
    got = TA.SearchSession(port, platform, objectives).run(**kw)
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals
    assert got.format(with_test=False) == want.format(with_test=False)


# ------------------------------------------------------------ retraining

def _ref_stream(vocab, seed, start_step=0):
    for b in RS.lm_batches(vocab, 8, 33, seed=seed, start_step=start_step,
                           n_noise=RXT.N_NOISE):
        yield {"tokens": _tokens(b["tokens"])}


RETRAIN_ALLOC = {"m0": (4, 8), "s0": (16, 16), "m1": (2, 4), "s1": (4, 8),
                 "head": (8, 4)}


@pytest.fixture(scope="module")
def ref_loss(pair):
    """The reference's retraining loss under ``RETRAIN_ALLOC``
    (``retrain_xlstm``'s, Python-float clips and ranges) and its gradient,
    jitted once: (params, tokens (B, T + 1)) -> (loss, grads)."""
    ref, alloc = pair[0], RETRAIN_ALLOC
    wq = {n: (a[0], float(ref.wclips.get((n, a[0]), 0.0)))
          for n, a in alloc.items()}

    def loss(p, toks):
        logits = RXT.forward(
            p, ref.cfg, toks[:, :-1],
            lambda nm: {k: RQ.ste_quantize_weight(w, *wq[nm]) for k, w in
                        RXT._layer_leaves(p, ref.cfg, nm).items()},
            lambda nm, x: RQ.quantize_activation(
                x, alloc[nm][1], float(ref.act_ranges[nm])))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, toks[:, 1:, None], -1))
    return jax.jit(jax.value_and_grad(loss))


def _retrain_both(ref, port, steps):
    wclips = {n: ref.wclips[(n, a[0])] for n, a in RETRAIN_ALLOC.items()
              if a[0] != 16}
    kw = dict(steps=steps, act_ranges=ref.act_ranges, wclips=wclips)
    want = RT.retrain_xlstm(ref.params, ref.cfg, RETRAIN_ALLOC, RS.lm_batches(
        ref.cfg.vocab_size, 8, 33, seed=3, n_noise=RXT.N_NOISE), **kw)
    got = TT.retrain_xlstm(port.params, port.cfg, RETRAIN_ALLOC,
                           _ref_stream(ref.cfg.vocab_size, 3), **kw)
    return want, got


def _ref_batch(ref, step):
    return RS.lm_batch(ref.cfg.vocab_size, 8, 33, seed=3, step=step,
                       n_noise=RXT.N_NOISE)["tokens"]


def test_retrain_xlstm_first_step_matches_reference(pair, ref_loss):
    """One binary-connect step on the reference's batch. The first Adam
    step moves an element by ~lr times the sign of its gradient, and the
    bf16 gradients of the two packages differ by up to ~1 % of a leaf's
    largest (bf16 rounds each, after sums in other orders). So the
    training test's rounding-floor rule takes each leaf's measured gradient
    gap as its floor: every element off by more than one step (a bf16 step
    for bf16 leaves, 1e-6 for f32 leaves) must have a reference gradient
    below the gap, where the two signs can differ."""
    ref, port = pair
    want, got = _retrain_both(ref, port, 1)
    tokens = _ref_batch(ref, 0)
    loss_ref, g_ref = ref_loss(ref.params, tokens)

    def port_loss(p, toks):
        wc = {n: float(ref.wclips[(n, a[0])]) for n, a in
              RETRAIN_ALLOC.items() if a[0] != 16}
        logits = TXT.forward(
            p, port.cfg, toks[:, :-1],
            lambda nm: {k: Q.ste_quantize_weight(w, RETRAIN_ALLOC[nm][0],
                                                 wc.get(nm, 0.0))
                        for k, w in TXT._layer_leaves(p, port.cfg,
                                                      nm).items()},
            lambda nm, x: Q.quantize_activation(
                x, RETRAIN_ALLOC[nm][1], float(ref.act_ranges[nm])))
        return TT.frame_nll(logits, toks[:, 1:])

    loss, g_port = TO.value_and_grad(port_loss, port.params, _tokens(tokens))
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    moved = 0
    for a, b, g, gp, base in zip(TO.tree_leaves(got), jax.tree.leaves(want),
                                 jax.tree.leaves(g_ref),
                                 TO.tree_leaves(g_port),
                                 jax.tree.leaves(ref.params)):
        b, g = np.asarray(b, np.float32), np.asarray(g, np.float32)
        step = (np.abs(b) * 2.0 ** -7 if a.dtype == torch.bfloat16
                else np.full_like(b, 1e-6))
        off = np.abs(_np(a.float()) - b) > step
        gap = float(np.abs(_np(gp.float()) - g).max())
        assert gap <= 0.02 * float(np.abs(g).max())
        assert (np.abs(g[off]) <= gap).all(), (np.abs(g[off]).max(), gap)
        moved += int((b != np.asarray(base, np.float32)).sum())
    assert moved > 0


def test_retrain_xlstm_three_steps_track_reference(pair, ref_loss):
    """Three steps: from the second on, the two packages' params differ by
    a bf16 step in some elements and their gradients by ~1 %, so elements
    are no longer compared one by one. Each package's beacon scores the
    same retraining loss on the next batch (rel 1e-2) under the reference's
    loss, and both moved from the base params."""
    ref, port = pair
    want, got = _retrain_both(ref, port, 3)
    got_ref = jax.tree.map(jnp.asarray, TM.params_to_numpy(got))
    tokens = _ref_batch(ref, 3)
    base, w, g = (float(ref_loss(p, tokens)[0]) for p in (ref.params, want,
                                                          got_ref))
    assert g == pytest.approx(w, rel=1e-2)
    assert w != base and g != base


def test_skip_retrains_fast_forwards_the_stream(pair):
    """The first retrain after skipping one sees exactly the batches of the
    second retrain of an unskipped stream: bitwise equal beacons."""
    _, port = pair
    alloc = {n: (4, 8) for n in port.layer_names}
    plain = port.beacon_retrainer(2)
    first, second = (plain(alloc, port.params) for _ in range(2))
    skipped = port.beacon_retrainer(2, skip_retrains=1)(alloc, port.params)
    for a, b in zip(TO.tree_leaves(skipped), TO.tree_leaves(second)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, c) for a, c in zip(
        TO.tree_leaves(skipped), TO.tree_leaves(first)))


def test_beacon_search_matches_reference(pair, monkeypatch):
    """A beacon-based search (2 retraining steps a beacon; a distance
    threshold of 12 keeps it to one retrain, as each of the reference's
    retrains compiles anew) in both packages on the reference's retraining
    batches: the same beacons, retrains, evaluations and front."""
    ref, port = pair
    calls = []

    def stream(vocab, batch, seq, *, seed, start_step=0, n_noise, device):
        calls.append((vocab, batch, seq, seed, start_step, n_noise,
                      str(device)))
        return _ref_stream(vocab, seed, start_step)

    monkeypatch.setattr(TS, "lm_batches", stream)
    kw = dict(generations=2, pop=6, initial=8, seed=0, beacons=True,
              retrain_steps=2, distance_threshold=12.0)
    want = RA.SearchSession(ref, "bitfusion", ("error", "speedup"),
                            share_memo=False).run(**kw)
    got = TA.SearchSession(port, "bitfusion", ("error", "speedup"),
                           share_memo=False).run(**kw)
    rb, tb = want.beacon_search, got.beacon_search
    assert rb.n_retrains >= 1
    assert tb.n_retrains == rb.n_retrains
    assert [b.alloc for b in tb.beacons] == [b.alloc for b in rb.beacons]
    assert calls == [(ref.cfg.vocab_size, 8, 33, 3, 0, RXT.N_NOISE, "cpu")]
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals

