"""The port's CUDA kernels on the card, each against its plain PyTorch
version (scan: 1e-5; MxVs: rtol 1e-4 / atol 1e-3; the packed MxV bitwise
equal to the f32 MxV on the dequantized bank), the wrappers' launch counts
and layout checks, the SRU's and the xLSTM's kernel lanes against their
plain lanes, the training forward and retraining on the card against
the CPU, and the hybrid family's Mamba, decode and flash-style attention
on the card against the CPU lane or the dense path, with ``quant_matmul``
at its LM heads.

Every test is marked ``gpu`` and skips where no CUDA device is present.
The file imports no JAX, so it runs on a machine that has only PyTorch:
``python -m pytest -m gpu tests/test_torch_cuda.py``."""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import ops
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu
MENU = (2, 4, 8, 16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def _banks(seed, m, N, dev):
    w = _rand(seed, (m, N), 0.3)
    w[0, :3] = -w.abs().max() * 4               # the most negative codes
    trips = Q.menu_triples(MENU, lambda b: float(w.abs().max()) if b == 16
                           else Q.mmse_clip(w, b))
    w = w.to(dev)
    return Q.build_weight_bank(w, trips), Q.build_packed_weight_bank(w, trips)


@pytest.mark.parametrize("shape", [(3, 5, 7, 13), (2, 33, 9, 550)])
def test_sru_scan_kernels_match_plain(dev, shape):
    P, B, T, n = shape
    u = _rand(7, (P, B, T, 3 * n)).to(dev)
    streams = (u[..., :n], u[..., n:2 * n], u[..., 2 * n:])
    vecs = [_rand(8 + i, (n,), 0.5).to(dev) for i in range(4)]
    before = ops.sru_scan_pop.launches
    got = ops.sru_scan_pop(*streams, *vecs)
    assert ops.sru_scan_pop.launches == before + 1
    for g, w in zip(got, ref.sru_scan_pop_ref(*streams, *vecs)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    before = ops.sru_scan.launches
    single = ops.sru_scan(*(s[1] for s in streams), *vecs)
    assert ops.sru_scan.launches == before + 1
    for g, w in zip(single, got):
        assert torch.equal(g, w[1])


@pytest.mark.parametrize("n", [13, 550, 1100])
@pytest.mark.parametrize("T", [0, 1, 7, 48])
def test_scan_at_ragged_steps_matches_plain_and_its_population_lane(dev, T,
                                                                      n):
    """Streams that are column thirds of one (P, B, T, 3n) array (ld = 3n),
    at ragged T (0, 1, not a multiple of the prefetch depth): within 1e-5
    of the plain version, and a P = 1 launch bitwise equal to lane 0 of the
    P = 3 launch on the same streams."""
    P, B = 3, 2
    u = _rand(T * n + 1, (P, B, T, 3 * n)).to(dev)
    streams = (u[..., :n], u[..., n:2 * n], u[..., 2 * n:])
    vecs = [_rand(20 + i, (n,), 0.5).to(dev) for i in range(4)]
    if T:
        want = ref.sru_scan_pop_ref(*streams, *vecs)
    else:                       # the plain version's stack needs a step
        want = (u[..., :n], u[..., :n], torch.zeros(P, B, n, device=dev))
    got = ops.sru_scan_pop(*streams, *vecs)
    single = ops.sru_scan(*(s[0] for s in streams), *vecs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for g, w in zip(single, got):
        assert torch.equal(g, w[0])


# Shapes crossing each configuration's tile edges (16 and 128 rows, 64 and
# 128 columns, 16-deep K tiles: m = 17, 18, 23, 1100) and each copy width:
# N = 1650 (f32 rows 8 bytes, int8 rows 2), N = 255 (f32 4, int8 1, int16
# 2), N = 66 (f32 8, int8 2, int16 4), N = 1904 and 256 (16).
BANK_SHAPES = [(5, 70, 23, 130), (3, 64, 256, 64), (2, 1, 1, 1),
               (2, 127, 17, 1650), (3, 129, 1100, 255), (8, 16, 1100, 1904),
               (4, 7, 23, 1650), (2, 33, 18, 66), (3, 200, 40, 256)]


@pytest.mark.parametrize("P,M,m,N", BANK_SHAPES)
def test_bank_kernels_match_plain(dev, P, M, m, N):
    bank, packed = _banks(m + N, m, N, dev)
    x = _rand(P, (P, M, m)).to(dev)
    idx = torch.tensor([p % 4 for p in range(P)], dtype=torch.int32,
                       device=dev)
    mxv = ops.bank_mxv_pop(x, bank, idx)
    torch.testing.assert_close(mxv, ref.bank_mxv_pop_ref(x, bank, idx),
                               rtol=1e-4, atol=1e-3)
    qmm = ops.bank_qmm_pop(x, packed, idx)
    torch.testing.assert_close(qmm, ref.bank_qmm_pop_ref(x, packed, idx),
                               rtol=1e-4, atol=1e-3)
    assert torch.equal(qmm, ops.bank_mxv_pop(x, Q.dequant_packed_bank(packed),
                                             idx))


@pytest.mark.parametrize("P,M,m,N", [(2, 127, 17, 1650), (3, 129, 1100, 255),
                                     (8, 16, 1100, 1904), (4, 7, 23, 1650),
                                     (16, 130, 64, 200)])
def test_every_bank_config_gives_the_same_bits(dev, P, M, m, N):
    """Each tile configuration, forced, gives bitwise the output of every
    other: the per-element sum order does not depend on the tile."""
    bank, packed = _banks(m * N, m, N, dev)
    x = _rand(M + P, (P, M, m)).to(dev)
    idx = torch.tensor([(p * 3) % 4 for p in range(P)], dtype=torch.int32,
                       device=dev)
    mxv = [ops.bank_mxv_pop(x, bank, idx, config=c)
           for c in range(len(ops.BANK_CONFIGS))]
    qmm = [ops.bank_qmm_pop(x, packed, idx, config=c)
           for c in range(len(ops.BANK_CONFIGS))]
    deq = Q.dequant_packed_bank(packed)
    for c in range(len(ops.BANK_CONFIGS)):
        assert torch.equal(mxv[c], mxv[0]), c
        assert torch.equal(qmm[c], qmm[0]), c
        assert torch.equal(qmm[c], ops.bank_mxv_pop(x, deq, idx, config=c)), c
    assert ops.bank_config(P, M, N) in range(len(ops.BANK_CONFIGS))
    assert torch.equal(ops.bank_mxv_pop(x, bank, idx), mxv[0])


def test_bank_kernels_take_unaligned_base_pointers(dev):
    """x, the bank and the containers starting 4, 4 and 1 bytes past an
    alignment boundary: the wrappers narrow their copy widths, nothing is
    padded, and the result is bitwise the aligned one's."""
    P, M, m, N = 3, 40, 48, 1904
    bank, packed = _banks(11, m, N, dev)
    x = _rand(12, (P, M, m)).to(dev)
    idx = torch.tensor([3, 1, 0], dtype=torch.int32, device=dev)

    def moved(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    x_off, bank_off = moved(x), moved(bank)
    packed_off = {key: moved(t) for key, t in packed.items()}
    assert ops.copy_width(4 * N, bank.data_ptr()) == 16
    assert ops.copy_width(4 * N, bank_off.data_ptr()) == 4
    assert ops.copy_width(N, packed_off["q8"].data_ptr(),
                          widths=(16, 8, 4, 2, 1)) == 1
    for c in range(len(ops.BANK_CONFIGS)):
        want = ops.bank_mxv_pop(x, bank, idx, config=c)
        assert torch.equal(ops.bank_mxv_pop(x_off, bank_off, idx, config=c),
                           want)
        assert torch.equal(ops.bank_qmm_pop(x_off, packed_off, idx, config=c),
                           ops.bank_qmm_pop(x, packed, idx, config=c))


def test_bank_config_table_matches_the_library(dev):
    for c, cfg in enumerate(ops.BANK_CONFIGS):
        assert ops.bank_config_info(c) == cfg
    x = torch.zeros(1, 2, 3, device=dev)
    with pytest.raises(ValueError, match="config"):
        ops.bank_mxv_pop(x, torch.zeros(4, 3, 5, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev),
                         config=len(ops.BANK_CONFIGS))


# The ragged cases of earlier slices, and every M (one row tile, a ragged
# and a full second one), K (one code, a ragged last packed byte and x
# slice, the LM head's) and N (ragged inside and past one 128-column block)
QMM_SHAPES = [(4, 2048, 1000), (3, 37, 130), (9, 261, 255), (1, 1, 1)] + [
    (M, K, N) for M in (1, 4, 5, 8, 9) for K in (1, 33, 2047, 2048)
    for N in (3, 130, 1001)]


def _qmm_inputs(bits, M, K, N, dev):
    w = _rand(K + N + bits, (K, N))
    w[0, :3] = -8.0                             # the most negative codes
    packed, scales = ops.pack_for_kernel(w.to(dev), bits, 2.0)
    return _rand(M + bits, (M, K)).to(dev), packed, scales


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,K,N", QMM_SHAPES)
def test_quant_matmul_matches_plain(dev, bits, M, K, N):
    """Ragged M, N and K (K not filling the last packed byte, N not a
    multiple of 8, M past one row tile) against the plain version."""
    x, packed, scales = _qmm_inputs(bits, M, K, N, dev)
    before = ops.quant_matmul.launches
    got = ops.quant_matmul(x, packed, scales, bits)
    assert ops.quant_matmul.launches == before + 1
    torch.testing.assert_close(got, ref.quant_matmul_ref(x, packed, scales,
                                                         bits),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,K,N", [(4, 2048, 1000), (5, 33, 130),
                                   (9, 2047, 1001), (1, 1, 3)])
def test_quant_matmul_takes_an_unaligned_packed_base(dev, bits, M, K, N):
    """``packed`` starting one byte past an alignment boundary takes the
    kernel's byte loads (its ``vec == false`` path): the same result as
    the aligned copy."""
    x, packed, scales = _qmm_inputs(bits, M, K, N, dev)
    buf = torch.empty(packed.numel() + 1, dtype=torch.int8, device=dev)
    moved = buf[1:].view(packed.shape)
    moved.copy_(packed)
    assert moved.data_ptr() % 4 == 1
    got = ops.quant_matmul(x, moved, scales, bits)
    torch.testing.assert_close(got, ref.quant_matmul_ref(x, packed, scales,
                                                         bits),
                               rtol=1e-4, atol=1e-3)
    assert torch.equal(got, ops.quant_matmul(x, packed, scales, bits))


def test_lm_head_quant_matmul_is_one_resident_wave(dev):
    """By the runtime's occupancy calculator every ``quant_matmul`` launch
    fits the card, and the LM head's grid (batch 4, N = 100352) is one
    wave on this card's SMs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bits in (2, 4, 8):
        assert ops.quant_matmul_occupancy(8, 1, bits)["blocks_per_sm"] > 0
        head = ops.quant_matmul_occupancy(4, 100352, bits)
        assert head["blocks"] <= sms * head["blocks_per_sm"], (bits, head)


def test_quant_matmul_refuses_what_the_kernel_cannot_take(dev):
    packed, scales = ops.pack_for_kernel(_rand(1, (16, 8)).to(dev), 4, 1.0)
    x = _rand(2, (4, 16)).to(dev)
    with pytest.raises(ValueError, match="packing misaligned"):
        ops.quant_matmul(x, packed[:-1].contiguous(), scales, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.quant_matmul(x.T.contiguous().T, packed, scales, 4)
    with pytest.raises(ValueError, match="expected"):
        ops.quant_matmul(x, packed.cpu(), scales, 4)


def test_wrappers_refuse_what_the_kernels_cannot_take(dev):
    bank, packed = _banks(1, 6, 5, dev)
    x = _rand(2, (3, 4, 6)).to(dev)
    idx = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops.bank_mxv_pop(x.transpose(1, 2).contiguous().transpose(1, 2),
                         bank, idx)
    with pytest.raises(ValueError):
        ops.bank_mxv_pop(x, bank, idx.long())
    with pytest.raises(ValueError):
        ops.bank_qmm_pop(x, {**packed, "q4": packed["q4"][:-1]}, idx)
    with pytest.raises(ValueError):
        ops.bank_mxv_pop(x, bank.cpu(), idx)
    u = _rand(3, (1, 2, 3, 12)).to(dev)
    v = torch.zeros(4, device=dev)
    with pytest.raises(ValueError):
        ops.sru_scan_pop(u[..., :4], u[..., 4:8], u[..., 8:].transpose(1, 2)
                         .contiguous().transpose(1, 2), v, v, v, v)


def test_out_of_range_menu_index_poisons_its_lane(dev):
    bank, _ = _banks(4, 8, 9, dev)
    x = _rand(5, (2, 3, 8)).to(dev)
    out = ops.bank_mxv_pop(x, bank, torch.tensor([1, 7], dtype=torch.int32,
                                                 device=dev))
    assert torch.isnan(out[1]).all()
    torch.testing.assert_close(out[0], x[0] @ bank[1], rtol=1e-4, atol=1e-3)


def test_served_step_equals_scalar_forward_bitwise(dev):
    """The scalar ``forward(qp=)`` runs its MxVs through the bank kernel
    with P = 1, so each lane of a packed-bank decode step (``bank_qmm_pop``,
    ``sru_scan_pop``) equals the scalar forward on its chunk bit for bit,
    ragged chunk lengths included."""
    from repro_torch.core import batched_eval as B
    from repro_torch.core import sru_experiment as X
    from repro_torch.models import sru
    cfg = sru.SRUModelConfig(name="tiny", input_dim=5, hidden=40, proj=24,
                             n_sru_layers=3, n_outputs=33)
    target = X.build_untrained_sru(cfg, seed=0, device=dev)
    names = list(cfg.layer_names())
    qps = [target.qp_for({nm: (b, 8) for nm in names}) for b in MENU]
    stack = torch.as_tensor(np.asarray(B.stack_qps(qps, names), np.float32),
                            device=dev)
    banks = target.make_packed_banks(target.params)
    for T in (16, 5):
        feats = _rand(T, (4, T, 5)).to(dev)
        served = sru.forward_decode_step(target.params, cfg, feats, stack,
                                         banks=banks)
        for lane, qp in enumerate(qps):
            scalar = sru.forward(target.params, cfg, feats[lane][None],
                                 qp=qp)[0]
            assert torch.equal(served[lane], scalar), (T, lane)


def test_model_kernel_lane_matches_plain_lane(dev):
    """A tiny SRU on the card: the kernel lane (CUDA kernels) and the plain
    lane give the same logits within the matmul tolerance, for f32 banks
    with the u-bank, packed banks and per-lane requantization."""
    from repro_torch.core import sru_experiment as X
    from repro_torch.models import sru
    cfg = sru.SRUModelConfig(name="tiny", input_dim=5, hidden=40, proj=24,
                             n_sru_layers=3, n_outputs=33)
    target = X.build_untrained_sru(cfg, seed=0, device=dev)
    names = list(cfg.layer_names())
    rng = np.random.default_rng(0)
    allocs = [{nm: (int(rng.choice(MENU)), int(rng.choice(MENU)))
               for nm in names} for _ in range(6)]

    def logits(use_kernel, use_banks=True, bank_format="f32"):
        ev = target.batched_evaluator(use_banks, bank_format, use_kernel)
        return sru.forward_population(
            target.params, cfg, ev._feats_all, ev._stack(allocs),
            banks=ev._banks_for(target.params), use_kernel=use_kernel)

    for kw in ({}, {"bank_format": "packed"}, {"use_banks": False}):
        before = ops.launch_counts()
        got = logits(True, **kw)
        after = ops.launch_counts()
        assert after["sru_scan_pop"] == before["sru_scan_pop"] + 6
        assert sum(after.values()) > sum(before.values()) + 6
        torch.testing.assert_close(got, logits(False, **kw), rtol=1e-4,
                                   atol=1e-3)


def test_training_forward_and_retrain_on_the_card(dev):
    """``forward(qspec=)`` on the card (``torch.matmul`` and the time-step
    loop; no custom kernel): the retraining loss within rtol 1e-5 of the
    CPU's and each gradient leaf within 1e-4 of its largest |gradient|; then
    three ``retrain_sru`` steps give finite params with v and b unchanged."""
    from repro_torch.core import sru_experiment as X
    from repro_torch.data import synthetic as S
    from repro_torch.models import sru
    from repro_torch.training import optimizer as opt
    from repro_torch.training import qat
    cfg = sru.SRUModelConfig(name="tiny", input_dim=5, hidden=40, proj=24,
                             n_sru_layers=3, n_outputs=33)
    target = X.build_untrained_sru(cfg, seed=0, device="cpu")
    alloc = {nm: (b, a) for nm, b, a in zip(
        cfg.layer_names(), (16, 8, 4, 2, 8, 4), (8, 4, 16, 8, 2, 4))}
    wclips = {n: target.wclips[(n, a[0])] for n, a in alloc.items()
              if a[0] != 16}
    batch = S.speech_batch(target.task, 8, 48, seed=3, device="cpu")

    def loss_fn(p, feats, labels):
        return qat.frame_nll(sru.forward(p, cfg, feats, qspec=alloc,
                                         wclips=wclips,
                                         act_ranges=target.act_ranges),
                             labels)

    on_card = sru.params_from_numpy(sru.params_to_numpy(target.params), dev)
    want_loss, want_g = opt.value_and_grad(loss_fn, target.params,
                                           batch["feats"], batch["labels"])
    got_loss, got_g = opt.value_and_grad(loss_fn, on_card,
                                         batch["feats"].to(dev),
                                         batch["labels"].to(dev))
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    for g, w in zip(opt.tree_leaves(got_g), opt.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
    beacon = qat.retrain_sru(
        on_card, cfg, alloc, S.speech_batches(target.task, 8, 48, seed=3,
                                              device=dev),
        steps=3, act_ranges=target.act_ranges, wclips=wclips)
    for leaf in opt.tree_leaves(beacon):
        assert leaf.is_cuda and torch.isfinite(leaf).all()
    for i in range(cfg.n_sru_layers):
        for d in ("fwd", "bwd"):
            for k in ("v", "b"):
                assert torch.equal(beacon[f"L{i}"][d][k],
                                   on_card[f"L{i}"][d][k])


def test_xlstm_kernel_lane_matches_plain_lane(dev):
    """The xLSTM target at its CPU search config, random weights, on the
    card: one ``bank_mxv_pop`` launch per MxV (5 a mLSTM block, 2 plus one
    per time step an sLSTM block, 1 for the head), and the smoke script's
    lane comparison (``chip_smoke.compare_xlstm_lanes``): every MxV call
    of every leaf on the path's inputs within rtol 1e-4 / atol 1e-3 of its
    plain version, no lane parting before its first block, an argmax differing
    only below its lane's logit gap, and a lane flip that moves no other
    lane. The requant lane launches the kernel too."""
    import chip_smoke as C
    from repro_torch.core import xlstm_target as XT
    from repro_torch.models import xlstm
    cfg = XT.search_config()
    target = XT.target_from_params(cfg, xlstm.init_lm(0, cfg, dev),
                                   device=dev, val_batch=4, val_seq=16)
    rng = np.random.default_rng(0)
    allocs = [{nm: (int(rng.choice(MENU)), int(rng.choice(MENU)))
               for nm in target.layer_names} for _ in range(8)]
    ev = target.batched_evaluator()
    T, G = ev._feats_all.shape[1], cfg.n_layers // 2
    for banks in (ev._banks_for(target.params), None):
        before = ops.launch_counts()["bank_mxv_pop"]
        XT.forward_population(target.params, cfg, ev._feats_all,
                              ev._stack(allocs), banks=banks)
        assert ops.launch_counts()["bank_mxv_pop"] - before == \
            G * (7 + T) + 1
    st = C.compare_xlstm_lanes(target, allocs)
    assert st["lanes"] == 8 and st["lane_flip"]["others_bitwise_equal"]
    assert len(st["path_mxv_max_abs_err"]) == G * 8 + 1
    assert max(st["path_mxv_max_abs_err"].values()) <= 1e-3


def test_checkpointed_beacon_search_resumes_on_the_card(dev, tmp_path):
    """A beacon search on the card, checkpointed, cut back to the first
    generation that holds a retrain and resumed in-process: the same
    front, evaluations, retrains and beacon digests as the uninterrupted
    run, the restored beacons' params on the card."""
    from repro_torch.core import checkpointing as ckpt
    from repro_torch.core import durable_io as dio
    from repro_torch.core import sru_experiment as X
    from repro_torch.core.api import SearchSession
    from repro_torch.core.hardware import get_platform
    from repro_torch.models import sru
    cfg = sru.SRUModelConfig(name="tiny", input_dim=5, hidden=8, proj=6,
                             n_sru_layers=3, n_outputs=7)
    target = X.train_small_sru(60, cfg=cfg, batch=4, seq=24, device=dev)
    sram = int((sum(target.layer_weights.values()) * 8.0
                + target.vector_weights * 16) / 8)
    kw = dict(generations=4, pop=6, initial=8, seed=0, beacons=True,
              retrain_steps=3, distance_threshold=4.0)

    def session():
        return SearchSession(target, "bitfusion", ("error", "speedup"),
                             sram_override=sram)

    def digests(res):
        return [dio.tree_digest(b.params) for b in res.beacon_search.beacons]

    want = session().run(**kw)
    d = str(tmp_path / "store")
    full = session().run(checkpoint_dir=d, **kw)
    assert full.front_key() == want.front_key()
    assert digests(full) == digests(want)
    assert want.beacon_search.n_retrains >= 1
    key = ckpt.search_key(target, get_platform("bitfusion"), 0,
                          sram_bytes=sram)
    settings = {"generations": 4, "pop": 6, "initial": 8,
                "objectives": ["error", "speedup"], "beacons": True,
                "retrain_steps": 3, "distance_threshold": 4.0}
    store = ckpt.SearchStore(d)

    def retrains_at(g):
        path = os.path.join(store.dir_for(key, settings),
                            f"gen_{g:05d}.ckpt")
        state, _ = ckpt.deserialize_state(dio.read_checksummed(path),
                                          target.params)
        return state.n_retrains
    cut = min(g for g in store.generations(key, settings)
              if retrains_at(g) >= 1)
    assert cut < kw["generations"]
    store.discard_after(key, settings, cut)
    mid = store.load_latest(key, settings, target.params)
    assert mid.next_gen == cut
    assert all(leaf.device.type == dev.type for p in mid.beacon_params
               for leaf in dio.flatten_tree(p).values())
    got = session().run(checkpoint_dir=d, resume=True, **kw)
    assert got.front_key() == want.front_key()
    assert got.n_evals == want.n_evals
    assert got.beacon_search.n_retrains == want.beacon_search.n_retrains
    assert digests(got) == digests(want)


def _reduced_moe(arch="qwen2-moe-a2.7b"):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch).reduced()
    return cfg, tfm.init_lm(0, cfg, "cpu")


def _to(tree, dev):
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def test_moe_ffn_on_the_card_matches_cpu(dev):
    """One layer's MoE FFN (reduced qwen2-moe: top-2 of 4 experts, a shared
    expert, two groups of 24 tokens) on the card against the same call on
    the CPU: the same routing, and the output within atol 0.02 (the CPU
    tests' bound against the reference)."""
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    cfg, params = _reduced_moe()
    p = tfm.layer(params["blocks"], 0)["ffn"]
    x = _rand(3, (2, 24, cfg.d_model)).to(torch.bfloat16)
    got = cm.moe_ffn(_to(p, dev), x.to(dev), top_k=cfg.top_k,
                     group_size=24)
    want = cm.moe_ffn(p, x, top_k=cfg.top_k, group_size=24)
    gates = [torch.softmax(x.to(d).float() @ p["router"].to(d), -1)
             for d in (dev, "cpu")]
    picks = [torch.topk(g, cfg.top_k, -1).indices.sort(-1).values.cpu()
             for g in gates]
    assert torch.equal(picks[0], picks[1])
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0,
                               atol=0.02)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_on_the_card_is_bitwise(dev, bits):
    """``quantize_tree`` and ``dequantize_tree`` of the reduced qwen2-moe's
    params on the card give the CPU's bits: codes, scales and weights."""
    cfg, params = _reduced_moe()
    spec = Q.tree_spec(params)
    want = Q.quantize_tree(params, bits)
    got = Q.quantize_tree(_to(params, dev), bits)
    from repro_torch.training.optimizer import tree_leaves as leaves
    flat_w = Q.dequantize_tree(want, spec, bits)
    flat_g = Q.dequantize_tree(got, spec, bits)
    for a, b in zip(leaves(got) + leaves(flat_g), leaves(want) + leaves(flat_w)):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)


def test_launch_train_resumes_on_the_card(dev, tmp_path, capsys):
    """``launch.train`` on the card (reduced granite-moe, 6 steps,
    checkpoints at 3 and 6). With step 6's checkpoint deleted, a second run
    resumes from step 3 and ends at the first run's final loss and step-6
    state, bit for bit (the card's products are deterministic at fixed
    shapes)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.registry import get_model
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--batch", "4",
            "--seq", "16", "--log-every", "1", "--device", "cuda",
            "--steps", "6", "--ckpt-dir", ckpt, "--ckpt-every", "3"]
    full = train.main(argv)
    template = ts.init_train_state(
        get_model(get_config("granite-moe-1b-a400m").reduced(), dev), 0)
    want, _ = ck.restore(ckpt, template)
    shutil.rmtree(os.path.join(ckpt, "step_00000006"))
    capsys.readouterr()
    resumed = train.main(argv)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert np.isfinite(full) and resumed == full
    got, step = ck.restore(ckpt, template)
    assert step == 6
    for a, b in zip(opt.tree_leaves(got), opt.tree_leaves(want)):
        assert a.device.type == "cuda" and torch.equal(a, b)


# ------------------------------------------------ the hybrid and its heads

def _reduced_hybrid():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config("jamba-1.5-large-398b").reduced()
    return cfg, tfm.init_lm(0, cfg, "cpu")


def test_mamba_on_the_card_matches_cpu(dev):
    """A reduced Mamba mixer (d_inner 128, N 8, chunks of 8) over 21 steps
    (a padded last chunk), then two decode steps, on the card against the
    CPU lane: outputs within atol 0.05 (the reference's Mamba bound), the
    f32 state within 1e-5."""
    from repro_torch.models import mamba as mb
    from repro_torch.models import transformer as tfm
    cfg, params = _reduced_hybrid()
    p = tfm.mamba_layer(params["mamba_blocks"], 1, 0)["mamba"]
    x = _rand(4, (2, 23, cfg.d_model)).to(torch.bfloat16)
    want, st = mb.mamba_fwd(p, cfg, x[:, :21], return_state=True)
    got, gst = mb.mamba_fwd(_to(p, dev), cfg, x[:, :21].to(dev),
                            return_state=True)
    for t in (21, 22):
        w, st = mb.mamba_step(p, cfg, x[:, t:t + 1], st)
        g, gst = mb.mamba_step(_to(p, dev), cfg, x[:, t:t + 1].to(dev), gst)
        want, got = torch.cat([want, w], 1), torch.cat([got, g], 1)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0,
                               atol=0.05)
    torch.testing.assert_close(gst["h"].cpu(), st["h"], rtol=1e-4, atol=1e-5)


def test_hybrid_decode_on_the_card_matches_cpu(dev, monkeypatch):
    """The reduced jamba (two groups of a Mamba and an attention block, 4
    experts top-2) at ``MOE_CAPACITY_FACTOR`` 8.0 (no token dropped): an
    8-token prefill and 3 decode steps on the card against the CPU lane,
    logits within atol 0.15 (the CPU tests' logit bound)."""
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(cm, "MOE_CAPACITY_FACTOR", 8.0)
    cfg, params = _reduced_hybrid()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 11)))
    want, cache = tfm.prefill(params, cfg, toks[:, :8], max_len=11)
    got, gcache = tfm.prefill(_to(params, dev), cfg, toks[:, :8].to(dev),
                              max_len=11)
    for t in range(8, 11):
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0,
                                   atol=0.15)
        want, cache = tfm.decode_step(params, cfg, cache, toks[:, t:t + 1])
        got, gcache = tfm.decode_step(_to(params, dev), cfg, gcache,
                                      toks[:, t:t + 1].to(dev))
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0,
                               atol=0.15)
    assert gcache["ssm"]["h"].device.type == "cuda"


@pytest.mark.parametrize("causal", [True, False])
def test_flash_branch_on_the_card_matches_dense(dev, causal):
    """The flash-style branch (forced by ``dense_max`` 256; 600 queries and
    keys: two q-chunks of 512 and one kv-chunk of 1,024, both padded)
    against the dense path on the card, atol 0.02."""
    from repro_torch.models import common as cm
    q = _rand(6, (2, 600, 8, 64)).to(torch.bfloat16).to(dev)
    k = _rand(7, (2, 600, 2, 64)).to(torch.bfloat16).to(dev)
    v = _rand(8, (2, 600, 2, 64)).to(torch.bfloat16).to(dev)
    flash = cm.gqa_attention(q, k, v, causal=causal, dense_max=256)
    dense = cm.gqa_attention(q, k, v, causal=causal)
    torch.testing.assert_close(flash.float(), dense.float(), rtol=0,
                               atol=0.02)


@pytest.mark.parametrize("M,K,N", [(1, 8192, 65536), (4, 6144, 92672)])
def test_quant_matmul_at_the_family_heads(dev, M, K, N):
    """``quant_matmul`` int8 at jamba's and internvl2-26b's LM heads
    against its plain version (rtol 1e-4 / atol 1e-3), one launch."""
    g = torch.Generator(device=dev).manual_seed(M)
    w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
    packed, scales = ops.pack_for_kernel(w, 8, float(w.abs().max()))
    x = torch.randn((M, K), generator=g, device=dev)
    before = ops.quant_matmul.launches
    got = ops.quant_matmul(x, packed, scales, 8)
    assert ops.quant_matmul.launches == before + 1
    torch.testing.assert_close(got, ref.quant_matmul_ref(x, packed, scales,
                                                         8),
                               rtol=1e-4, atol=1e-3)
