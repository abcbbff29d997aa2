"""The port's kernels: each plain version (``repro_torch.kernels.ref``)
against the reference's Pallas kernel in interpret mode (the scans: against
its plain oracle, see below), at small ragged shapes, with the reference's
own tolerances (1e-5 for the scan, rtol 1e-4 / atol 1e-3 for the
matmuls); and the wrappers' CPU dispatch and layout checks. The CUDA
kernels' own tests are in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import quantization as RQ
from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

MENU = (2, 4, 8, 16)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _scan_inputs(seed, P, B, T, n):
    uw, uf, ur = (_rand(seed + i, (P, B, T, n)) for i in range(3))
    vecs = [_rand(seed + 3 + i, (n,), 0.5) for i in range(4)]
    return (uw, uf, ur), vecs


def _packed_bank(seed, m, N):
    w = _rand(seed, (m, N), 0.3)
    w[0, :3] = -np.abs(w).max() * 4           # the most negative codes
    trips = RQ.menu_triples(MENU, lambda b: float(np.abs(w).max()) if b == 16
                            else RQ.mmse_clip(w, b))
    return w, trips


# The reference's Pallas scan bodies (sru_scan.py:_sru_kernel/_sru_kernel_pop)
# call ``pl.load``, which the installed JAX no longer has, so they cannot run
# in interpret mode here (the reference's own TestSRUScan cases fail the same
# way). The scans are held to the reference's plain oracle instead, the
# function its kernel tests hold the kernels to.

@pytest.mark.parametrize("shape", [(3, 5, 7, 13), (1, 2, 4, 9)])
def test_sru_scan_pop_plain_vs_reference(shape):
    (uw, uf, ur), vecs = _scan_inputs(sum(shape), *shape)
    h_t, r_t, c_t = TR.sru_scan_pop_ref(
        *(torch.from_numpy(a) for a in (uw, uf, ur, *vecs)))
    for lane in range(shape[0]):
        h_r, r_r, c_r = RR.sru_scan_ref(
            *(jnp.asarray(a[lane]) for a in (uw, uf, ur)),
            *(jnp.asarray(v) for v in vecs))
        for got, want in ((h_t, h_r), (r_t, r_r), (c_t, c_r)):
            np.testing.assert_allclose(got[lane].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_sru_scan_single_lane_plain_vs_reference():
    (uw, uf, ur), vecs = _scan_inputs(11, 1, 5, 6, 11)
    got = TR.sru_scan_ref(
        *(torch.from_numpy(a) for a in (uw[0], uf[0], ur[0], *vecs)))
    want = RR.sru_scan_ref(*(jnp.asarray(a) for a in (uw[0], uf[0], ur[0],
                                                      *vecs)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("P,M,m,N", [(5, 7, 23, 37), (2, 9, 6, 5)])
def test_bank_mxv_pop_plain_vs_pallas(P, M, m, N):
    w, trips = _packed_bank(M + m, m, N)
    bank = np.asarray(RQ.build_weight_bank(jnp.asarray(w), trips))
    x = _rand(P, (P, M, m))
    idx = (np.arange(P) % 4).astype(np.int32)
    ref = RO.bank_mxv_pop(jnp.asarray(x), jnp.asarray(bank), jnp.asarray(idx),
                          interpret=True)
    got = TR.bank_mxv_pop_ref(torch.from_numpy(x), torch.from_numpy(bank),
                              torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("P,M,m,N", [(5, 7, 23, 37), (4, 3, 6, 5)])
def test_bank_qmm_pop_plain_vs_pallas(P, M, m, N):
    w, trips = _packed_bank(3 * m, m, N)
    packed_r = RQ.build_packed_weight_bank(jnp.asarray(w), trips)
    packed_t = TQ.build_packed_weight_bank(torch.from_numpy(w), trips)
    x = _rand(P + 1, (P, M, m))
    idx = (np.arange(P)[::-1] % 4).astype(np.int32)
    ref = RO.bank_qmm_pop(jnp.asarray(x), packed_r, jnp.asarray(idx),
                          interpret=True)
    got = TR.bank_qmm_pop_ref(torch.from_numpy(x), packed_t,
                              torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)
    # the packed MxV is the f32 MxV on the dequantized bank, exactly
    assert torch.equal(got, TR.bank_mxv_pop_ref(
        torch.from_numpy(x), TQ.dequant_packed_bank(packed_t),
        torch.from_numpy(idx)))


def test_wrappers_run_plain_versions_on_cpu_without_counting():
    TO.reset_launch_counts()
    (uw, uf, ur), vecs = _scan_inputs(1, 2, 3, 4, 5)
    args = [torch.from_numpy(a) for a in (uw, uf, ur, *vecs)]
    h, r, c = TO.sru_scan_pop(*args)
    assert torch.equal(h, TR.sru_scan_pop_ref(*args)[0])
    w, trips = _packed_bank(2, 6, 5)
    packed = TQ.build_packed_weight_bank(torch.from_numpy(w), trips)
    bank = TQ.build_weight_bank(torch.from_numpy(w), trips)
    x = torch.from_numpy(_rand(3, (4, 3, 6)))
    idx = torch.arange(4, dtype=torch.int32)
    assert torch.equal(TO.bank_step(x, packed, idx),
                       TR.bank_qmm_pop_ref(x, packed, idx))
    assert torch.equal(TO.bank_step(x, bank, idx),
                       TR.bank_mxv_pop_ref(x, bank, idx))
    qw, qs = TO.pack_for_kernel(torch.from_numpy(w), 4, 1.0)
    x2 = torch.from_numpy(_rand(4, (3, 6)))
    assert torch.equal(TO.quant_matmul(x2, qw, qs, 4),
                       TR.quant_matmul_ref(x2, qw, qs, 4))
    assert TO.launch_counts() == {"sru_scan_pop": 0, "sru_scan": 0,
                                  "bank_mxv_pop": 0, "bank_qmm_pop": 0,
                                  "quant_matmul": 0}


def test_stream_layout_check():
    """The scan wrapper takes column slices of one (..., 3n) array in place
    and refuses layouts the kernel cannot address."""
    u = torch.zeros(2, 3, 4, 15)
    assert TO._stream_ld(u[..., 5:10], (2, 3, 4, 5)) == 15
    assert TO._stream_ld(u[..., :5].contiguous(), (2, 3, 4, 5)) == 5
    assert TO._stream_ld(u[0, :, :, :5][None], (1, 3, 4, 5)) == 15
    with pytest.raises(ValueError):
        TO._stream_ld(u.transpose(1, 2)[..., :5], (2, 4, 3, 5))
    with pytest.raises(ValueError):
        TO._stream_ld(u[..., ::3], (2, 3, 4, 5))
