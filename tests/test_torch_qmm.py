"""The port's ``quant_matmul`` path against the reference's: packing
(``pack_for_kernel``: codes and scales bitwise, bits 2/4/8), the product
(the port's plain version, which its wrapper runs for CPU tensors, against
the reference's Pallas kernel in interpret mode and its ``quant_matmul_ref``,
at rtol 1e-4 / atol 1e-3, the reference's own matmul tolerance), and the
``ValueError`` cases. Inputs are made from a seed with numpy and handed to
both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

SHAPES = [(2, 64, 256), (3, 37, 130), (128, 512, 256)]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _packed_pair(bits, k, n, clip=2.0):
    w = _rand(k * n + bits, (k, n))
    w[0, :3] = -8.0                           # the most negative codes
    rp, rs = RO.pack_for_kernel(jnp.asarray(w), bits, clip)
    tp, ts = TO.pack_for_kernel(torch.from_numpy(w), bits, clip)
    return (rp, rs), (tp, ts)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n", [(64, 256), (37, 130), (1, 3)])
def test_pack_for_kernel_bitwise(bits, k, n):
    (rp, rs), (tp, ts) = _packed_pair(bits, k, n)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    assert torch.equal(tp, torch.from_numpy(np.array(rp)))
    assert torch.equal(ts, torch.from_numpy(np.array(rs)))
    assert tp.shape[0] == -(-k * bits // 8)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_matmul_matches_reference(bits, m, k, n):
    (rp, rs), (tp, ts) = _packed_pair(bits, k, n)
    x = _rand(m + k, (m, k))
    want = np.asarray(RR.quant_matmul_ref(jnp.asarray(x), rp, rs, bits))
    if (k * bits) % 8 == 0:                   # the Pallas kernel's own rule
        kern = np.asarray(RO.quant_matmul(jnp.asarray(x), rp, rs, bits,
                                          interpret=True))
        np.testing.assert_allclose(kern, want, rtol=1e-4, atol=1e-3)
    before = TO.quant_matmul.launches
    got = TO.quant_matmul(torch.from_numpy(x), tp, ts, bits)
    assert TO.quant_matmul.launches == before    # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got, TR.quant_matmul_ref(
        torch.from_numpy(x), tp, ts, bits), rtol=0, atol=0)


def test_shape_and_packing_errors_raise_value_error():
    _, (tp, ts) = _packed_pair(4, 16, 8)
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="packing misaligned"):
        TO.quant_matmul(x, tp[:-1], ts, 4)
    with pytest.raises(ValueError, match="packing misaligned"):
        TO.quant_matmul(x, tp, ts, 2)             # 16 codes need 4 rows
    with pytest.raises(ValueError, match="bits"):
        TO.quant_matmul(x, tp, ts, 3)
    with pytest.raises(ValueError, match="scales"):
        TO.quant_matmul(x, tp, ts[:-1], 4)
    with pytest.raises(ValueError, match="x must be"):
        TO.quant_matmul(x.double(), tp, ts, 4)
    with pytest.raises(ValueError, match="packed_w"):
        TO.quant_matmul(x, tp.to(torch.int16), ts, 4)
