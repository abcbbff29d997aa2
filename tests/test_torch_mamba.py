"""The port's Mamba block (``models/mamba.py``) against the reference's,
on the reduced jamba-1.5-large-398b (d_model 64, d_inner 128, N 8, chunk
8, conv 4) with the reference's own ``init_mamba(PRNGKey(0))`` weights
carried across bitwise.

Tolerances: block outputs within atol 0.05 (the reference's Mamba bound,
``tests/test_models_smoke.py``); the f32 state ``h`` within rtol 1e-4 /
atol 1e-5 (the reference's ``associative_scan`` and the port's
Hillis-Steele scan pair the products in other trees); the conv tail, a
copy of bf16 inputs, within a bf16 step (atol 0.02). The port's conv and
SiLU round every bf16 operation as XLA does, so on these inputs the
outputs are in fact bitwise the reference's, jitted or not. The reference
runs jitted (one compile a shape: op by op, its ``lax.scan`` compiles at
every call); ``test_jitted_reference_rounds_the_conv_as_op_by_op`` shows
that jitting changes none of its bits. The hybrid's Mamba block is held
to the reference in ``test_torch_hybrid.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba as RM
from repro_torch.configs import get_config
from repro_torch.models import common as TC
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as TT

ARCH = "jamba-1.5-large-398b"
R_FWD = jax.jit(RM.mamba_fwd, static_argnums=(1,),
                static_argnames=("return_state",))
R_STEP = jax.jit(RM.mamba_step, static_argnums=(1,))


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(
        t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_pair(seed, shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, TC.tensor_from_numpy(np.asarray(j), "cpu")


@pytest.fixture(scope="module")
def mamba():
    rcfg = ref_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    rp = RM.init_mamba(jax.random.PRNGKey(0), rcfg)
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, tcfg, rp, tp


def _state_close(got, want):
    np.testing.assert_allclose(_np(got["h"]), _np(want["h"]), rtol=1e-4,
                               atol=1e-5)
    assert got["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got["conv"]), _np(want["conv"]),
                               atol=0.02)


def test_params_and_axes_cross_in_the_reference_layout(mamba):
    rcfg, tcfg, rp, tp = mamba
    own = TT.params_to_numpy(TM.init_mamba(torch.Generator().manual_seed(0),
                                           tcfg))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), own) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), rp)
    assert np.array_equal(own["A_log"], np.asarray(rp["A_log"]))
    assert TM.MAMBA_AXES == RM.mamba_axes()
    back = TT.params_to_numpy(tp)
    for k, v in rp.items():
        assert np.array_equal(back[k].view(np.uint8),
                              np.asarray(v).view(np.uint8)), k


@pytest.mark.parametrize("T", [16, 13, 1])
def test_mamba_fwd_matches_reference(mamba, T):
    """T = 16 is two chunks of 8, T = 13 pads the second chunk with 3 steps
    (dt = 0: the state passes them unchanged), T = 1 is one short chunk.
    The port with and without ``return_state`` against the reference's
    output and final state."""
    rcfg, tcfg, rp, tp = mamba
    hj, ht = _bf16_pair(T, (2, T, rcfg.d_model))
    want, want_st = R_FWD(rp, rcfg, hj, return_state=True)
    got, got_st = TM.mamba_fwd(tp, tcfg, ht, return_state=True)
    _state_close(got_st, want_st)
    assert got_st["h"].shape == (2, rcfg.ssm_d_inner, rcfg.ssm_d_state)
    assert got_st["conv"].shape == (2, rcfg.ssm_d_conv - 1, rcfg.ssm_d_inner)
    plain = TM.mamba_fwd(tp, tcfg, ht)
    assert torch.equal(plain, got)
    assert got.dtype == torch.bfloat16 and got.shape == (2, T, rcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=0.05)


def test_jitted_reference_rounds_the_conv_as_op_by_op(mamba):
    """The conv's bf16 chain and its SiLU: the reference gives the same
    bits jitted and op by op, and the port gives those bits."""
    rcfg, tcfg, rp, tp = mamba
    xj, xt = _bf16_pair(5, (3, 24, rcfg.ssm_d_inner), 3.0)
    eager, _ = RM._causal_conv(rp, rcfg, xj)
    jitted, _ = jax.jit(lambda p, x: RM._causal_conv(p, rcfg, x))(rp, xj)
    got, tail = TM._causal_conv(tp, tcfg, xt)
    assert np.array_equal(_np(eager), _np(jitted))
    assert np.array_equal(_np(got), _np(eager))
    assert torch.equal(tail, xt[:, -(rcfg.ssm_d_conv - 1):])


def test_mamba_step_matches_reference(mamba):
    """Three decode steps from a prefill state, each against the
    reference's step on the reference's state."""
    rcfg, tcfg, rp, tp = mamba
    hj, ht = _bf16_pair(3, (2, 16, rcfg.d_model))
    _, rst = R_FWD(rp, rcfg, hj[:, :13], return_state=True)
    _, tst = TM.mamba_fwd(tp, tcfg, ht[:, :13], return_state=True)
    for t in range(13, 16):
        want, rst = R_STEP(rp, rcfg, hj[:, t:t + 1], rst)
        got, tst = TM.mamba_step(tp, tcfg, ht[:, t:t + 1], tst)
        assert got.shape == (2, 1, rcfg.d_model)
        np.testing.assert_allclose(_np(got), _np(want), atol=0.05)
        _state_close(tst, rst)


@pytest.mark.parametrize("T", [16, 21])
def test_chunked_equals_stepped(mamba, T):
    """``mamba_fwd`` against T ``mamba_step``s from a zero state, within
    the reference's bound (atol 0.05), with the same final state."""
    _, tcfg, _, tp = mamba
    _, ht = _bf16_pair(7, (2, T, tcfg.d_model))
    full, fst = TM.mamba_fwd(tp, tcfg, ht, return_state=True)
    st = {"h": torch.zeros_like(fst["h"]),
          "conv": torch.zeros_like(fst["conv"])}
    for t in range(T):
        y, st = TM.mamba_step(tp, tcfg, ht[:, t:t + 1], st)
        np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, t]), atol=0.05)
    _state_close(st, fst)


@pytest.mark.parametrize("c", [1, 5, 8, 256])
def test_scan_chunk_is_the_sequential_recurrence(c):
    rng = np.random.default_rng(c)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, c, 3, 4)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, c, 3, 4)).astype(
        np.float32))
    a_cum, b_cum = TM._scan_chunk(a, b)
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    h = h0
    for t in range(c):
        h = a[:, t] * h + b[:, t]
        torch.testing.assert_close(a_cum[:, t] * h0 + b_cum[:, t], h,
                                   rtol=1e-5, atol=1e-6)
