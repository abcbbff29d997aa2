"""The xLSTM's serving half in the port against the reference's, on
``get_config("xlstm-350m").reduced()`` (2 pairs, d_model 64, 4 heads)
with the reference's own weights (``init_lm(PRNGKey(1))``, carried across
bitwise).

Which lowering of the reference each test holds to: the step functions
(``mlstm_step``, ``slstm_step``) run op by op, as they are called here, on
the same bf16 inputs: outputs within atol 0.02 (``test_torch_lm.py``'s
primitives), f32 states within atol 1e-4. ``prefill`` and ``decode_step``
run jitted, as a server runs them: XLA feeds each norm the f32 sum of its
residual add (ROADMAP fault 7), and the port does too (``add_rms_norm``);
logits within atol 0.15, ``test_torch_lm.py``'s bound. The port's own
prefill + decode against its forward within atol 0.2 and the chunked
mLSTM against its step recurrence within atol 0.05, the reference's bounds
for the same checks (``tests/test_models_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import xlstm as RM
from repro_torch.configs import get_config
from repro_torch.models import common as TC
from repro_torch.models import registry as TREG
from repro_torch.models import xlstm as TM

B, PROMPT, GEN = 2, 7, 5


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_pair(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, TC.tensor_from_numpy(np.asarray(j), "cpu")


@pytest.fixture(scope="module")
def model():
    rcfg = ref_get_config("xlstm-350m").reduced()
    tcfg = get_config("xlstm-350m").reduced()
    rparams = RM.init_lm(jax.random.PRNGKey(1), rcfg)
    tparams = TM.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab_size, (B, PROMPT + GEN)).astype(np.int32)
    return rcfg, tcfg, rparams, tparams, tokens


def _pair(params, g=0):
    return jax.tree.map(lambda a: a[g], params["pairs"])


def _state_close(got, want, atol=1e-4):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_step_matches_reference(model, block):
    """Four steps of one block from the zero state on the same bf16
    inputs."""
    rcfg, tcfg, rparams, tparams, _ = model
    rp, tp = _pair(rparams)[block], TM.pair(tparams, 0)[block]
    r_step = getattr(RM, f"{block}_step")
    t_step = getattr(TM, f"{block}_step")
    full = TM.init_state(tcfg, B, device="cpu")[block]
    ts = {k: v[0] for k, v in full.items()}
    rs = jax.tree.map(jnp.asarray, RM.init_state(rcfg, B)[block])
    rs = jax.tree.map(lambda a: a[0], rs)
    for t in range(4):
        xj, xt = _bf16_pair(10 + t, (B, 1, rcfg.d_model))
        ry, rs = r_step(rp, rcfg, xj, rs)
        ty, ts = t_step(tp, tcfg, xt, ts)
        assert ty.dtype == torch.bfloat16 and ty.shape == (B, 1, tcfg.d_model)
        np.testing.assert_allclose(_np(ty), _np(ry), atol=0.02,
                                   err_msg=f"step {t}")
        _state_close(ts, rs)


def test_init_state_matches_reference_layout(model):
    rcfg, tcfg, _, _, _ = model
    want = RM.init_state(rcfg, 3, 16)
    got = TREG.get_model(tcfg, "cpu").init_cache(3, 16)
    assert got["cur"] == 0
    for block in ("mlstm", "slstm"):
        for k, v in want[block].items():
            assert tuple(got[block][k].shape) == v.shape, (block, k)
            assert got[block][k].dtype == torch.float32
            assert not got[block][k].any()


def test_prefill_and_decode_match_reference(model):
    """Prefill of 7 tokens, then 5 decode steps fed the same tokens, against
    the reference's jitted ``prefill`` and ``decode_step``: logits, and
    the recurrent state after prefill (atol 1e-3)."""
    rcfg, tcfg, rparams, tparams, tokens = model
    r_prefill = jax.jit(RM.prefill, static_argnums=(1,))
    r_decode = jax.jit(RM.decode_step, static_argnums=(1,))
    m = TREG.get_model(tcfg, "cpu")
    rl, rstate = r_prefill(rparams, rcfg, jnp.asarray(tokens[:, :PROMPT]))
    tl, tstate = m.prefill(tparams,
                           {"tokens": torch.from_numpy(tokens[:, :PROMPT])})
    assert tl.shape == (B, 1, tcfg.padded_vocab) and tstate["cur"] == PROMPT
    np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15)
    for block in ("mlstm", "slstm"):
        _state_close(tstate[block], rstate[block], atol=1e-3)
    for t in range(PROMPT, PROMPT + GEN):
        tok = tokens[:, t:t + 1]
        rl, rstate = r_decode(rparams, rcfg, rstate, jnp.asarray(tok))
        tl, tstate = m.decode(tparams, tstate,
                              {"token": torch.from_numpy(tok)})
        np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15,
                                   err_msg=f"position {t}")
    assert tstate["cur"] == PROMPT + GEN


def test_prefill_and_decode_agree_with_forward(model):
    """The port's prefill of 7 tokens and one decode step give its
    forward's logits at positions 6 and 7 (atol 0.2, as the reference's
    own check)."""
    _, tcfg, _, tparams, tokens = model
    toks = torch.from_numpy(tokens[:, :8])
    full = TM.forward(tparams, tcfg, toks)
    lp, state = TM.prefill(tparams, tcfg, toks[:, :7])
    ld, _ = TM.decode_step(tparams, tcfg, state, toks[:, 7:8])
    np.testing.assert_allclose(_np(lp[:, 0]), _np(full[:, 6]), atol=0.2)
    np.testing.assert_allclose(_np(ld[:, 0]), _np(full[:, 7]), atol=0.2)


def test_chunk_sizes_agree_with_the_step_recurrence(model):
    """The chunked mLSTM at chunk 4 and 12 and the step recurrence over the
    same 12 inputs agree (atol 0.05), and so do their final states."""
    _, tcfg, _, tparams, _ = model
    p = TM.pair(tparams, 0)["mlstm"]
    _, x = _bf16_pair(3, (B, 12, tcfg.d_model))
    y4, s4 = TM.mlstm_fwd(p, tcfg, x, chunk=4, return_state=True)
    y12 = TM.mlstm_fwd(p, tcfg, x, chunk=12)
    np.testing.assert_allclose(_np(y4), _np(y12), atol=0.05)
    st = {k: v[0] for k, v in TM.init_state(tcfg, B, device="cpu")[
        "mlstm"].items()}
    ys = []
    for t in range(12):
        y, st = TM.mlstm_step(p, tcfg, x[:, t:t + 1], st)
        ys.append(y)
    np.testing.assert_allclose(_np(y4), _np(torch.cat(ys, dim=1)), atol=0.05)
    # the states differ only in their stabilizer m; S * exp(m) is the same
    for k in ("S", "n"):
        shape = (B, tcfg.n_heads) + (1,) * (st[k].ndim - 2)
        np.testing.assert_allclose(
            _np(st[k] * torch.exp(st["m"]).reshape(shape)),
            _np(s4[k] * torch.exp(s4["m"]).reshape(shape)), rtol=1e-3,
            atol=1e-3)
