"""The port's encoder-decoder (audio) family against the reference's, on
the reduced seamless-m4t-medium (4 encoder and 2 decoder layers, d_model
64) with the reference's own ``init_lm(PRNGKey(0))`` weights carried
across bitwise, and the audio family's ``input_specs`` and
``make_dummy_batch``.

Tolerances: the encoder's output (4 blocks and a norm, values up to ~4)
within atol 0.05, the reference's bound for hidden states
(``tests/test_models_smoke.py``; each block is one bf16 step off at most
on the same input); logits within atol 0.15 (the port's logit bound); the
loss within rel 2e-3. Gradients, leaf by leaf: an element whose gradient
has the other sign than the reference's (one that Adam's first step
moves the other way) has a reference gradient within 2 % of its leaf's
largest, the bf16 floor of ``tests/test_torch_train_step.py``; and no
element is further off than 5 % of that largest, 2.5 times the
reference's own spread between its jitted and op-by-op gradients on this
fixture (up to 1.9 %; the port reads up to 3 %). The reference runs
jitted, its weights too (one compile a function)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.configs import get_config as ref_get_config
from repro.models import encdec as RE
from repro.models import registry as RREG
from repro_torch.configs import base as TB
from repro_torch.configs import get_config
from repro_torch.models import common as TC
from repro_torch.models import encdec as TE
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as TO

ARCH = "seamless-m4t-medium"
B, T_ENC, T_DEC = 2, 12, 10


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(
        t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def audio():
    rcfg = ref_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    rparams = jax.jit(RE.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(2)
    frames = jnp.asarray(rng.standard_normal(
        (B, T_ENC, rcfg.frontend_dim)).astype(np.float32)).astype(
        jnp.bfloat16)
    tokens = rng.integers(0, rcfg.vocab_size, (B, T_DEC + 1)).astype(
        np.int32)
    batch = {"frames": frames, "dec_tokens": tokens[:, :-1],
             "labels": tokens[:, 1:]}
    tbatch = {"frames": TC.tensor_from_numpy(np.asarray(frames), "cpu"),
              "dec_tokens": torch.from_numpy(tokens[:, :-1]),
              "labels": torch.from_numpy(tokens[:, 1:])}
    return rcfg, tcfg, rparams, tparams, batch, tbatch


def test_params_cross_both_ways(audio):
    rcfg, tcfg, rparams, tparams, _, _ = audio
    assert tparams["dec"]["xattn"]["wk"].shape == (
        rcfg.n_dec_layers, rcfg.d_model, rcfg.n_kv_heads, rcfg.head_dim)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), rparams)
    own = TT.params_to_numpy(TE.init_lm(0, tcfg, "cpu"))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        own) == shapes
    back = TT.params_to_numpy(tparams)
    same = jax.tree.map(lambda a, b: np.array_equal(
        np.asarray(a).view(np.uint8), b.view(np.uint8)), rparams, back)
    assert all(jax.tree.leaves(same))


def test_encode_and_forward_match_reference(audio):
    rcfg, tcfg, rparams, tparams, batch, tbatch = audio
    enc = jax.jit(RE.encode, static_argnums=(1,))(rparams, rcfg,
                                                  batch["frames"])
    got = TE.encode(tparams, tcfg, tbatch["frames"])
    assert got.dtype == torch.bfloat16 and got.shape == enc.shape
    np.testing.assert_allclose(_np(got), _np(enc), atol=0.05)
    want = jax.jit(RE.forward, static_argnums=(1,))(
        rparams, rcfg, batch["frames"], jnp.asarray(batch["dec_tokens"]))
    logits = TE.forward(tparams, tcfg, tbatch["frames"],
                        tbatch["dec_tokens"])
    assert logits.shape == want.shape == (B, T_DEC, rcfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), _np(want), atol=0.15)


def test_loss_and_gradients_match_reference(audio):
    rcfg, tcfg, rparams, tparams, batch, tbatch = audio
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        RREG.get_model(rcfg).loss))(rparams, batch)
    t_loss, t_grads = TO.value_and_grad(TREG.get_model(tcfg, "cpu").loss,
                                        tparams, tbatch)
    assert float(t_loss) == pytest.approx(float(r_loss), rel=2e-3)
    flat_r = jax.tree.leaves(jax.tree.map(_np, r_grads))
    flat_t = [_np(g) for g in TO.tree_leaves(t_grads)]
    assert len(flat_r) == len(flat_t)
    for want, got in zip(flat_r, flat_t):
        assert got.shape == want.shape
        top = np.abs(want).max()
        flipped = np.sign(got) != np.sign(want)
        assert (np.abs(want[flipped]) <= 0.02 * top).all()
        assert np.abs(got - want).max() <= 0.05 * top


def test_prefill_and_decode_match_reference(audio):
    """``Model.prefill`` (encode, prime the cache, decode a BOS at position
    0) and 4 decode steps fed the same tokens, against the reference's;
    the cache's ``enc_out`` is the encoder's output."""
    rcfg, tcfg, rparams, tparams, batch, tbatch = audio
    rm, tm = RREG.get_model(rcfg), TREG.get_model(tcfg, "cpu")
    rl, rc = jax.jit(lambda p, f: rm.prefill(p, {"frames": f,
                                                 "max_len": 6}))(
        rparams, batch["frames"])
    tl, tc = tm.prefill(tparams, {"frames": tbatch["frames"], "max_len": 6})
    assert tc["cur"] == 1
    assert tl.shape == (B, 1, rcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15)
    np.testing.assert_allclose(_np(tc["enc_out"]), _np(rc["enc_out"]),
                               atol=0.05)
    r_decode = jax.jit(rm.decode)
    for t in range(4):
        tok = batch["dec_tokens"][:, t:t + 1]
        rl, rc = r_decode(rparams, rc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tparams, tc, {"token": torch.from_numpy(tok)})
        np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15,
                                   err_msg=f"step {t}")
    assert tc["cur"] == 5 and tc["self"]["k"].shape == rc["self"]["k"].shape
    with pytest.raises(ValueError, match="KV cache full"):
        tm.decode(tparams, {**tc, "cur": 6}, {"token": torch.from_numpy(
            batch["dec_tokens"][:, :1])})


def test_prefill_decode_matches_forward(audio):
    """The port's prefill (BOS at 0) and teacher-forced decode against its
    own forward on [BOS, tokens], within the logit bound."""
    _, tcfg, _, tparams, _, tbatch = audio
    tm = TREG.get_model(tcfg, "cpu")
    toks = tbatch["dec_tokens"][:, :4]
    bos = torch.zeros((B, 1), dtype=toks.dtype)
    with torch.no_grad():
        full = TE.forward(tparams, tcfg, tbatch["frames"],
                          torch.cat([bos, toks], 1))
    logits, cache = tm.prefill(tparams, {"frames": tbatch["frames"],
                                         "max_len": 5})
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, 0]),
                               atol=0.15)
    for t in range(4):
        logits, cache = tm.decode(tparams, cache, {"token": toks[:, t:t + 1]})
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t + 1]),
                                   atol=0.15)


@pytest.mark.parametrize("shape", [s.name for s in TB.SHAPES])
def test_audio_input_specs_match_reference(shape):
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    got = TREG.input_specs(cfg, TB.SHAPES_BY_NAME[shape])
    want = RREG.input_specs(rcfg, RB.SHAPES_BY_NAME[shape])
    assert set(got) == set(want)
    for k, spec in got.items():
        if k == "max_len":
            assert spec == want[k] == TB.SHAPES_BY_NAME[shape].seq_len
            continue
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == want[k].shape, k
        assert str(spec.dtype).split(".")[-1] == str(want[k].dtype)


def test_audio_dummy_batch():
    cfg = get_config(ARCH).reduced()
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = TB.reduced_shape(TB.SHAPES_BY_NAME[name])
        got = TREG.make_dummy_batch(cfg, shape, seed=1, device="cpu")
        want = RREG.make_dummy_batch(ref_get_config(ARCH).reduced(),
                                     RB.reduced_shape(RB.SHAPES_BY_NAME[name]))
        assert set(got) == set(want)
        for k, v in got.items():
            if k == "max_len":
                assert v == want[k] == shape.seq_len
            else:
                assert tuple(v.shape) == want[k].shape
                assert str(v.dtype).split(".")[-1] == str(want[k].dtype)
    batch = TREG.make_dummy_batch(cfg, TB.reduced_shape(
        TB.SHAPES_BY_NAME["train_4k"]), device="cpu")
    assert batch["frames"].dtype == torch.bfloat16
    assert int(batch["dec_tokens"].max()) < cfg.vocab_size
    loss = TREG.get_model(cfg, "cpu").loss(TE.init_lm(0, cfg, "cpu"), batch)
    assert loss.ndim == 0 and torch.isfinite(loss)
