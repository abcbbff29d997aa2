"""The port's dense language model and its quantized-head serving loop
against the reference's, on ``get_config("stablelm-1.6b").reduced()`` with
the reference's own weights (``repro.models.transformer.init_lm(PRNGKey(0))``
carried across bitwise by ``params_from_numpy``).

Tolerances: the primitives within atol 0.02 on bf16 inputs (the gated MLP
bitwise); prefill and
decode logits within atol 0.15, the reference's own bound for its
prefill/decode/forward agreement (``tests/test_models_smoke.py``). Greedy
decode diverges for good after one flipped token, so tokens are compared
teacher-forced, step by step, wherever the reference's top-2 logit margin
exceeds 0.3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as RO
from repro.models import common as RC
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TO
from repro_torch.models import common as TC
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.serving import lm as TLM

B, PROMPT, GEN = 4, 12, 8


def _cfgs():
    ref = ref_get_config("stablelm-1.6b").reduced()
    return ref, get_config("stablelm-1.6b").reduced()


@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = _cfgs()
    rparams = RT.init_lm(jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    tokens = np.random.default_rng(0).integers(0, rcfg.vocab_size,
                                               (B, PROMPT)).astype(np.int32)
    return rcfg, tcfg, rparams, tparams, tokens


def _bf16_pair(seed, shape, scale=1.0):
    """The same bf16 values in both frameworks."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, TC.tensor_from_numpy(np.asarray(j), "cpu")


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(reduced):
    ref = ref_get_config("stablelm-1.6b")
    port = get_config("stablelm-1.6b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.head_dim == ref.head_dim
    assert port.n_params() == ref.n_params()
    if not reduced:
        assert port.padded_vocab == 100352 and port.n_params() > 1.6e9


def test_config_registry():
    assert get_config("sru_timit").name == ref_get_config("sru_timit").name
    assert get_config("jamba-1.5-large-398b") == TT.ArchConfig(
        **dataclasses.asdict(ref_get_config("jamba-1.5-large-398b")))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-model")


# --------------------------------------------------------------- primitives

def test_bf16_params_cross_bitwise(model):
    _, _, rparams, tparams, _ = model
    assert tparams["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert tparams["blocks"]["attn"]["wq"].shape == \
        rparams["blocks"]["attn"]["wq"].shape
    back = TT.params_to_numpy(tparams)
    flat_r = jax.tree_util.tree_leaves_with_path(rparams)
    for path, leaf in flat_r:
        node = back
        for p in path:
            node = node[p.key]
        assert node.dtype == np.asarray(leaf).dtype, path
        assert np.asarray(leaf).tobytes() == node.tobytes(), path


def test_rms_norm_and_rope():
    xj, xt = _bf16_pair(1, (2, 5, 4, 16), 3.0)
    w = np.random.default_rng(2).standard_normal(16).astype(np.float32)
    got = TC.rms_norm(xt, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(RC.rms_norm(xj, jnp.asarray(w))),
                               atol=0.02)
    pos = np.arange(3, 8, dtype=np.int32)[None]
    got = TC.rope(xt, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(RC.rope(xj, jnp.asarray(pos))),
                               atol=0.02)


@pytest.mark.parametrize("kv_heads,q_offset,kv_valid",
                         [(4, 0, None), (2, 0, None), (4, 5, 6)])
def test_dense_gqa_attention(kv_heads, q_offset, kv_valid):
    Tq = 1 if kv_valid else 7
    qj, qt = _bf16_pair(3, (2, Tq, 4, 16))
    kj, kt = _bf16_pair(4, (2, 9, kv_heads, 16))
    vj, vt = _bf16_pair(5, (2, 9, kv_heads, 16))
    kw = dict(q_offset=q_offset, kv_valid=kv_valid)
    got = TC.gqa_attention(qt, kt, vt, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(got), _np(RC.gqa_attention(qj, kj, vj, **kw)), atol=0.02)


def test_flash_branch_and_moe_raise():
    """Once refusals, now ported: past ``DENSE_ATTN_MAX`` the flash-style
    branch runs (held to the reference in tests/test_torch_attention.py),
    the MoE FFN (tests/test_torch_moe.py) and the hybrid family
    (tests/test_torch_hybrid.py) build; a family that is no decoder-only
    LM still raises in ``transformer``."""
    q = torch.zeros((1, 9000, 2, 4), dtype=torch.bfloat16)
    assert TC.gqa_attention(q[:, :, :, :], q[:, :, :1], q[:, :, :1],
                            chunk_q=4096, chunk_k=4096).shape == q.shape
    moe = TC.init_moe(torch.Generator().manual_seed(0), 4, 8, 2, 0)
    assert TC.moe_ffn(moe, q[:, :3, 0], top_k=1).shape == (1, 3, 4)
    hybrid = ref_get_config("jamba-1.5-large-398b").reduced()
    params = TT.init_lm(0, TT.ArchConfig(**dataclasses.asdict(hybrid)),
                        "cpu")
    assert set(params) >= {"mamba_blocks", "attn_blocks"}
    with pytest.raises(ValueError, match="not a decoder-only LM"):
        TT.init_lm(0, TT.ArchConfig(**dataclasses.asdict(
            ref_get_config("xlstm-350m").reduced())), "cpu")


def test_mlp(model):
    _, _, rparams, tparams, _ = model
    xj, xt = _bf16_pair(6, (2, 3, 64))
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"]["ffn"])
    tp = TT.layer(tparams["blocks"], 0)["ffn"]
    got = TC.mlp(tp, xt)
    assert got.dtype == torch.bfloat16
    # bitwise since the SiLU rounds each of its operations as XLA does
    assert np.array_equal(_np(got), _np(RC.mlp(rp, xj)))


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def teacher_forced(model):
    """Reference and port logits of prefill and of each decode step, both
    fed the reference's greedy token at every step."""
    rcfg, tcfg, rparams, tparams, tokens = model
    r_prefill = jax.jit(RT.prefill, static_argnums=(1,),
                        static_argnames=("max_len",))
    r_decode = jax.jit(RT.decode_step, static_argnums=(1,))
    rl, rcache = r_prefill(rparams, rcfg, jnp.asarray(tokens),
                           max_len=PROMPT + GEN)
    tl, tcache = TT.prefill(tparams, tcfg, torch.from_numpy(tokens),
                            max_len=PROMPT + GEN)
    steps = [(_np(rl), _np(tl))]
    for _ in range(GEN - 1):
        nxt = jnp.argmax(rl[:, -1], axis=-1)[:, None]
        rl, rcache = r_decode(rparams, rcfg, rcache, nxt)
        tl, tcache = TT.decode_step(tparams, tcfg, tcache,
                                    torch.from_numpy(np.asarray(nxt)))
        steps.append((_np(rl), _np(tl)))
    return steps, tcache


def test_prefill_and_decode_logits(teacher_forced):
    steps, cache = teacher_forced
    assert cache["cur"] == PROMPT + GEN - 1
    for i, (want, got) in enumerate(steps):
        assert got.shape == want.shape == (B, 1, 256), i
        np.testing.assert_allclose(got, want, atol=0.15, err_msg=f"step {i}")


def test_teacher_forced_greedy_tokens(teacher_forced):
    steps, _ = teacher_forced
    compared = 0
    for i, (want, got) in enumerate(steps):
        top2 = np.sort(want[:, -1], axis=-1)[:, ::-1][:, :2]
        clear = top2[:, 0] - top2[:, 1] > 0.3
        compared += int(clear.sum())
        assert np.array_equal(got[:, -1].argmax(-1)[clear],
                              want[:, -1].argmax(-1)[clear]), i
    assert compared >= 4, compared


def test_forward_matches_prefill(model):
    """The port's full forward agrees with its own prefill, as the
    reference's do (atol 0.15)."""
    _, tcfg, _, tparams, tokens = model
    full = TT.forward(tparams, tcfg, torch.from_numpy(tokens))
    last, _ = TT.prefill(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(full[:, -1]), _np(last[:, 0]), atol=0.15)


def test_registry_lm_model(model):
    _, tcfg, _, tparams, tokens = model
    m = TREG.get_model(tcfg, "cpu")
    toks = torch.from_numpy(tokens).long()
    loss = m.loss(tparams, {"tokens": toks, "labels": toks})
    assert loss.ndim == 0 and torch.isfinite(loss)
    logits, cache = m.prefill(tparams, {"tokens": toks, "max_len": PROMPT + 1})
    logits2, cache = m.decode(tparams, cache, {"token": toks[:, :1]})
    assert logits2.shape == (B, 1, tcfg.padded_vocab) and cache["cur"] == \
        PROMPT + 1
    # the ssm family (the xLSTM) and the audio family (the encoder-decoder,
    # tests/test_torch_encdec.py) are ported, serving included
    ssm = TREG.get_model(TT.ArchConfig(**dataclasses.asdict(
        ref_get_config("xlstm-350m").reduced())), "cpu")
    assert ssm.cfg.family == "ssm" and ssm.prefill is not None
    audio = TREG.get_model(TT.ArchConfig(**dataclasses.asdict(
        ref_get_config("seamless-m4t-medium").reduced())), "cpu")
    assert audio.cfg.family == "audio" and audio.prefill is not None


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_lm(0, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_cache(tcfg, 1, 4)


# ------------------------------------------------------- the quantized head

def test_int8_head_decode_gives_dense_tokens(model):
    """``serving/lm.py``: greedy decode with the int8 head (one
    ``quant_matmul`` per prefill and decode step) gives the dense head's
    tokens, as the reference's example asserts."""
    _, tcfg, _, tparams, tokens = model
    head = TLM.int8_head(tparams, tcfg)
    toks = torch.from_numpy(tokens)
    dense = TLM.decode_loop(tparams, tcfg, toks, GEN)
    quant = TLM.decode_loop(tparams, tcfg, toks, GEN, head_fn=head)
    assert dense.shape == (B, GEN)
    assert torch.equal(dense, quant)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_heads_pack_and_run_like_the_reference(model, bits):
    """The port's packed heads equal the reference's bitwise (int8 clipped
    at max |w|, int4 at the MMSE clip) and give its logits on the same
    hidden states (rtol 1e-4 / atol 1e-3)."""
    _, tcfg, rparams, tparams, _ = model
    w = rparams["lm_head"].astype(jnp.float32)
    if bits == 8:
        head = TLM.int8_head(tparams, tcfg)
        clip = float(jnp.max(jnp.abs(w)))
    else:
        from repro.core.quantization import mmse_clip
        clip = mmse_clip(jax.device_get(w), 4)
        head = TLM.quant_head(tparams, tcfg, 4)
    rp, rs = RO.pack_for_kernel(w, bits, clip)
    assert torch.equal(head.packed, torch.from_numpy(np.array(rp)))
    assert torch.equal(head.scales, torch.from_numpy(np.array(rs)))
    x = np.random.default_rng(bits).standard_normal((B, 64)).astype(
        np.float32)
    want = np.asarray(RO.quant_matmul(jnp.asarray(x), rp, rs, bits,
                                      interpret=True))
    before = TO.quant_matmul.launches
    got = head(torch.from_numpy(x)[:, None])
    assert TO.quant_matmul.launches == before       # CPU: the plain version
    assert got.shape == (B, 1, 256)
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-4, atol=1e-3)
