"""The port's MoE family and the int8 KV cache against the reference's, on
the reduced granite-moe-1b-a400m (4 experts, top-2) and qwen2-moe-a2.7b (4
experts, top-2, one shared expert) with the reference's own weights
(``init_lm(PRNGKey(0))`` carried across bitwise by ``params_from_numpy``).

Tolerances: ``_dispatch_mask`` bitwise (the same gates in both packages);
``moe_ffn`` bitwise on the fixture's inputs (the gather dispatch within
atol 0.02, as ``test_torch_lm.py``'s primitives);
forward, prefill and decode logits within atol 0.15, its bound for the
model. The reference's prefill and decode run jitted, as in
``test_torch_lm.py``; ``moe_ffn`` and ``forward`` op by op. MoE prefill and
decode do not equal ``forward`` even in the reference (groups and
capacities differ), so each function is held to its own counterpart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as RC
from repro.models import registry as RREG
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import common as TC
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT

B, PROMPT, GEN = 2, 8, 4
ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")


def _np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_pair(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, TC.tensor_from_numpy(np.asarray(j), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    rcfg = ref_get_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    rparams = RT.init_lm(jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, PROMPT + GEN)).astype(np.int32)
    return rcfg, tcfg, rparams, tparams, tokens


def _gates(seed, S, E):
    logits = np.random.default_rng(seed).standard_normal((S, E)).astype(
        np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


# ---------------------------------------------------------- the dispatch

@pytest.mark.parametrize("top_k", [2, 4])
@pytest.mark.parametrize("capacity", [1, 2, 64])
def test_dispatch_mask_bitwise(top_k, capacity):
    """Dispatch and combine equal the reference's bit for bit, where
    places fall past the capacity (1, 2: most tokens dropped, the
    reference's zero one-hot rows) and where none does (64)."""
    g = _gates(top_k * 10 + capacity, 32, 8)
    rd, rc = RC._dispatch_mask(jnp.asarray(g), top_k, capacity)
    td, tc = TC._dispatch_mask(torch.from_numpy(g.copy()), top_k, capacity)
    assert td.dtype == torch.bool and tc.dtype == torch.float32
    assert np.array_equal(td.numpy(), np.asarray(rd))
    assert tc.numpy().tobytes() == np.asarray(rc).tobytes()
    kept = int(td.sum())
    assert kept == min(32 * top_k, 8 * capacity) if capacity == 64 \
        else kept <= 8 * capacity
    if capacity < 64:
        assert kept < 32 * top_k          # some tokens were dropped


# ------------------------------------------------------------- moe_ffn

def _ffn(params, i=0):
    return jax.tree.map(lambda a: a[i], params["blocks"]["ffn"])


@pytest.mark.parametrize("group_size", [0, 6])
def test_moe_ffn_matches_reference(moe, group_size):
    """One layer's MoE FFN on the same bf16 input: one group of 16 tokens,
    and groups of 6 (the last zero-padded); with the shared expert for
    qwen2-moe."""
    rcfg, tcfg, rparams, tparams, _ = moe
    xj, xt = _bf16_pair(2, (2, 8, rcfg.d_model))
    rp, tp = _ffn(rparams), TT.layer(tparams["blocks"], 0)["ffn"]
    assert ("shared" in tp) == bool(tcfg.n_shared_experts)
    want = RC.moe_ffn(rp, xj, top_k=rcfg.top_k, group_size=group_size)
    got = TC.moe_ffn(tp, xt, top_k=tcfg.top_k, group_size=group_size)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    # bitwise on these inputs since the SiLU rounds each of its operations
    # as XLA does (before, the shared expert's bf16 SiLU was 0.0156 off)
    assert np.array_equal(_np(got), _np(want))


def test_moe_ffn_gradient_flows_to_every_leaf(moe):
    _, tcfg, _, tparams, _ = moe
    tp = {k: v for k, v in TT.layer(tparams["blocks"], 0)["ffn"].items()}
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items() if k != "shared"}
    _, xt = _bf16_pair(3, (2, 8, tcfg.d_model))
    y = TC.moe_ffn({**tp, **leaves}, xt, top_k=tcfg.top_k)
    y.to(torch.float32).square().sum().backward()
    for k, v in leaves.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
        assert v.grad.abs().sum() > 0, k


@pytest.fixture
def dispatch_mode():
    def set_mode(mode):
        TC.MOE_DISPATCH = mode
        RC.MOE_DISPATCH = mode
    yield set_mode
    TC.MOE_DISPATCH = RC.MOE_DISPATCH = "einsum"


def test_gather_matches_einsum_at_ample_capacity(moe, dispatch_mode):
    """At capacity factor 4 no token is dropped, so ``"gather"`` equals
    ``"einsum"`` (atol 0.05, the reference's own bound) in the port, and
    the port's gather equals the reference's (atol 0.02)."""
    rcfg, tcfg, rparams, tparams, _ = moe
    xj, xt = _bf16_pair(4, (2, 8, tcfg.d_model))
    tp = TT.layer(tparams["blocks"], 0)["ffn"]
    kw = dict(top_k=tcfg.top_k, capacity_factor=4.0)
    dispatch_mode("einsum")
    y_einsum = TC.moe_ffn(tp, xt, **kw)
    dispatch_mode("gather")
    y_gather = TC.moe_ffn(tp, xt, **kw)
    want = RC.moe_ffn(_ffn(rparams), xj, **kw)
    np.testing.assert_allclose(_np(y_gather), _np(y_einsum), atol=0.05)
    np.testing.assert_allclose(_np(y_gather), _np(want), atol=0.02)


def test_gather_choice_among_zero_weight_tokens_moves_nothing(
        moe, dispatch_mode):
    """``"gather"`` ranks each expert's tokens by gate weight; at capacity
    factor 4 every expert takes all 16 tokens, most at weight exactly 0,
    and which of those ``topk`` lists first is a tie. Reversing the tokens
    reverses that choice; the output, put back in order, is the same bits:
    a zero-weight token adds nothing."""
    _, tcfg, _, tparams, _ = moe
    _, xt = _bf16_pair(5, (1, 16, tcfg.d_model))
    tp = TT.layer(tparams["blocks"], 0)["ffn"]
    kw = dict(top_k=tcfg.top_k, capacity_factor=4.0)
    gates = torch.softmax(xt[0].to(torch.float32) @ tp["router"], dim=-1)
    topw, topi = TC._normalized_top_k(gates, tcfg.top_k)
    w_se = torch.zeros_like(gates).scatter(1, topi, topw)
    assert int((w_se == 0).sum()) >= 16          # zero-weight picks exist
    dispatch_mode("gather")
    y = TC.moe_ffn(tp, xt, **kw)
    y_rev = TC.moe_ffn(tp, xt.flip(1), **kw).flip(1)
    assert torch.equal(y, y_rev)


def test_unknown_dispatch_raises(moe, dispatch_mode):
    _, tcfg, _, tparams, _ = moe
    dispatch_mode("scatter")
    with pytest.raises(ValueError, match="MOE_DISPATCH"):
        TC.moe_ffn(TT.layer(tparams["blocks"], 0)["ffn"],
                   torch.zeros((1, 2, tcfg.d_model), dtype=torch.bfloat16),
                   top_k=tcfg.top_k)


# ------------------------------------------------------------ the model

def test_params_cross_in_the_reference_layout(moe):
    rcfg, tcfg, rparams, tparams, _ = moe
    assert tparams["blocks"]["ffn"]["w_gate"].shape == (
        rcfg.n_layers, rcfg.n_experts, rcfg.d_model, rcfg.moe_ff)
    assert tparams["blocks"]["ffn"]["router"].dtype == torch.float32
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), rparams)
    own = TT.params_to_numpy(TT.init_lm(0, tcfg, "cpu"))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        own) == shapes


def test_forward_and_loss_match_reference(moe):
    rcfg, tcfg, rparams, tparams, tokens = moe
    toks = tokens[:, :PROMPT]
    want = RT.forward(rparams, rcfg, jnp.asarray(toks), remat=False)
    got = TT.forward(tparams, tcfg, torch.from_numpy(toks))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    r_loss = RREG.get_model(rcfg).loss(rparams, batch)
    t_loss = TREG.get_model(tcfg, "cpu").loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(t_loss) == pytest.approx(float(r_loss), rel=2e-3)


def test_prefill_and_decode_logits_match_reference(moe):
    """Prefill of 8 tokens, then 4 decode steps fed the same tokens in both
    packages (teacher-forced). Decoding 2 sequences gives capacity 1 an
    expert, so tokens are dropped at every step."""
    rcfg, tcfg, rparams, tparams, tokens = moe
    r_prefill = jax.jit(RT.prefill, static_argnums=(1,),
                        static_argnames=("max_len",))
    r_decode = jax.jit(RT.decode_step, static_argnums=(1,))
    rl, rcache = r_prefill(rparams, rcfg, jnp.asarray(tokens[:, :PROMPT]),
                           max_len=PROMPT + GEN)
    tl, tcache = TT.prefill(tparams, tcfg,
                            torch.from_numpy(tokens[:, :PROMPT]),
                            max_len=PROMPT + GEN)
    np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15)
    for t in range(PROMPT, PROMPT + GEN):
        tok = tokens[:, t:t + 1]
        rl, rcache = r_decode(rparams, rcfg, rcache, jnp.asarray(tok))
        tl, tcache = TT.decode_step(tparams, tcfg, tcache,
                                    torch.from_numpy(tok))
        assert tl.shape == (B, 1, tcfg.padded_vocab)
        np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15,
                                   err_msg=f"position {t}")
    assert tcache["cur"] == PROMPT + GEN


def test_remat_changes_no_gradient(moe):
    """``forward(remat=True)`` (``torch.utils.checkpoint`` per block, the
    loss's default) gives the loss and every gradient of ``remat=False``
    bit for bit."""
    from repro_torch.models.registry import cross_entropy
    from repro_torch.training import optimizer as TO
    _, tcfg, _, tparams, tokens = moe
    toks = torch.from_numpy(tokens)
    labels = torch.from_numpy(np.roll(tokens, -1, axis=1))
    out = [TO.value_and_grad(lambda p: cross_entropy(
        TT.forward(p, tcfg, toks, remat=r), labels), tparams)
        for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(TO.tree_leaves(out[0][1]), TO.tree_leaves(out[1][1])):
        assert torch.equal(a, b)


# ------------------------------------------------------ the int8 KV cache

@pytest.fixture
def int8_cache():
    TT.KV_CACHE_DTYPE, RT.KV_CACHE_DTYPE = torch.int8, jnp.int8
    yield
    TT.KV_CACHE_DTYPE, RT.KV_CACHE_DTYPE = torch.bfloat16, jnp.bfloat16


def test_int8_kv_cache_decode_matches_reference(int8_cache):
    """stablelm-1.6b reduced: prefill of 5 tokens into an int8 cache, one
    decode step. Layer 0's codes equal the reference's bit for bit (its k
    and v are the same bf16 values in both packages); later layers' k and v
    already differ by bf16 roundings (under 0.6 of a code step), so their
    codes are at most one apart. Every code is ``_cache_store`` of the
    port's own bf16 cache. The decode logits agree within atol 0.15, and
    stay within the reference's own bound (1.0) of the bf16-cache decode."""
    rcfg = ref_get_config("stablelm-1.6b").reduced()
    tcfg = get_config("stablelm-1.6b").reduced()
    rparams = RT.init_lm(jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 6)).astype(np.int32)
    _, rc = RT.prefill(rparams, rcfg, jnp.asarray(toks[:, :5]), max_len=6)
    rl, _ = RT.decode_step(rparams, rcfg, rc, jnp.asarray(toks[:, 5:6]))
    _, tc = TT.prefill(tparams, tcfg, torch.from_numpy(toks[:, :5]),
                       max_len=6)
    assert tc["attn"]["k"].dtype == torch.int8
    TT.KV_CACHE_DTYPE = torch.bfloat16
    _, c16 = TT.prefill(tparams, tcfg, torch.from_numpy(toks[:, :5]),
                        max_len=6)
    for name in ("k", "v"):
        got = tc["attn"][name]
        assert torch.equal(got, TT._cache_store(c16["attn"][name],
                                                torch.int8))
        want = np.asarray(rc["attn"][name])
        assert np.array_equal(got[0].numpy(), want[0]), name
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, name
    l16, _ = TT.decode_step(tparams, tcfg, c16, torch.from_numpy(toks[:, 5:6]))
    tl, tc = TT.decode_step(tparams, tcfg, tc, torch.from_numpy(toks[:, 5:6]))
    np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15)
    assert float(np.abs(_np(l16) - _np(tl)).max()) < 1.0


def test_cache_store_and_load_round_trip():
    v = torch.tensor([[-9.0, -0.03125, 0.03125, 0.09375, 7.9375, 8.5]],
                     dtype=torch.bfloat16)
    codes = TT._cache_store(v, torch.int8)
    # half-way values round to even; 8.5 / (1/16) = 136 clips to 127
    assert codes.tolist() == [[-128, 0, 0, 2, 127, 127]]
    back = TT._cache_load(codes, torch.bfloat16)
    assert back.dtype == torch.bfloat16
    assert back.tolist() == [[-8.0, 0.0, 0.0, 0.125, 7.9375, 7.9375]]
    assert TT._cache_load(v, torch.bfloat16) is v
