"""The port's hybrid (Jamba) family against the reference's, on the
reduced jamba-1.5-large-398b (4 layers, ``attn_period`` 2: two groups of
one Mamba block and one attention block; 4 experts top-2 in every layer)
with the reference's own ``init_lm(PRNGKey(0))`` weights carried across
bitwise by ``params_from_numpy``.

Every test runs at ``MOE_CAPACITY_FACTOR`` 8.0 in both packages, as the
reference's own hybrid test does (``tests/test_models_smoke.py``), so that
no token is dropped: at 1.25 a near tie in the router sends a prefill
token past an expert's capacity in one package and not the other, and
the 4th decode step's logits part by 0.28. Tolerances: the Mamba block
within atol 0.05 (the reference's Mamba bound); forward, prefill and
decode logits within atol 0.15 (the port's logit bound,
``tests/test_torch_lm.py``); the loss within rel 2e-3; the port's
prefill + decode against its own forward within atol 0.25, the
reference's hybrid bound. The reference runs jitted, its weights too (one
compile a function: op by op its scans compile at every call; the jitted
``init_lm`` draws other bits than the op-by-op one, and both packages get
the same arrays). Also: the int8 head through ``quant_matmul``'s CPU
lane gives the dense head's greedy tokens, and ``launch.train`` trains
the reduced config and resumes bit for bit."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as RC
from repro.models import mamba as RM
from repro.models import registry as RREG
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import train as TL
from repro_torch.models import common as TC
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.serving import lm
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TTS

ARCH = "jamba-1.5-large-398b"
B, PROMPT, GEN = 2, 8, 4


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(
        t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def hybrid():
    saved = RC.MOE_CAPACITY_FACTOR, TC.MOE_CAPACITY_FACTOR
    RC.MOE_CAPACITY_FACTOR = TC.MOE_CAPACITY_FACTOR = 8.0
    rcfg = ref_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    rparams = jax.jit(RT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, PROMPT + GEN)).astype(np.int32)
    yield rcfg, tcfg, rparams, tparams, tokens
    RC.MOE_CAPACITY_FACTOR, TC.MOE_CAPACITY_FACTOR = saved


def test_params_cross_both_ways(hybrid):
    rcfg, tcfg, rparams, tparams, _ = hybrid
    G, P = rcfg.n_layers // rcfg.attn_period, rcfg.attn_period
    assert tparams["mamba_blocks"]["mamba"]["in_proj"].shape == (
        G, P - 1, rcfg.d_model, 2 * rcfg.ssm_d_inner)
    assert tparams["attn_blocks"]["ffn"]["w_gate"].shape == (
        G, rcfg.n_experts, rcfg.d_model, rcfg.moe_ff)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), rparams)
    own = TT.params_to_numpy(TT.init_lm(0, tcfg, "cpu"))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        own) == shapes
    back = TT.params_to_numpy(tparams)
    same = jax.tree.map(lambda a, b: np.array_equal(
        np.asarray(a).view(np.uint8), b.view(np.uint8)), rparams, back)
    assert all(jax.tree.leaves(same))
    one = TT.mamba_layer(tparams["mamba_blocks"], 1, 0)
    assert torch.equal(one["mamba"]["x_proj"],
                       tparams["mamba_blocks"]["mamba"]["x_proj"][1, 0])


def test_mamba_block_matches_reference(hybrid):
    """Group 1's Mamba block (norm, Mamba, residual, norm, MoE FFN,
    residual) on a seeded bf16 input."""
    rcfg, tcfg, rparams, tparams, _ = hybrid

    def block(bp, x):
        h = x + RM.mamba_fwd(bp["mamba"], rcfg,
                             RC.rms_norm(x, bp["norm1"], rcfg.norm_eps))
        return h + RT.apply_ffn(bp["ffn"], rcfg,
                                RC.rms_norm(h, bp["norm2"], rcfg.norm_eps))
    x = np.random.default_rng(9).standard_normal((2, 12, rcfg.d_model))
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    want = jax.jit(block)(jax.tree.map(lambda a: a[1, 0],
                                       rparams["mamba_blocks"]), xj)
    got = TT.mamba_block_fwd(TT.mamba_layer(tparams["mamba_blocks"], 1, 0),
                             tcfg, TC.tensor_from_numpy(np.asarray(xj),
                                                        "cpu"))
    np.testing.assert_allclose(_np(got), _np(want), atol=0.05)


def test_forward_and_loss_match_reference(hybrid):
    rcfg, tcfg, rparams, tparams, tokens = hybrid
    toks = tokens[:, :PROMPT + 3]
    want = jax.jit(RT.forward, static_argnums=(1,))(rparams, rcfg,
                                                    jnp.asarray(toks))
    got = TT.forward(tparams, tcfg, torch.from_numpy(toks))
    assert got.shape == want.shape == (B, PROMPT + 3, rcfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15)
    labels = np.roll(toks, -1, axis=1)
    r_loss = RREG.cross_entropy(want, jnp.asarray(labels))
    t_loss = TREG.get_model(tcfg, "cpu").loss(
        tparams, {"tokens": torch.from_numpy(toks),
                  "labels": torch.from_numpy(labels)})
    assert float(t_loss) == pytest.approx(float(r_loss), rel=2e-3)


def test_prefill_and_decode_match_reference(hybrid):
    """Prefill of 8 tokens (the Mamba states and the attention K/V into
    the cache), then 4 decode steps fed the same tokens in both packages."""
    rcfg, tcfg, rparams, tparams, tokens = hybrid
    r_prefill = jax.jit(RT.prefill, static_argnums=(1,),
                        static_argnames=("max_len",))
    r_decode = jax.jit(RT.decode_step, static_argnums=(1,))
    rl, rc = r_prefill(rparams, rcfg, jnp.asarray(tokens[:, :PROMPT]),
                       max_len=PROMPT + GEN)
    tl, tc = TT.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :PROMPT]),
                        max_len=PROMPT + GEN)
    np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15)
    for name in ("h", "conv"):
        assert tc["ssm"][name].shape == rc["ssm"][name].shape
        assert tc["ssm"][name].dtype == getattr(torch, str(rc["ssm"][name]
                                                           .dtype))
    np.testing.assert_allclose(_np(tc["ssm"]["conv"]), _np(rc["ssm"]["conv"]),
                               atol=0.05)
    assert tc["attn"]["k"].shape == rc["attn"]["k"].shape
    for t in range(PROMPT, PROMPT + GEN):
        tok = tokens[:, t:t + 1]
        rl, rc = r_decode(rparams, rcfg, rc, jnp.asarray(tok))
        tl, tc = TT.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
        assert tl.shape == (B, 1, tcfg.padded_vocab)
        np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15,
                                   err_msg=f"position {t}")
    assert tc["cur"] == PROMPT + GEN


def test_prefill_decode_matches_forward(hybrid):
    """The port's prefill + teacher-forced decode against its own forward
    over the 12 tokens, at every position."""
    _, tcfg, _, tparams, tokens = hybrid
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        full = TT.forward(tparams, tcfg, toks)
    logits, cache = TT.prefill(tparams, tcfg, toks[:, :PROMPT],
                               max_len=PROMPT + GEN)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, PROMPT - 1]),
                               atol=0.25)
    for t in range(PROMPT, PROMPT + GEN):
        logits, cache = TT.decode_step(tparams, tcfg, cache,
                                       toks[:, t:t + 1])
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                   atol=0.25, err_msg=f"position {t}")


def test_int8_head_decode_gives_dense_tokens(hybrid):
    """``serving.lm.decode_loop`` with the int8 head (``quant_matmul``'s CPU
    lane, one call per head run) gives the dense head's greedy tokens."""
    _, tcfg, _, tparams, tokens = hybrid
    head = lm.int8_head(tparams, tcfg)
    assert head.packed.shape == (tcfg.d_model, tcfg.padded_vocab)
    prompt = torch.from_numpy(tokens[:, :PROMPT])
    dense = lm.decode_loop(tparams, tcfg, prompt, GEN)
    before = ops.quant_matmul.launches
    quant = lm.decode_loop(tparams, tcfg, prompt, GEN, head_fn=head)
    assert ops.quant_matmul.launches == before      # no kernel on the CPU
    assert quant.shape == (B, GEN) and torch.equal(quant, dense)


def _main(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        loss = TL.main(argv)
    return loss, out.getvalue()


def test_launch_train_resumes_bit_for_bit(hybrid, tmp_path):
    """``python -m repro_torch.launch.train --arch jamba-1.5-large-398b
    --reduced --schedule constant``: 4 steps straight through, against 2
    steps and then the same command at ``--steps 4``, which resumes from
    step 2; the final loss and checkpoint are the same bits."""
    args = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
            "--schedule", "constant", "--log-every", "1", "--device", "cpu",
            "--ckpt-every", "2"]
    full, log = _main(args + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "full")])
    assert np.isfinite(full) and "resumed" not in log
    cut = str(tmp_path / "cut")
    _main(args + ["--steps", "2", "--ckpt-dir", cut])
    rest, log = _main(args + ["--steps", "4", "--ckpt-dir", cut])
    assert "[train] resumed from step 2" in log and rest == full
    template = TTS.init_train_state(TREG.get_model(
        get_config(ARCH).reduced(), "cpu"), 0)
    a, _ = TCK.restore(str(tmp_path / "full"), template)
    b, step = TCK.restore(cut, template)
    assert step == 4
    for x, y in zip(TO.tree_leaves(a), TO.tree_leaves(b)):
        assert torch.equal(x, y)
