"""The port's hybrid (Jamba) family against the reference's, on the
reduced jamba-1.5-large-398b (4 layers, ``attn_period`` 2: two groups of
one Mamba block and one attention block; 4 experts top-2 in every layer)
with the reference's own ``init_lm(PRNGKey(0))`` weights carried across
bitwise by ``params_from_numpy``.

The tests run at ``MOE_CAPACITY_FACTOR`` 8.0 in both packages, as the
reference's own hybrid test does (``tests/test_models_smoke.py``), so that
no token is dropped; ``test_capacity_1_25_matches_jitted_reference`` runs
the served default, 1.25, on this prompt and on ROADMAP fault 11's. Every
block's second norm reads the float32 residual sum, as XLA computes the
jitted reference (fault 11, fixed: fed the bf16 sum, the port moved a
router at a near tie and parted by 0.80). Tolerances: the Mamba block
within atol 0.05 (the reference's Mamba bound); forward, prefill and
decode logits within atol 0.15 (the port's logit bound,
``tests/test_torch_lm.py``); the loss within rel 2e-3; the port's
prefill + decode against its own forward within atol 0.25, the
reference's hybrid bound, at every step before the first whose router
margin is below ``lm.GATE_DELTA`` (none on this prompt). The reference runs jitted, its weights too (one
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
    over the 12 tokens, held on router margins (``lm.decode_on_margins``):
    within atol 0.25 at every step before the first whose routers pick
    other experts than the forward's, a step whose smallest top-k gate
    margin must be below ``lm.GATE_DELTA``, and every step (the prefill and
    all 4 decode steps) must be so bounded. It assumed no router tie on
    seeded weights; a tie now shows as the step where the bound ends."""
    _, tcfg, _, tparams, tokens = hybrid
    toks = torch.from_numpy(tokens)
    with torch.no_grad(), lm.RouterLog() as fwd:
        full = TT.forward(tparams, tcfg, toks)
    with lm.RouterLog() as log:
        logits, cache = TT.prefill(tparams, tcfg, toks[:, :PROMPT],
                                   max_len=PROMPT + GEN)
    logs, spans = [log], [(PROMPT - 1, PROMPT)]
    errs = [np.abs(_np(logits[:, 0]) - _np(full[:, PROMPT - 1])).max()]
    for t in range(PROMPT, PROMPT + GEN):
        with lm.RouterLog() as log:
            logits, cache = TT.decode_step(tparams, tcfg, cache,
                                           toks[:, t:t + 1])
        logs.append(log)
        spans.append((t, t + 1))
        errs.append(np.abs(_np(logits[:, 0]) - _np(full[:, t])).max())
    flipped, margins = lm.step_routing(fwd, logs, spans)
    held = lm.decode_on_margins(errs, margins, flipped, 0.25)
    assert held["ok"] and held["bounded_steps"] == GEN + 1, held


def test_gate_delta_is_one_bf16_step(hybrid):
    """``lm.GATE_DELTA`` is the largest change of any router gate that one
    bf16 step in its norm's input makes on this fixture: every MoE
    router's gates on the norm of the float32 residual sum against the
    norm of the same sum rounded to bf16 (ROADMAP fault 11's step), block
    by block on the forward's own inputs."""
    rcfg, tcfg, _, tparams, tokens = hybrid
    sums = []
    real = TC.add_rms_norm

    def recording(x, y, w, eps=1e-5):
        sums.append((x.to(torch.float32) + y.to(torch.float32), w, eps))
        return real(x, y, w, eps)
    TC.add_rms_norm = recording
    try:
        with torch.no_grad():
            TT.forward(tparams, tcfg, torch.from_numpy(tokens))
    finally:
        TC.add_rms_norm = real
    G, P = rcfg.n_layers // rcfg.attn_period, rcfg.attn_period
    routers = []                       # in the forward's block order
    for g in range(G):
        routers += [tparams["mamba_blocks"]["ffn"]["router"][g, j]
                    for j in range(P - 1)]
        routers.append(tparams["attn_blocks"]["ffn"]["router"][g])
    assert len(sums) == len(routers) == rcfg.n_layers
    moved = 0.0
    for (h, w, eps), router in zip(sums, routers):
        g32, g16 = (torch.softmax(TC.rms_norm(v, w, eps).to(
            torch.bfloat16).to(torch.float32) @ router, dim=-1)
            for v in (h, h.to(torch.bfloat16)))
        moved = max(moved, float((g32 - g16).abs().max()))
    assert moved <= lm.GATE_DELTA < 1.05 * moved, moved


@pytest.mark.parametrize("prompt", ["fixture", "fault11"])
def test_capacity_1_25_matches_jitted_reference(hybrid, monkeypatch,
                                                prompt):
    """At the served ``MOE_CAPACITY_FACTOR`` 1.25 in both packages, forward,
    prefill and every decode step within atol 0.15 of the jitted reference,
    on the fixture's 12 tokens (8 prefilled, 4 decoded) and on ROADMAP
    fault 11's ``default_rng(1).integers(0, 256, (2, 9))`` (8 prefilled, 1
    decoded), where the port parted by 0.80 while its norms read the bf16
    residual sum."""
    rcfg, tcfg, rparams, tparams, tokens = hybrid
    monkeypatch.setattr(RC, "MOE_CAPACITY_FACTOR", 1.25)
    monkeypatch.setattr(TC, "MOE_CAPACITY_FACTOR", 1.25)
    if prompt == "fault11":
        tokens = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(
            np.int32)
    T = tokens.shape[1]
    # fresh functions, so that nothing traced at 8.0 is reused
    want = jax.jit(lambda p, t: RT.forward(p, rcfg, t))(rparams,
                                                       jnp.asarray(tokens))
    with torch.no_grad():
        got = TT.forward(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15)
    rl, rc = jax.jit(lambda p, t: RT.prefill(p, rcfg, t, max_len=T))(
        rparams, jnp.asarray(tokens[:, :PROMPT]))
    tl, tc = TT.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :PROMPT]),
                        max_len=T)
    np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15)
    r_decode = jax.jit(lambda p, c, t: RT.decode_step(p, rcfg, c, t))
    for t in range(PROMPT, T):
        tok = tokens[:, t:t + 1]
        rl, rc = r_decode(rparams, rc, jnp.asarray(tok))
        tl, tc = TT.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(tl), _np(rl), atol=0.15,
                                   err_msg=f"position {t}")


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
