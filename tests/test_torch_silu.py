"""The port's gated MLP and MoE experts hold the reference's SiLU to the bit.

XLA lowers ``jax.nn.silu`` to exp, add, divide and multiply, each rounded
to the operand's dtype (``common.silu`` writes the four out); ``F.silu``
rounds the exact value once, one bf16 step off in about 40 % of the MLP's
hidden elements.

The inputs and weights are seeded draws on a dyadic grid (x = i / 8,
w = j / 64, |i|, |j| <= 8), so that every gate and up product is an exact
sum in f32 and the two packages' summation orders cannot part them: what
is left to differ is the SiLU. The MoE experts are reached through the
reference's own ``moe_ffn`` with one expert and top-1 routing, where every
gate is exactly 1.0 and the FFN's output is the expert's output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as RC
from repro_torch.models import common as TC

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these products are small, and with six test
    workers on eight cores a multithreaded small op waits on its own
    threads. (The dyadic inputs make every sum exact, so the thread count
    cannot move a bit.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape, denom):
    return (rng.integers(-8, 9, shape) / denom).astype(np.float32)


def _pair(a):
    """The same bf16 values in both packages (exact: a is on the grid)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(a).to(torch.bfloat16)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def cfg():
    return ref_get_config(ARCH).reduced()


@pytest.mark.parametrize("jitted", [False, True], ids=["op_by_op", "jit"])
def test_mlp_bitwise(cfg, jitted):
    rng = np.random.default_rng(10)
    D, F = cfg.d_model, cfg.d_ff
    names = ("w_gate", "w_up", "w_down")
    shapes = ((D, F), (D, F), (F, D))
    pairs = {n: _pair(_grid(rng, s, 64.0)) for n, s in zip(names, shapes)}
    xj, xt = _pair(_grid(rng, (4, 256, D), 8.0))
    rp = {n: j for n, (j, _) in pairs.items()}
    tp = {n: t for n, (_, t) in pairs.items()}
    fn = jax.jit(RC.mlp) if jitted else RC.mlp
    want = fn(rp, xj)
    got = TC.mlp(tp, xt)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("jitted", [False, True], ids=["op_by_op", "jit"])
def test_expert_ffn_bitwise(cfg, jitted):
    """The experts' SiLU is f32, rounded to bf16 only after the up
    product, so ``F.silu``'s one rounding shows in few outputs: on this
    draw of 8 x 1,024 tokens, 65 of 524,288."""
    rng = np.random.default_rng(1)
    D, F = cfg.d_model, cfg.expert_d_ff or cfg.d_ff
    shapes = {"w_gate": (1, D, F), "w_up": (1, D, F), "w_down": (1, F, D)}
    pairs = {n: _pair(_grid(rng, s, 64.0)) for n, s in shapes.items()}
    rp = {n: j for n, (j, _) in pairs.items()}
    tp = {n: t for n, (_, t) in pairs.items()}
    rp["router"] = jnp.zeros((D, 1), jnp.float32)
    tp["router"] = torch.zeros((D, 1), dtype=torch.float32)
    xj, xt = _pair(_grid(rng, (8, 1024, D), 8.0))

    def ref(p, x):
        return RC.moe_ffn(p, x, top_k=1)

    want = (jax.jit(ref) if jitted else ref)(rp, xj)
    got = TC.moe_ffn(tp, xt, top_k=1)
    # with one expert and top-1 routing the FFN's output is the expert's
    w32 = {n: tp[n].to(torch.float32) for n in ("w_gate", "w_up")}
    ye = TC._expert_ffn(tp, xt.reshape(1, 1, -1, D), w32["w_gate"],
                        w32["w_up"])
    assert torch.equal(ye.reshape(got.shape), got)
    assert np.array_equal(_bits(got), _bits(want))
