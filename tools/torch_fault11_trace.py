"""Where fault 11's last 0.0313 comes from (ROADMAP §3, fault 11).

    PYTHONPATH=src python tools/torch_fault11_trace.py

On the CPU, on ``tools/torch_jit_parity.py``'s fixtures, prints one JSON
line a finding:

- ``seamless_norm``: the reduced seamless-m4t encoder's first two blocks
  under ``jax.jit``, then the final norm. The norm's input is bitwise the
  port's; its mean and ``rsqrt`` part from torch's on that input (rows
  differing, largest difference), and XLA:CPU's mean is reproduced by
  summing each row in windows of 32, each in order, then the windows;
- ``rsqrt``: ``lax.rsqrt`` under ``jit`` on 1e6 f32 values in [1e-3, 4):
  its share that is correctly rounded and its agreement with
  ``torch.rsqrt``;
- ``jamba_expert_gate``: the first Mamba block's expert gate product,
  ``einsum("ecd,edf->ecf", preferred_element_type=f32)`` jitted against
  ``torch.bmm`` on the same bf16 inputs (f32 outputs differing, largest
  difference, and each against the f64 product rounded), and the f32 SiLU
  after it on one input;
- ``substituted``: ``torch_jit_parity.py``'s audio and hybrid rows with
  the port's ``rms_norm`` replaced by the jitted reference's.
"""
from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_jit_parity as P  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import mamba as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


def _rows_apart(a, b) -> dict:
    a, b = P._np(a).ravel(), P._np(b).ravel()
    return {"differ": int((a != b).sum()), "of": int(a.size),
            "max_abs": float(np.abs(a - b).max())}


def _sequential(x: np.ndarray) -> np.float32:
    s = np.float32(0)
    for v in x:
        s = np.float32(s + v)
    return s


def seamless_norm() -> dict:
    arch = "seamless-m4t-medium"
    rcfg, tcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rparams = jax.jit(RE.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    frames = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 12, rcfg.frontend_dim)).astype(np.float32)).astype(jnp.bfloat16)

    def two_blocks(p, x):
        pos = jnp.arange(x.shape[1])[None, :]

        def body(h, bp):
            hn = RC.rms_norm(h, bp["norm1"], rcfg.norm_eps)
            q, k, v = RC.attn_qkv(bp["attn"], hn, pos, rcfg.rope_theta)
            h = h + RC.attn_out(bp["attn"], RC.gqa_attention(
                q, k, v, causal=False))
            hn = RC.rms_norm(h, bp["norm2"], rcfg.norm_eps)
            return h + RC.mlp(bp["ffn"], hn), None
        x, _ = jax.lax.scan(jax.checkpoint(body), x,
                            jax.tree.map(lambda a: a[:2], p["enc"]))
        return x

    x_ref = jax.jit(two_blocks)(rparams, frames)
    with torch.no_grad():
        x = TC.tensor_from_numpy(np.asarray(frames), "cpu")
        pos = torch.arange(x.shape[1])[None, :]
        for i in range(2):
            x = TE._enc_block(TT.layer(tparams["enc"], i), tcfg, x, pos)
    xf = jnp.asarray(x_ref, jnp.float32)
    var_ref = jax.jit(lambda a: jnp.mean(a * a, -1, keepdims=True))(xf)
    tx = torch.from_numpy(np.array(xf))
    var_t = torch.mean(tx * tx, dim=-1, keepdim=True)
    sq = (np.asarray(xf) ** 2).reshape(-1, xf.shape[-1]).astype(np.float32)
    windows = np.array([_sequential(
        [_sequential(r[i:i + 32]) for i in range(0, r.size, 32)])
        / np.float32(r.size) for r in sq], np.float32)
    eps = rcfg.norm_eps
    rs_ref = jax.jit(lambda v: jax.lax.rsqrt(v + eps))(var_ref)
    rs_t = torch.rsqrt(torch.from_numpy(np.array(var_ref)) + eps)
    out_ref = jax.jit(lambda a, w: RC.rms_norm(a, w, eps))(
        x_ref, rparams["enc_norm"])
    out_t = TC.rms_norm(x, tparams["enc_norm"], eps)
    return {"input": _rows_apart(x, x_ref), "mean": _rows_apart(
        var_t, var_ref), "mean_in_windows_of_32_equal": int(
        (windows == np.asarray(var_ref).ravel()).sum()),
        "rsqrt_same_input": _rows_apart(rs_t, rs_ref),
        "output": _rows_apart(out_t, out_ref)}


def rsqrt() -> dict:
    v = (np.random.default_rng(0).random(1_000_000).astype(np.float32) * 4
         + 1e-3).astype(np.float32)
    xla = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(v)))
    exact = (1.0 / np.sqrt(v.astype(np.float64))).astype(np.float32)
    t = torch.rsqrt(torch.from_numpy(v)).numpy()
    return {"xla_correctly_rounded": float((xla == exact).mean()),
            "torch_equal_to_xla": float((t == xla).mean())}


def jamba_expert_gate() -> dict:
    rcfg, tcfg, rparams, tparams = P._pair("jamba-1.5-large-398b", True)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(
        np.int32)
    bp = jax.tree.map(lambda a: a[0, 0], rparams["mamba_blocks"])

    def hn2(p, t):
        x = RT.embed_tokens(p, rcfg, t, None)
        hn = RC.rms_norm(x, bp["norm1"], rcfg.norm_eps)
        return RC.rms_norm(x + RM.mamba_fwd(bp["mamba"], rcfg, hn),
                           bp["norm2"], rcfg.norm_eps)

    g = jax.jit(hn2)(rparams, jnp.asarray(tokens))
    g = g.reshape(-1, g.shape[-1])
    xe = jnp.broadcast_to(g[None], (bp["ffn"]["w_gate"].shape[0],) + g.shape)
    ref = jax.jit(lambda a, w: jnp.einsum(
        "ecd,edf->ecf", a, w, preferred_element_type=jnp.float32))(
        xe, bp["ffn"]["w_gate"])
    wg = TT.mamba_layer(tparams["mamba_blocks"], 0, 0)["ffn"]["w_gate"]
    xt = torch.from_numpy(np.array(jnp.asarray(xe, jnp.float32)))
    got = torch.bmm(xt, wg.float())
    f64 = torch.bmm(xt.double(), wg.double()).float()
    silu_ref = jax.jit(jax.nn.silu)(ref)
    silu_t = TC.silu(torch.from_numpy(np.array(ref)))
    return {"product": _rows_apart(got, ref),
            "xla_vs_f64_rounded": _rows_apart(f64, ref)["differ"],
            "torch_vs_f64_rounded": _rows_apart(f64, got)["differ"],
            "silu_same_input": _rows_apart(silu_t, silu_ref)}


def substituted() -> list:
    plain = TC.rms_norm

    @functools.lru_cache(maxsize=None)
    def jitted(eps):
        return jax.jit(lambda a, w: RC.rms_norm(a, w, eps))

    def reference_norm(x, w, eps=1e-5):
        def to_jax(t):
            a = jnp.asarray(t.detach().float().numpy())
            return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 \
                else a
        out = jitted(eps)(to_jax(x), to_jax(w))
        return torch.from_numpy(np.array(jnp.asarray(out, jnp.float32))).to(
            x.dtype)

    TC.rms_norm = reference_norm
    try:
        return [{k: row[k] for k in row if k in (
            "arch", "prompt", "capacity_factor", "encode", "forward",
            "prefill", "max")} for fam in ("audio", "hybrid")
            for row in P.run(fam)]
    finally:
        TC.rms_norm = plain


def main() -> None:
    torch.set_num_threads(1)
    with torch.no_grad():
        for name, fn in (("seamless_norm", seamless_norm), ("rsqrt", rsqrt),
                         ("jamba_expert_gate", jamba_expert_gate),
                         ("substituted", substituted)):
            print(json.dumps({name: fn()}), flush=True)


if __name__ == "__main__":
    main()
