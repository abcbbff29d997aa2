"""The port's LM logits against the jitted reference's, family by family.

    PYTHONPATH=src python tools/torch_jit_parity.py [--family lm moe ...]

On the CPU, on the inputs and weights of the port's parity tests
(``tests/test_torch_{lm,moe,vlm,encdec,hybrid}.py``: each reduced config's
reference ``init_lm(PRNGKey(0))`` weights, carried across bitwise by
``params_from_numpy``, and the tests' seeded prompts), prints one JSON
line a model with the largest absolute difference of the forward's
logits, the prefill's and each teacher-forced decode step's against the
reference run under ``jax.jit``, as its users run it. The hybrid runs at
``MOE_CAPACITY_FACTOR`` 8.0 and at the served 1.25, on its test's prompt
and on ROADMAP fault 11's. ~1 min of one core.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as RC
from repro.models import encdec as RE
from repro.models import registry as RREG
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import common as TC
from repro_torch.models import encdec as TE
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT

FAMILIES = ("lm", "moe", "vlm", "audio", "hybrid")


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(
        t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _diff(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _pair(arch, jit_init):
    rcfg, tcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    init = jax.jit(RT.init_lm, static_argnums=(1,)) if jit_init \
        else RT.init_lm
    rparams = init(jax.random.PRNGKey(0), rcfg)
    return rcfg, tcfg, rparams, TT.params_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu")


def decoder(arch, tokens, prompt, jit_init=False, greedy=0,
            extra=None) -> dict:
    """Forward on ``tokens`` (with ``extra`` patch embeddings), prefill of
    the first ``prompt`` tokens, then one decode step a later token (with
    ``greedy`` > 0, that many steps fed the reference's greedy picks
    instead); fresh jitted functions, so that a capacity set before the
    call is traced."""
    rcfg, tcfg, rparams, tparams = _pair(arch, jit_init)
    T = prompt + greedy if greedy else tokens.shape[1]
    with torch.no_grad():
        got = TT.forward(tparams, tcfg, torch.from_numpy(tokens),
                         None if extra is None else TC.tensor_from_numpy(
                             np.asarray(extra), "cpu"))
    want = jax.jit(lambda p, t, e: RT.forward(p, rcfg, t, e))(
        rparams, jnp.asarray(tokens), extra)
    out = {"arch": arch, "forward": _diff(got, want)}
    if extra is not None:
        return out
    rl, rc = jax.jit(lambda p, t: RT.prefill(p, rcfg, t, max_len=T))(
        rparams, jnp.asarray(tokens[:, :prompt]))
    tl, tc = TT.prefill(tparams, tcfg, torch.from_numpy(tokens[:, :prompt]),
                        max_len=T)
    out["prefill"] = _diff(tl, rl)
    r_decode = jax.jit(lambda p, c, t: RT.decode_step(p, rcfg, c, t))
    steps = []
    for t in range(prompt, T - 1 if greedy else T):
        tok = (np.asarray(jnp.argmax(rl[:, -1], axis=-1))[:, None]
               if greedy else tokens[:, t:t + 1]).astype(np.int32)
        rl, rc = r_decode(rparams, rc, jnp.asarray(tok))
        tl, tc = TT.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
        steps.append(_diff(tl, rl))
    out["decode_steps"] = steps
    out["max"] = max([out["forward"], out["prefill"]] + steps)
    return out


def audio() -> dict:
    """``tests/test_torch_encdec.py``'s fixture: encode, forward, prefill
    (BOS) and 4 teacher-forced decode steps."""
    arch = "seamless-m4t-medium"
    rcfg, tcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rparams = jax.jit(RE.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(2)
    frames = jnp.asarray(rng.standard_normal(
        (2, 12, rcfg.frontend_dim)).astype(np.float32)).astype(jnp.bfloat16)
    tokens = rng.integers(0, rcfg.vocab_size, (2, 11)).astype(np.int32)
    tframes = TC.tensor_from_numpy(np.asarray(frames), "cpu")
    with torch.no_grad():
        enc = TE.encode(tparams, tcfg, tframes)
        got = TE.forward(tparams, tcfg, tframes,
                         torch.from_numpy(tokens[:, :-1]))
    out = {"arch": arch, "encode": _diff(enc, jax.jit(
        RE.encode, static_argnums=(1,))(rparams, rcfg, frames)),
        "forward": _diff(got, jax.jit(RE.forward, static_argnums=(1,))(
            rparams, rcfg, frames, jnp.asarray(tokens[:, :-1])))}
    rm, tm = RREG.get_model(rcfg), TREG.get_model(tcfg, "cpu")
    rl, rc = jax.jit(lambda p, f: rm.prefill(p, {"frames": f,
                                                 "max_len": 6}))(
        rparams, frames)
    tl, tc = tm.prefill(tparams, {"frames": tframes, "max_len": 6})
    out["prefill"] = _diff(tl, rl)
    r_decode, steps = jax.jit(rm.decode), []
    for t in range(4):
        tok = tokens[:, t:t + 1]
        rl, rc = r_decode(rparams, rc, {"token": jnp.asarray(tok)})
        tl, tc = tm.decode(tparams, tc, {"token": torch.from_numpy(tok)})
        steps.append(_diff(tl, rl))
    out["decode_steps"] = steps
    out["max"] = max([out["forward"], out["prefill"]] + steps)
    return out


def run(family: str):
    if family == "lm":
        tokens = np.random.default_rng(0).integers(0, 256, (4, 12)).astype(
            np.int32)
        yield decoder("stablelm-1.6b", tokens, 12, greedy=8)
    elif family == "moe":
        for arch in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b"):
            tokens = np.random.default_rng(1).integers(0, 256, (2, 12)) \
                .astype(np.int32)
            yield decoder(arch, tokens, 8)
    elif family == "vlm":
        rng = np.random.default_rng(3)
        rcfg = ref_get_config("internvl2-26b").reduced()
        patches = jnp.asarray(rng.standard_normal(
            (2, rcfg.frontend_tokens, rcfg.d_model)).astype(
            np.float32)).astype(jnp.bfloat16)
        tokens = rng.integers(0, rcfg.vocab_size, (2, 13)).astype(np.int32)
        yield decoder("internvl2-26b", tokens[:, :-1], 12, jit_init=True,
                      extra=patches)
        yield decoder("internvl2-26b", tokens, 8, jit_init=True)
    elif family == "audio":
        yield audio()
    else:
        saved = RC.MOE_CAPACITY_FACTOR, TC.MOE_CAPACITY_FACTOR
        try:
            for cap in (8.0, 1.25):
                RC.MOE_CAPACITY_FACTOR = TC.MOE_CAPACITY_FACTOR = cap
                for name, shape in (("test", (2, 12)), ("fault11", (2, 9))):
                    tokens = np.random.default_rng(1).integers(
                        0, 256, shape).astype(np.int32)
                    yield {"capacity_factor": cap, "prompt": name,
                           **decoder("jamba-1.5-large-398b", tokens, 8,
                                     jit_init=True)}
        finally:
            RC.MOE_CAPACITY_FACTOR, TC.MOE_CAPACITY_FACTOR = saved


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--family", nargs="*", choices=FAMILIES,
                    default=list(FAMILIES))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for fam in args.family:
        for row in run(fam):
            print(json.dumps({"family": fam, **row}), flush=True)


if __name__ == "__main__":
    main()
