"""The LM trainer of the port against the reference's: ``make_train_step``
(gradient accumulation and AdamW), ``grad_compress`` (int8 error
feedback) and ``launch/train.py`` (resume).

Tolerances and rules:
- the step's plumbing, on a model whose gradients are exact in both
  packages: losses, params and moments within rtol 1e-5 / atol 1e-8 (the
  AdamW test's bound), counts equal;
- the step on the reduced LMs, on the reference's batches: losses within
  rel 2e-3. Adam's first step moves each element by about lr times its
  gradient's sign, so a gradient near zero may move the other way in the
  other package (ROADMAP fault 5). bf16 activations put that floor far
  above float32's: each leaf's gradient differs from the reference's by
  up to ~2 % of its norm, so on the dense model every element more than
  one bf16 step off after one step must have a reference gradient within
  2 % of its leaf's largest (the retraining tests' rule, with the bf16
  floor). On the MoE models a near tie in the router (a top-2 margin of
  4e-4 in layer 2 of the reduced qwen2-moe, after bf16 differences of 0.03
  in its input) sends a token to another expert and moves whole
  gradients, so there every element is held to the reversal bound alone:
  within 2 lr (1 + wd |p|) a step of the reference's, plus one bf16 step;
- ``compress_grads``: codes, scales, error buffers and dequantized
  gradients bitwise, over 3 steps, against the reference jitted, as its
  trainer runs it (XLA fuses the error buffer's multiply and subtract);
  op by op the reference rounds the product first, and its buffers differ
  by at most half a float32 step of ``q * scale``;
- ``launch.train.main``: a run interrupted after step 4 and resumed from
  its step-3 checkpoint gives the uninterrupted run's losses and final
  state bit for bit."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import synthetic as RS
from repro.models import registry as RREG
from repro.training import grad_compress as RGC
from repro.training import optimizer as RO
from repro.training import train_step as RTS
from repro_torch.configs import get_config
from repro_torch.launch import train as TL
from repro_torch.models import common as TC
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as TCK
from repro_torch.training import grad_compress as TGC
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TTS

LR = 3e-3
OCFG = dict(lr=LR, warmup_steps=1, total_steps=10)


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(
        t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in batch.items()}


# ------------------------------------------------------------ plumbing

def _toy_models():
    """The same model in both packages whose loss gradients are exact:
    ``sum(c * w * w)`` over float32 leaves, ``c`` from the batch, so the
    gradient ``2 c w`` is one rounding of an exact product in both."""
    def r_loss(p, batch):
        c = batch["c"]
        return (jnp.sum(c.mean(0) * p["a"]["w"] * p["a"]["w"])
                + jnp.sum(c.mean(0)[0] * p["b"] * p["b"]))

    def t_loss(p, batch):
        c = batch["c"]
        return (torch.sum(c.mean(0) * p["a"]["w"] * p["a"]["w"])
                + torch.sum(c.mean(0)[0] * p["b"] * p["b"]))

    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "b": rng.standard_normal(3).astype(np.float32)}
    cfg = ref_get_config("stablelm-1.6b").reduced()
    ref = RREG.Model(cfg=cfg, init=lambda key: params, axes=None,
                     loss=r_loss)
    port = TREG.Model(cfg=get_config("stablelm-1.6b").reduced(),
                      init=lambda seed: TT.params_from_numpy(params, "cpu"),
                      loss=t_loss)
    batches = [{"c": rng.choice([0.5, 1.0, 2.0, 4.0], (4, 4, 3)).astype(
        np.float32)} for _ in range(3)]
    return ref, port, batches


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_plumbing_matches_reference(accum):
    """Three steps, microbatches split on the first axis and averaged."""
    ref, port, batches = _toy_models()
    r_state = RTS.init_train_state(ref, jax.random.PRNGKey(0))
    t_state = TTS.init_train_state(port, 0)
    r_step = RTS.make_train_step(ref, RO.AdamWConfig(**OCFG), accum)
    t_step = TTS.make_train_step(port, TO.AdamWConfig(**OCFG), accum)
    for b in batches:
        r_state, r_m = r_step(r_state, {"c": jnp.asarray(b["c"])})
        t_state, t_m = t_step(t_state, {"c": torch.from_numpy(b["c"])})
        for key in ("loss", "grad_norm", "lr"):
            assert float(t_m[key]) == pytest.approx(float(r_m[key]),
                                                    rel=1e-6), key
        for got, want in ((t_state["params"], r_state["params"]),
                          (t_state["opt"]["m"], r_state["opt"]["m"]),
                          (t_state["opt"]["v"], r_state["opt"]["v"])):
            for a, w in zip(TO.tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(_np(a), _np(w), rtol=1e-5,
                                           atol=1e-8)
        assert int(t_state["step"]) == int(r_state["step"])
        assert int(t_state["opt"]["count"]) == int(r_state["opt"]["count"])
    assert t_state["step"].dtype == torch.int32


# ------------------------------------------------------------ the LMs

def _bf16_step(a):
    return np.spacing(np.abs(a).astype(np.float32)) * 2 ** 16


@pytest.mark.parametrize("arch,accum", [
    ("stablelm-1.6b", 1), ("granite-moe-1b-a400m", 2),
    ("qwen2-moe-a2.7b", 1)])
def test_train_step_on_the_lm_matches_reference(arch, accum):
    rcfg, tcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rm, tm = RREG.get_model(rcfg), TREG.get_model(tcfg, "cpu")
    r_state = RTS.init_train_state(rm, jax.random.PRNGKey(0))
    params0 = r_state["params"]
    t_params = TT.params_from_numpy(jax.tree.map(np.asarray, params0), "cpu")
    t_state = {"params": t_params, "opt": TO.init_opt_state(t_params),
               "step": torch.zeros((), dtype=torch.int32)}
    r_step = jax.jit(RTS.make_train_step(rm, RO.AdamWConfig(**OCFG), accum))
    t_step = TTS.make_train_step(tm, TO.AdamWConfig(**OCFG), accum)
    batches = [RS.lm_batch(rcfg.vocab_size, 4, 16, step=i) for i in range(2)]
    g0 = jax.tree.leaves(jax.jit(jax.grad(rm.loss))(params0, batches[0]))
    wd = RO.AdamWConfig().weight_decay
    for i, b in enumerate(batches):
        prev = jax.tree.leaves(r_state["params"])
        r_state, r_m = r_step(r_state, b)
        t_state, t_m = t_step(t_state, _torch_batch(b))
        assert float(t_m["loss"]) == pytest.approx(float(r_m["loss"]),
                                                   rel=2e-3), i
        for a, w, p, g in zip(TO.tree_leaves(t_state["params"]),
                              jax.tree.leaves(r_state["params"]), prev, g0):
            got, want, p = _np(a), _np(w), _np(p)
            diff = np.abs(got - want)
            off = diff > _bf16_step(want)
            if i == 0 and tcfg.family == "dense":
                g = np.abs(_np(g))
                assert (g[off] <= 0.02 * g.max()).all(), g[off].max()
            bound = 2 * LR * (i + 1) * (1 + wd * np.abs(p)) \
                + _bf16_step(want)
            assert (diff <= bound).all(), float((diff - bound).max())
    assert int(t_state["step"]) == 2


# ------------------------------------------------------- grad compress

def _grad_trees(seed):
    rng = np.random.default_rng(seed)
    f32 = {"a": {"w": (rng.standard_normal((6, 5)) * 3).astype(np.float32)},
           "b": (rng.standard_normal(7) * 1e-3).astype(np.float32)}
    bf16 = jnp.asarray(rng.standard_normal((4, 9)).astype(np.float32)
                       ).astype(jnp.bfloat16)
    ref = {**f32, "c": bf16}
    port = {**TT.params_from_numpy(f32, "cpu"),
            "c": TC.tensor_from_numpy(np.asarray(bf16), "cpu")}
    return ref, port


def test_compress_grads_bitwise_over_three_steps():
    rq, r_compress = jax.jit(RGC.quantize_leaf), jax.jit(RGC.compress_grads)
    ref0, port0 = _grad_trees(0)
    r_err = RGC.init_error_state(ref0)
    t_err = TGC.init_error_state(port0)
    for step in range(3):
        ref, port = _grad_trees(step)
        for rg, tg, re, te in zip(jax.tree.leaves(ref), TO.tree_leaves(port),
                                  jax.tree.leaves(r_err),
                                  TO.tree_leaves(t_err)):
            q, s, e = TGC.quantize_leaf(tg, te)
            wq, ws, we = rq(rg, re)
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert np.array_equal(q.numpy(), np.asarray(wq))
            assert s.numpy().tobytes() == np.asarray(ws).tobytes()
            assert e.numpy().tobytes() == np.asarray(we).tobytes()
            _, _, eager = RGC.quantize_leaf(rg, re)
            step = np.spacing(np.abs(TGC.dequantize_leaf(q, s).numpy()))
            assert np.all(np.abs(np.asarray(eager) - e.numpy()) <= step / 2)
        r_deq, r_err = r_compress(ref, r_err)
        t_deq, t_err = TGC.compress_grads(port, t_err)
        for got, want in ((t_deq, r_deq), (t_err, r_err)):
            for a, w in zip(TO.tree_leaves(got), jax.tree.leaves(want)):
                assert a.dtype == torch.float32
                assert a.numpy().tobytes() == np.asarray(w).tobytes()
    assert any(float(e.abs().max()) > 0 for e in TO.tree_leaves(t_err))


# ------------------------------------------------------ the entry point

ARGS = ["--arch", "granite-moe-1b-a400m", "--reduced", "--batch", "4",
        "--seq", "16", "--log-every", "1", "--device", "cpu"]


class _Interrupted(Exception):
    pass


_MAKE_TRAIN_STEP = TTS.make_train_step


def _recording(monkeypatch, losses, stop_after=None):
    """Record every step's loss; raise after ``stop_after`` steps."""
    make = _MAKE_TRAIN_STEP

    def make_recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            if stop_after is not None and len(losses) == stop_after:
                raise _Interrupted
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].numpy().tobytes())
            return state, metrics
        return run
    monkeypatch.setattr(TTS, "make_train_step", make_recording)


def _main(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        loss = TL.main(argv)
    return loss, out.getvalue()


def test_train_resumes_bit_for_bit(monkeypatch, tmp_path):
    """6 steps straight through, against 6 steps with a checkpoint every 3
    that stop with an exception after step 4 and then run again: the second
    run resumes from step 3 and gives steps 4-6's losses, the final
    checkpoint and the returned loss bit for bit."""
    full, part, rest = [], [], []
    _recording(monkeypatch, full)
    loss_full, log = _main(ARGS + ["--steps", "6", "--ckpt-dir",
                                   str(tmp_path / "full"), "--ckpt-every",
                                   "6"])
    assert "[train] step 6/6 loss=" in log and "resumed" not in log
    ckpt = str(tmp_path / "cut")
    _recording(monkeypatch, part, stop_after=4)
    with pytest.raises(_Interrupted):
        _main(ARGS + ["--steps", "6", "--ckpt-dir", ckpt,
                      "--ckpt-every", "3"])
    assert part == full[:4] and TCK.latest_step(ckpt) == 3
    _recording(monkeypatch, rest)
    loss_rest, log = _main(ARGS + ["--steps", "6", "--ckpt-dir", ckpt,
                                   "--ckpt-every", "3"])
    assert "[train] resumed from step 3" in log
    assert "[train] checkpoints: [6]" in log
    assert rest == full[3:]
    assert loss_rest == loss_full
    tcfg = get_config("granite-moe-1b-a400m").reduced()
    template = TTS.init_train_state(TREG.get_model(tcfg, "cpu"), 0)
    a, step_a = TCK.restore(str(tmp_path / "full"), template)
    b, step_b = TCK.restore(ckpt, template)
    assert step_a == step_b == 6
    for x, y in zip(TO.tree_leaves(a), TO.tree_leaves(b)):
        assert torch.equal(x, y)


def test_train_options(monkeypatch, tmp_path):
    """``--accum 2 --compress-grads`` trains; minicpm-2b is switched to the
    WSD schedule (its first-step rate is the full lr, the cosine's would
    be half); a run already at its last step returns None; the audio
    family exits with the reference's message; ``--device cuda`` raises
    without a card."""
    loss, log = _main(ARGS + ["--steps", "2", "--accum", "2",
                              "--compress-grads"])
    assert np.isfinite(loss) and "step 2/2" in log
    _, log = _main(["--arch", "minicpm-2b", "--reduced", "--steps", "2",
                    "--batch", "2", "--seq", "8", "--log-every", "1",
                    "--device", "cpu"])
    assert "step 1/2 loss=" in log and "lr=3.00e-03" in log
    ckpt = str(tmp_path / "done")
    _main(ARGS + ["--steps", "1", "--ckpt-dir", ckpt])
    loss, log = _main(ARGS + ["--steps", "1", "--ckpt-dir", ckpt])
    assert loss is None and "nothing to do" in log
    audio = dataclasses.replace(get_config("stablelm-1.6b"), family="audio")
    monkeypatch.setattr(TL, "get_config", lambda arch: audio)
    with pytest.raises(SystemExit, match="train_sru_speech"):
        TL.main(["--device", "cpu"])
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TL.main(ARGS[:-2] + ["--steps", "1"])
