"""The port's VLM config (internvl2-26b: the InternLM2 backbone behind a
stub frontend that supplies precomputed patch embeddings) against the
reference's, reduced (4 layers, d_model 64, 4 patches), with the
reference's own ``init_lm(PRNGKey(0))`` weights carried across bitwise:
``Model.loss`` with ``patch_embeds`` prepended (the loss over the text
positions only) within rel 2e-3, as the other LM families' tests hold it;
and ``launch.train --reduced`` on it, resumed bit for bit."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import registry as RREG
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.launch import train as TL
from repro_torch.models import common as TC
from repro_torch.models import registry as TREG
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TTS

ARCH = "internvl2-26b"


def test_loss_with_patch_embeds_matches_reference():
    rcfg, tcfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert rcfg.family == "vlm" and rcfg.frontend_tokens == 4
    rparams = jax.jit(RT.init_lm, static_argnums=(1,))(
        jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(3)
    patches = jnp.asarray(rng.standard_normal(
        (2, rcfg.frontend_tokens, rcfg.d_model)).astype(np.float32)).astype(
        jnp.bfloat16)
    toks = rng.integers(0, rcfg.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "patch_embeds": patches,
             "labels": toks[:, 1:]}
    want = jax.jit(RREG.get_model(rcfg).loss)(rparams, batch)
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]),
              "patch_embeds": TC.tensor_from_numpy(np.asarray(patches),
                                                   "cpu"),
              "labels": torch.from_numpy(toks[:, 1:])}
    got = TREG.get_model(tcfg, "cpu").loss(tparams, tbatch)
    assert float(got) == pytest.approx(float(want), rel=2e-3)
    # the patches change the text positions' loss
    plain = TREG.get_model(tcfg, "cpu").loss(
        tparams, {k: v for k, v in tbatch.items() if k != "patch_embeds"})
    assert float(plain) != float(got)


def _main(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        loss = TL.main(argv)
    return loss, out.getvalue()


def test_launch_train_resumes_bit_for_bit(tmp_path):
    """``python -m repro_torch.launch.train --arch internvl2-26b
    --reduced`` (zero patch embeddings, as the reference's trainer feeds
    them): 4 steps straight through against 2 steps and then ``--steps
    4``, which resumes from step 2; the same final loss and checkpoint."""
    args = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
            "--schedule", "constant", "--log-every", "1", "--device", "cpu",
            "--ckpt-every", "2"]
    full, log = _main(args + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "full")])
    assert np.isfinite(full) and "step 4/4" in log
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
