"""The port's configurations, shapes and input specs against the
reference's: every config equal field for field, in its analytic
parameter counts and in ``reduced()``; ``input_specs`` gives the
reference's shapes for every (arch, shape) cell, and ``make_dummy_batch``
seeded tensors of those shapes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.configs import get_config as ref_get_config
from repro.models import registry as RREG
from repro_torch.configs import base as TB
from repro_torch.configs import get_config
from repro_torch.models import registry as TREG

PORTED = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "minicpm-2b",
          "starcoder2-7b", "stablelm-1.6b", "deepseek-67b", "xlstm-350m",
          "sru_timit", "jamba-1.5-large-398b", "internvl2-26b",
          "seamless-m4t-medium")
LM = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "minicpm-2b",
      "starcoder2-7b", "stablelm-1.6b", "deepseek-67b", "xlstm-350m",
      "jamba-1.5-large-398b", "internvl2-26b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if arch not in LM:
        return                      # the SRU's config has no LM counts
    for r, p in ((ref, port), (ref.reduced(), port.reduced())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.n_params() == r.n_params()
        assert p.n_active_params() == r.n_active_params()
        assert p.padded_vocab == r.padded_vocab


def test_moe_parameter_counts():
    granite = get_config("granite-moe-1b-a400m")
    assert granite.n_params() == 1_384_912_896
    assert granite.n_active_params() == 478_943_232
    qwen = get_config("qwen2-moe-a2.7b")
    assert qwen.n_params() == 14_315_487_232
    assert qwen.n_active_params() == 2_688_876_544


def test_shapes_equal_reference():
    assert [dataclasses.asdict(s) for s in TB.SHAPES] == \
        [dataclasses.asdict(s) for s in RB.SHAPES]
    assert set(TB.SHAPES_BY_NAME) == set(RB.SHAPES_BY_NAME)
    for arch in LM:
        for shape in TB.SHAPES:
            want = RB.shape_applicable(ref_get_config(arch),
                                       RB.SHAPES_BY_NAME[shape.name])
            got = TB.shape_applicable(get_config(arch), shape)
            assert (got is None) == (want is None), (arch, shape.name)
        assert TB.reduced_shape(TB.SHAPES[0]) == TB.ShapeConfig(
            "train_4k", 32, 2, "train")


@pytest.mark.parametrize("arch", LM)
def test_input_specs_match_reference(arch):
    for shape in TB.SHAPES:
        want = RREG.input_specs(ref_get_config(arch),
                                RB.SHAPES_BY_NAME[shape.name])
        got = TREG.input_specs(get_config(arch), shape)
        assert set(got) == set(want)
        for k, spec in got.items():
            if k == "max_len":              # the audio family's cache length
                assert spec == want[k]
                continue
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == want[k].shape, (k, shape.name)
            assert str(spec.dtype).split(".")[-1] == str(want[k].dtype)


def test_make_dummy_batch_is_seeded():
    cfg = get_config("qwen2-moe-a2.7b")
    shape = TB.reduced_shape(TB.SHAPES_BY_NAME["train_4k"])
    a = TREG.make_dummy_batch(cfg, shape, seed=3, device="cpu")
    b = TREG.make_dummy_batch(cfg, shape, seed=3, device="cpu")
    c = TREG.make_dummy_batch(cfg, shape, seed=4, device="cpu")
    assert set(a) == {"tokens", "labels"}
    assert a["tokens"].shape == (2, 32) and a["tokens"].dtype == torch.int32
    assert int(a["tokens"].max()) < cfg.vocab_size
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    want = jax.tree.map(np.shape, RREG.make_dummy_batch(
        ref_get_config("qwen2-moe-a2.7b"), RB.reduced_shape(
            RB.SHAPES_BY_NAME["train_4k"])))
    assert {k: tuple(v.shape) for k, v in a.items()} == want
    vlm = dataclasses.replace(cfg, family="vlm", frontend="patch",
                              frontend_tokens=4)
    d = TREG.make_dummy_batch(vlm, shape, device="cpu")
    assert d["patch_embeds"].dtype == torch.bfloat16
    assert d["patch_embeds"].shape == (2, 4, cfg.d_model)
    audio = TREG.make_dummy_batch(get_config("seamless-m4t-medium"), shape,
                                  seed=3, device="cpu")
    assert set(audio) == {"frames", "dec_tokens", "labels"}
    assert audio["frames"].shape == (2, 32, 1024)
    assert audio["frames"].dtype == torch.bfloat16
