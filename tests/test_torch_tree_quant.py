"""``quantize_tree`` / ``dequantize_tree`` (weight-quantized LM decode) in the
port against the reference's, bitwise in both directions: a tree either
package quantized dequantizes to the same bits in the other. Then the
port's memory-saving forms: chunked quantization and the lazy per-layer
dequantization (``DequantizedByLayer``) equal the whole-leaf results bit
for bit, and a decode step through the lazy tree gives the logits of one
through ``dequantize_tree``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import quantization as RQ
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.core import quantization as Q
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT

SHAPES = {"w": (3, 6, 10), "odd": (4, 7), "col": (5, 1), "bias": (9,)}


def _bits(a):
    a = TC.tensor_to_numpy(a) if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _trees(dtype, seed=0):
    """The same tree in both packages: ``dtype`` leaves (f32 or bf16) with
    an odd last axis, a width-1 column, a 1-D leaf, and exact halves and
    the max element so that rounding ties and the clip are exercised."""
    rng = np.random.default_rng(seed)
    ref = {}
    for name, shape in SHAPES.items():
        a = (rng.standard_normal(shape) * 2.0).astype(np.float32)
        ref[name] = jnp.asarray(a).astype(dtype)
    scale = float(jnp.max(jnp.abs(ref["w"].astype(jnp.float32)))) / 7
    ref["w"] = ref["w"].at[0, 0, :3].set(
        jnp.asarray([0.5, 1.5, -2.5], jnp.float32).astype(dtype) * scale)
    port = {k: TC.tensor_from_numpy(np.asarray(v), "cpu")
            for k, v in ref.items()}
    return ref, port


DTYPES = [jnp.float32, jnp.bfloat16]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_quantize_tree_bitwise(dtype, bits):
    ref, port = _trees(dtype)
    rq, tq = RQ.quantize_tree(ref, bits), Q.quantize_tree(port, bits)
    assert tq["bias"] is port["bias"]               # 1-D leaves untouched
    for name in ("w", "odd", "col"):
        assert tq[name]["q"].dtype == torch.int8
        assert tq[name]["scale"].dtype == torch.float32
        assert _bits(tq[name]["q"]) == _bits(rq[name]["q"]), name
        assert _bits(tq[name]["scale"]) == _bits(rq[name]["scale"]), name
    width = 7 if bits == 8 else 4                   # int4: padded and packed
    assert tq["odd"]["q"].shape == (4, width)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_dequantize_tree_bitwise_both_ways(dtype, bits):
    """The reference's codes dequantized by the port, and the port's by the
    reference, give the same bits as each package's own round trip."""
    ref, port = _trees(dtype, seed=1)
    rq, tq = RQ.quantize_tree(ref, bits), Q.quantize_tree(port, bits)
    rspec = jax.eval_shape(lambda: ref)
    tspec = Q.tree_spec(port)
    assert tspec["w"].device.type == "meta"
    want = RQ.dequantize_tree(rq, rspec, bits)
    rq_in_port = {k: ({"q": TC.tensor_from_numpy(np.asarray(v["q"]), "cpu"),
                       "scale": TC.tensor_from_numpy(np.asarray(v["scale"]),
                                                     "cpu")}
                      if isinstance(v, dict) else port[k])
                  for k, v in rq.items()}
    tq_in_ref = {k: ({"q": jnp.asarray(v["q"].numpy()),
                      "scale": jnp.asarray(v["scale"].numpy())}
                     if isinstance(v, dict) else ref[k])
                 for k, v in tq.items()}
    got_port = Q.dequantize_tree(rq_in_port, tspec, bits)
    got_ref = RQ.dequantize_tree(tq_in_ref, rspec, bits)
    own = Q.dequantize_tree(tq, tspec, bits)
    for name in SHAPES:
        assert _bits(got_port[name]) == _bits(want[name]), name
        assert _bits(got_ref[name]) == _bits(want[name]), name
        assert _bits(own[name]) == _bits(want[name]), name


def test_int4_codes_cover_the_range_and_round_half_to_even():
    """All 16 codes, -8..7, pack into nibbles (odd width: a zero pad) and
    come back sign-extended; w / scale at an exact half rounds to the even
    code, as ``jnp.round`` does, in the reference's packing."""
    codes = torch.arange(-8, 9, dtype=torch.int8)[None, :-1].repeat(2, 1)
    codes = torch.cat([codes, codes[:, :1]], dim=1)          # width 17
    packed = Q._pack_nibbles(codes)
    assert packed.shape == (2, 9)
    assert torch.equal(Q._unpack_nibbles(packed, 17), codes)
    w = torch.tensor([[7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -7.0, 3.0]])
    tq = Q.quantize_tree({"w": w}, 4)                        # scale 1.0
    assert float(tq["w"]["scale"]) == 1.0
    assert Q._unpack_nibbles(tq["w"]["q"], 9).tolist() == \
        [[7, 0, 2, 2, 0, -2, -2, -7, 3]]
    rq = RQ.quantize_tree({"w": jnp.asarray(w.numpy())}, 4)
    assert np.array_equal(tq["w"]["q"].numpy(), np.asarray(rq["w"]["q"]))


def test_bits_other_than_8_or_4_raise():
    with pytest.raises(ValueError, match="8 or 4"):
        Q.quantize_tree({"w": torch.ones((2, 2))}, 2)


@pytest.mark.parametrize("bits", [8, 4])
def test_chunked_quantization_equals_whole_leaf(monkeypatch, bits):
    """Quantizing and dequantizing a leaf in chunks of its leading axis
    (``TREE_CHUNK_ELEMS``: here 20 elements, so rows of a (3, 6, 10) leaf
    go one by one and a (4, 7) leaf two rows at a time) gives the bits of
    one whole-leaf pass."""
    _, port = _trees(jnp.bfloat16, seed=2)
    whole = Q.quantize_tree(port, bits)
    spec = Q.tree_spec(port)
    deq = Q.dequantize_tree(whole, spec, bits)
    monkeypatch.setattr(Q, "TREE_CHUNK_ELEMS", 20)
    assert len(Q._chunks(3, 60)) == 3 and len(Q._chunks(4, 7)) == 2
    chunked = Q.quantize_tree(port, bits)
    for name in ("w", "odd", "col"):
        assert torch.equal(chunked[name]["q"], whole[name]["q"]), name
        assert torch.equal(chunked[name]["scale"], whole[name]["scale"])
    for name, leaf in Q.dequantize_tree(chunked, spec, bits).items():
        assert _bits(leaf) == _bits(deq[name]), name


@pytest.fixture(scope="module")
def moe_model():
    rcfg = ref_get_config("qwen2-moe-a2.7b").reduced()
    tcfg = get_config("qwen2-moe-a2.7b").reduced()
    rparams = RT.init_lm(jax.random.PRNGKey(0), rcfg)
    return tcfg, TT.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                      "cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_lazy_per_layer_dequantization_is_bitwise(moe_model, bits):
    """Every layer that ``DequantizedByLayer`` dequantizes alone (the
    stacked norms become (L, D) leaves and are quantized too, as in the
    reference) equals that layer of ``dequantize_tree``'s output, and so do
    the top-level leaves; a prefill and a decode step through it give the
    logits of the whole dequantized tree, bit for bit."""
    cfg, params = moe_model
    spec = Q.tree_spec(params)
    qtree = Q.quantize_tree(params, bits)
    assert "q" in qtree["blocks"]["norm1"]
    full = Q.dequantize_tree(qtree, spec, bits)
    lazy = Q.DequantizedByLayer(qtree, spec, bits)
    for i in range(cfg.n_layers):
        want = TT.layer(full["blocks"], i)
        got = TT.layer(lazy["blocks"], i)
        flat_w, flat_g = (TC.tree_map(_bits, t) for t in (want, got))
        assert flat_g == flat_w, i
    for key in ("embed", "lm_head", "final_norm"):
        assert key in lazy and _bits(lazy[key]) == _bits(full[key])
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 6)))
    outs = []
    for p in (full, lazy):
        lp, cache = TT.prefill(p, cfg, toks[:, :5], max_len=6)
        ld, _ = TT.decode_step(p, cfg, cache, toks[:, 5:6])
        outs.append((lp, ld))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
