"""The port's logical-axis sharding (``repro_torch/distributed/sharding.py``
and the logical-axes trees of ``repro_torch/models``) against the
reference's.

- The reference's own cases (``tests/test_sharding.py``: divisibility
  fixup, ensure-model, FSDP, rules filtered by the mesh, ``shard`` a no-op
  off a mesh), on the port.
- Rule parity: for every arch at full size, on a duck-typed (16, 16) and
  (2, 16, 16) mesh, the reference's ``fix_spec(logical_to_spec(axes))``
  with ``_ensure_axis`` / ``_add_fsdp`` over its axes trees and
  ``jax.eval_shape`` shapes, and the port's ``tree_shardings`` over its
  trees and meta shapes, give the same spec leaf for leaf: params (with
  and without FSDP), train state, the decode cache under the dry run's
  cache rules, the batch of every shape, and the int8 and int4
  ``quantize_tree`` trees.
- Every axes tree has its param tree's keys; placements put ("pod",
  "data") on one dim as Shard on both mesh dims, outer first.

No process group is made here (the dry run's fake group runs in
subprocesses, ``test_torch_dryrun.py``)."""
import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core import quantization as RQ
from repro.distributed import sharding as rsh
from repro.models import registry as RREG
from repro.training import train_step as RTS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core import quantization as Q
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun as D
from repro_torch.models.registry import batch_axes, get_model, input_specs
from repro_torch.training import train_step as TTS


class FakeMesh:
    """Duck-typed mesh with arbitrary axis sizes (no devices needed)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"pod": dict(data=16, model=16),
          "multi": dict(pod=2, data=16, model=16)}


# ------------------------------------------ the reference's own cases

class TestFixSpec:
    def test_drops_indivisible(self):
        m = FakeMesh(data=16, model=16)
        assert sh.fix_spec(m, (None, "model"), (10, 8)) == (None, None)

    def test_keeps_divisible(self):
        m = FakeMesh(data=16, model=16)
        assert sh.fix_spec(m, ("data", "model"), (32, 64)) == \
            ("data", "model")

    def test_tuple_axes(self):
        m = FakeMesh(pod=2, data=16)
        assert sh.fix_spec(m, (("pod", "data"),), (64,)) == \
            (("pod", "data"),)
        assert sh.fix_spec(m, (("pod", "data"),), (30,)) == (None,)


class TestEnsureAxis:
    def test_rehomes_model(self):
        m = FakeMesh(data=16, model=16)
        spec = sh._ensure_axis(m, (None, None, None), (60, 2048, 1408),
                               "model")
        assert spec == (None, "model", None)

    def test_noop_when_present(self):
        m = FakeMesh(model=16)
        assert sh._ensure_axis(m, ("model", None), (32, 64), "model") == \
            ("model", None)


class TestFSDP:
    def test_adds_pod_data(self):
        m = FakeMesh(pod=2, data=16, model=16)
        assert sh._add_fsdp(m, (None, "model", None), (9, 64, 24576)) == \
            (None, "model", ("pod", "data"))

    def test_skips_used_data(self):
        m = FakeMesh(data=16, model=16)
        assert sh._add_fsdp(m, ("data", "model"), (32, 64)) == \
            ("data", "model")

    def test_fallback_data_only(self):
        m = FakeMesh(pod=2, data=16, model=16)
        assert sh._add_fsdp(m, (None, "model"), (48, 64)) == \
            ("data", "model")


class TestRules:
    def test_rules_filtered_by_mesh(self):
        with sh.axis_rules(FakeMesh(model=1)):
            assert sh.logical_to_spec(("batch", "embed")) == (None, None)

    def test_shard_noop_without_mesh(self):
        x = torch.ones((4, 4))
        assert sh.shard(x, "batch", "embed") is x

    def test_tree_shardings_divisibility(self):
        tree = {"w": ("heads", None)}
        shapes = {"w": torch.empty((7, 3), device="meta")}
        out = sh.tree_shardings(FakeMesh(model=1), tree, shapes)
        assert out["w"].spec == ("model", None)
        out = sh.tree_shardings(FakeMesh(model=16), tree, shapes)
        assert out["w"].spec == (None, None)


def test_placements_order():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh(pod=2, data=16, model=16)
    spec = (("pod", "data"), None, "model")
    assert sh.placements(m, spec) == [Shard(0), Shard(0), Shard(2)]
    assert sh.placements(m, (None,)) == [Replicate()] * 3
    # an axis of one device places nothing
    assert sh.placements(FakeMesh(data=1, model=2), ("data", "model")) == \
        [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="axis order"):
        sh.placements(m, (("data", "pod"),))


# ------------------------------------------------------- rule parity

def _ref_spec(mesh, axes, shape, fsdp=False, ensure_model=False):
    spec = rsh.fix_spec(mesh, rsh.logical_to_spec(axes), shape)
    if ensure_model and len(shape) >= 2:
        spec = rsh._ensure_axis(mesh, spec, shape, "model")
    if fsdp and len(shape) >= 2:
        spec = rsh._add_fsdp(mesh, spec, shape)
    return tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def ref_specs(mesh, axes_tree, shapes_tree, rules=None, **kw):
    """The reference's specs of a tree, flat by key path."""
    out = {}
    with rsh.axis_rules(mesh, rules):
        def visit(axes, sds, path):
            if axes is None:              # a static leaf (max_len)
                return
            if _is_axes(axes):
                if hasattr(sds, "shape"):
                    out[path] = _ref_spec(mesh, axes, tuple(sds.shape), **kw)
                return
            for k in axes:
                visit(axes[k], sds[k], path + (k,))
        visit(axes_tree, shapes_tree, ())
    return out


def port_specs(mesh, axes_tree, shapes_tree, rules=None, **kw):
    out = {}

    def visit(s, t, path):
        if s is None or isinstance(s, sh.Sharding):
            if isinstance(t, torch.Tensor):
                spec = tuple(s.spec) + (None,) * (t.ndim - len(s.spec))
                out[path] = spec
            return
        for k in s:
            visit(s[k], t[k], path + (k,))
    visit(sh.tree_shardings(mesh, axes_tree, shapes_tree, rules=rules, **kw),
          shapes_tree, ())
    return out


def _keys(tree, path=()):
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= _keys(v, path + (k,))
        return out
    return {path}


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's eval_shape trees and axes, the port's meta
    trees and axes, at full size."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rm = RREG.get_model(ref_get_config(arch))
            tm = get_model(get_config(arch), "cpu")
            key = jax.random.PRNGKey(0)
            rp = jax.eval_shape(lambda: rm.init(key))
            tp = D.param_specs(tm)
            cache[arch] = (rm, tm, rp, tp)
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_equal_the_reference(arch, mesh_kind, trees):
    mesh = FakeMesh(**MESHES[mesh_kind])
    rm, tm, rp, tp = trees(arch)
    for fsdp in (False, True):
        want = ref_specs(mesh, rm.axes(), rp, fsdp=fsdp, ensure_model=True)
        got = port_specs(mesh, tm.axes(), tp, fsdp=fsdp, ensure_model=True)
        assert got == want, (arch, fsdp)
    rs = jax.eval_shape(lambda: RTS.init_train_state(
        rm, jax.random.PRNGKey(0)))
    ts_ = D.train_state_specs(tm)
    want = ref_specs(mesh, RTS.train_state_axes(rm), rs, ensure_model=True)
    got = port_specs(mesh, TTS.train_state_axes(tm), ts_, ensure_model=True)
    assert got == want and len(got) == 3 * len(_keys(tm.axes())) + 2
    for bits in (8, 4):
        rq = jax.eval_shape(lambda: RQ.quantize_tree(
            rm.init(jax.random.PRNGKey(0)), bits))
        tq = D.quant_specs(tp, bits)
        want = ref_specs(mesh, RQ.quant_tree_axes(rm.axes(), rp), rq,
                         ensure_model=True)
        got = port_specs(mesh, Q.quant_tree_axes(tm.axes(), tp), tq,
                         ensure_model=True)
        assert got == want, bits


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh_kind, trees):
    mesh = FakeMesh(**MESHES[mesh_kind])
    rm, tm, _, _ = trees(arch)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape, rshape in zip(SHAPES, REF_SHAPES):
        if shape_applicable(cfg, shape):
            continue
        want = ref_specs(mesh, RREG.batch_axes(rcfg, rshape),
                         RREG.input_specs(rcfg, rshape))
        got = port_specs(mesh, batch_axes(cfg, shape),
                         input_specs(cfg, shape))
        assert got == want, shape.name
        if shape.kind != "decode":
            continue
        rules = D.cache_rules(cfg, shape, mesh)
        rc = jax.eval_shape(lambda: rm.init_cache(shape.global_batch,
                                                  shape.seq_len))
        tc = D.cache_specs(tm, shape.global_batch, shape.seq_len)
        want = ref_specs(mesh, rm.cache_axes(), rc, rules=rules)
        want.pop(("cur",))         # the port's position is a host int
        got = port_specs(mesh, tm.cache_axes(), tc, rules=rules)
        assert got == want and got, shape.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_have_the_param_trees_keys(arch):
    tm = get_model(get_config(arch).reduced(), "cpu")
    assert _keys(tm.axes()) == _keys(tm.init(0))
    state = TTS.init_train_state(tm)
    assert _keys(TTS.train_state_axes(tm)) - {("step",), ("opt", "count")} \
        == _keys(state) - {("step",), ("opt", "count")}
    cache = tm.init_cache(2, 8)
    assert _keys(tm.cache_axes()) == _keys(cache)


def test_fake_group_module_imports_without_jax():
    """``launch/mesh.py`` is the one place that imports PyTorch's testing
    fake process group; a fresh interpreter imports it with no JAX."""
    import subprocess
    import sys
    code = ("import sys\n"
            "from torch.testing._internal.distributed.fake_pg import "
            "FakeStore\n"
            "import repro_torch.launch.mesh as m\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**__import__("os").environ,
                              "PYTHONPATH": "src"})
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
