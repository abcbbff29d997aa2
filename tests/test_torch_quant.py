"""Port parity, tier 1 (bitwise): quantization grids, fake-quant values,
bank rows, packed containers and their bit layout, menu indices and qp
stacks of ``repro_torch`` against the JAX reference ``repro``, on inputs
made from a seed with numpy. Also: ``import repro_torch`` stays free of
JAX, and no port module imports the reference."""
import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_eval as RB
from repro.core import quantization as RQ
from repro.kernels import ref as RR
from repro.models import sru as RM
from repro_torch.core import batched_eval as TB
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ref as TR
from repro_torch.models import sru as TM

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
MENU = (2, 4, 8, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _triples(w):
    """Menu triples of ``w`` as the targets build them: MMSE clips for the
    int grids, the data range for 16-bit."""
    return RQ.menu_triples(MENU, lambda b: float(np.abs(w).max()) if b == 16
                           else RQ.mmse_clip(w, b))


def _assert_bitwise(port, ref):
    """``torch.equal`` on the reference's values: same dtype, shape and
    every element equal (-0.0 == +0.0, as the packed lane's contract has
    it: a 0 code dequantizes to +0 where the f32 bank row holds -0)."""
    ref = torch.from_numpy(np.array(ref))
    port = port.detach().cpu()
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert torch.equal(port, ref), \
        f"max |diff| {(port.double() - ref.double()).abs().max()}"


@pytest.mark.parametrize("bits", MENU)
@pytest.mark.parametrize("clip", [0.013, 0.5, 1.0, 3.7, 1000.0])
def test_quant_triple_is_a_copy(bits, clip):
    assert TQ.quant_triple(bits, clip) == RQ.quant_triple(bits, clip)


@pytest.mark.parametrize("scale", [1e-3, 0.3, 1.0, 2.0, 77.0])
def test_fixed_point_16_bitwise(scale):
    w = _weights(int(scale * 1000), (37, 11), scale)
    _assert_bitwise(TQ.fixed_point_16(_t(w)), RQ.fixed_point_16(jnp.asarray(w)))


@pytest.mark.parametrize("bits", MENU)
@pytest.mark.parametrize("use_ste", [True, False])
def test_fake_quant_triple_bitwise(bits, use_ste):
    x = _weights(bits, (5, 7, 13), 2.0)
    s, lo, hi = (np.float32(v) for v in RQ.quant_triple(
        bits, 1.3 if bits != 16 else 3.0))
    ref = RQ.fake_quant_triple(jnp.asarray(x), jnp.float32(s),
                               jnp.float32(lo), jnp.float32(hi),
                               use_ste=use_ste)
    _assert_bitwise(TQ.fake_quant_triple(_t(x), s, lo, hi, use_ste=use_ste),
                    ref)


def test_per_lane_grids_match_scalar_grids():
    """Broadcast (P, 1, 1) grids give each lane its scalar-grid values."""
    x = _weights(3, (4, 6, 9), 1.5)
    trips = np.asarray([RQ.quant_triple(b, 1.1) for b in MENU], np.float32)
    lanes = TQ.fake_quant_triple(_t(x), *(_t(trips[:, c]).reshape(4, 1, 1)
                                          for c in range(3)))
    for p in range(4):
        assert torch.equal(lanes[p], TQ.fake_quant_triple(_t(x[p]),
                                                          *trips[p]))


@pytest.mark.parametrize("shape", [(23, 33), (6, 5), (40, 17)])
def test_bank_rows_bitwise(shape):
    w = _weights(sum(shape), shape, 0.4)
    trips = _triples(w)
    _assert_bitwise(TQ.build_weight_bank(_t(w), trips),
                    RQ.build_weight_bank(jnp.asarray(w), trips))


@pytest.mark.parametrize("shape", [(23, 33), (6, 5), (1, 3), (40, 17)])
def test_packed_containers_bitwise(shape):
    """Every container and the scale column equal the reference's, at
    contraction lengths that leave sub-byte containers partly filled."""
    w = _weights(7 * shape[0], shape, 0.4)
    w[0, 0] = -np.abs(w).max() * 4          # clips to every grid's lo
    trips = _triples(w)
    port = TQ.build_packed_weight_bank(_t(w), trips)
    ref = RQ.build_packed_weight_bank(jnp.asarray(w), trips)
    assert set(port) == set(ref)
    for key in ref:
        _assert_bitwise(port[key], ref[key])
    assert int(port["q2"][0, 0]) & 0x3 == 0x2          # code -2, low bits
    # dequantizing rebuilds the f32 bank rows bitwise
    _assert_bitwise(TQ.dequant_packed_bank(port),
                    RQ.build_weight_bank(jnp.asarray(w), trips))
    assert TQ.packed_bank_nbytes(port) == RQ.packed_bank_nbytes(ref)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 5, 8, 23])
def test_pack_layout_matches_reference(bits, k):
    lo, hi = RQ.INT_RANGES[bits]
    rng = np.random.default_rng(bits * 100 + k)
    q = rng.integers(lo, hi + 1, (k, 9)).astype(np.int8)
    q[0] = lo                                   # the most negative code
    packed = TR.pack_weights(_t(q), bits)
    _assert_bitwise(packed, RR.pack_weights(jnp.asarray(q), bits))
    _assert_bitwise(TR.unpack_weights(packed, bits, k),
                    RR.unpack_weights(jnp.asarray(np.asarray(packed)), bits, k))
    assert np.array_equal(TR.unpack_weights(packed, bits, k).numpy(), q)


def test_menu_index_from_hi():
    his = np.asarray([[1.0, 7.0, 127.0, 32767.0], [32767.0, 1.0, 1.0, 7.0]],
                     np.float32)
    _assert_bitwise(TQ.menu_index_from_hi(_t(his)),
                    RQ.menu_index_from_hi(jnp.asarray(his)))
    assert TQ.menu_index_from_hi(_t(his)).tolist() == [[0, 1, 2, 3],
                                                       [3, 0, 0, 1]]


def test_qp_dicts_and_stacks_bitwise():
    names = RM.layer_names_for(3)
    rng = np.random.default_rng(5)
    wclips = {(n, b): float(rng.uniform(0.1, 2)) for n in names
              for b in (2, 4, 8)}
    act = {n: float(rng.uniform(0.5, 20)) for n in names}
    wr = {n: float(rng.uniform(0.5, 3)) for n in names}
    allocs = [{n: (int(rng.choice(MENU)), int(rng.choice(MENU)))
               for n in names} for _ in range(9)]
    ref_qps = [RM.quant_triples_for(a, wclips, act, wr) for a in allocs]
    port_qps = [TM.quant_triples_for(a, wclips, act, wr) for a in allocs]
    assert port_qps == ref_qps
    ref_stack = RB.stack_qps(ref_qps, names)
    port_stack = TB.stack_qps(port_qps, names)
    assert port_stack.dtype == ref_stack.dtype
    assert np.array_equal(port_stack.view(np.uint8), ref_stack.view(np.uint8))
    assert [TB.bucket_size(p) for p in (1, 3, 16, 17, 40, 65, 130)] == \
        [RB.bucket_size(p) for p in (1, 3, 16, 17, 40, 65, 130)]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_mmse_clip_and_compression_helpers(bits):
    w = _weights(bits, (300,), 0.7)
    assert TQ.mmse_clip(_t(w), bits) == RQ.mmse_clip(w, bits)
    lw = {"a": 100, "b": 37}
    lb = {"a": bits, "b": 16}
    assert TQ.compressed_bits(lw, lb, 12) == RQ.compressed_bits(lw, lb, 12)
    assert TQ.compression_ratio(lw, lb, 12) == RQ.compression_ratio(lw, lb, 12)


def test_act_range_calibrator():
    ref, port = RQ.ActRangeCalibrator(), TQ.ActRangeCalibrator()
    for i in range(5):
        x = _weights(i, (3, 4), i + 1.0)
        ref.observe("L0", jnp.asarray(x))
        port.observe("L0", _t(x))
    assert port.expected_ranges() == ref.expected_ranges()


# ----------------------------------------------------------- import hygiene

def _port_modules():
    mods = []
    for f in sorted(PORT_ROOT.rglob("*.py")):
        rel = f.relative_to(PORT_ROOT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_repro_torch_leaves_jax_out():
    """Importing the port, and each of its modules, loads no JAX and
    nothing of the reference package (fresh interpreter)."""
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    src = str(PORT_ROOT.parent)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr


def _reference_imports(files):
    offenders = []
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in ("repro", "jax", "jaxlib"):
                    offenders.append(f"{f.name}:{node.lineno} {n}")
    return offenders


def test_no_port_file_imports_the_reference():
    assert _reference_imports(sorted(PORT_ROOT.rglob("*.py"))) == []


def test_card_scripts_import_no_reference():
    """The scripts that drive the port on the card, at the repo root."""
    root = PORT_ROOT.parent.parent
    assert _reference_imports([root / "chip_smoke.py",
                               root / "xlstm_train_probe.py"]) == []
