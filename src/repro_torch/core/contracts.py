"""Contract checks of the search hot path, on executed runs.

Port of the reference package's ``tools/analysis/contracts.py::
check_harness``. The reference traces each registered harness
(``core/target_registry.py``) to a jaxpr and reads the contracts off the
graph. An eager PyTorch program has no such graph, so here each contract
is a check on an executed run: a ``TorchDispatchMode`` records every aten
op the run dispatches (name, operand shapes and dtypes, devices, and
whether each operand was made inside the run), and the kernel wrappers
(``kernels/ops.py::observe_launches``) add each CUDA kernel launch with its
operands. On the CPU the harnesses run the plain lanes; on a card they run
through ``bank_mxv_pop``, ``bank_qmm_pop`` and ``sru_scan_pop`` at widths
(4, 6, 12, 16) far below every tile, where a mask or index fault of a
hand-written kernel would leak one lane into another.

C1  gather, don't requantize: in the banked ``forward_pop`` every rounding
    op (``aten.round``, and a float-to-integer cast, which is what packing
    codes lowers to) carries the marker dim (3) in its operand shapes, so
    it is an activation fake-quant. Sanity: the requantizing lane
    (``banks=None``) must show a rounding op without the marker.
C1-packed  for targets with ``make_packed_banks`` (the SRU): the packed
    lane's rounding ops carry the marker too, and no op or kernel reads a
    float32 tensor of bank-stack shape ``(|menu|,) + W.shape`` that existed
    before the run (f32 rows may exist only as in-run dequantization
    intermediates, as on the CPU's plain lane). Sanity: the f32 lane must
    show such a read.
C2  no float64: no op of any lane's forward has a float64 operand or
    result.
C3  donation: not applicable. The reference checks that the per-generation
    dispatch donates its qp-stack buffer to XLA. Eager PyTorch has no
    buffer donation: every call allocates its outputs from the caching
    allocator, which reuses a freed block on its own, and there is nothing
    to annotate or check. It is reported as not applicable.
C4  one dispatch: scoring a generation through ``make_evaluator()``
    dispatches the population forward once per compile bucket, syncs the
    host never (no ``aten._local_scalar_dense``) and copies from the device
    to the host once on a card (on the CPU the host is the device: none).
    On a card, the kernel launches of one dispatch equal what the harness's
    layers give (``expected_launches``).
C5  lane independence, shown empirically in both bank formats, for
    ``forward_pop`` and for ``forward_decode``: for each lane p, change lane
    p's allocation (and, for decode, its input chunk); every other lane's
    output must stay bitwise equal, and lane p's must change. Sanity: a
    forward that flips its output along the population axis, and one that
    normalises by a cross-lane mean, must both fail the check.

``python -m repro_torch.core.contracts [--targets sru xlstm] [--device
cuda|cpu]`` prints one JSON line of findings per target and exits 1 on
any finding.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import batched_eval
from repro_torch.core import target_registry
from repro_torch.kernels import ops as kops

CONTRACTS = ("C1", "C1-packed", "C2", "C3", "C4", "C5")
C3_NOT_APPLICABLE = ("not applicable: eager PyTorch has no buffer "
                     "donation to check")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    target: str
    message: str

    def format(self) -> str:
        return f"{self.path}:1 {self.rule} [{self.target}] {self.message}"


@dataclasses.dataclass
class Operand:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str
    made_in_run: bool


@dataclasses.dataclass
class Op:
    name: str                  # aten op packet name, or a kernel's name
    kernel: bool
    inputs: List[Operand]
    outputs: List[Operand]


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched inside the block and, through
    ``kops.observe_launches``, every kernel launch. An operand counts as
    made in the run when its storage is that of a tensor an op of the run
    returned (a view of a pre-existing tensor is not)."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self._made = set()
        self._observer = None

    def __enter__(self):
        self._observer = kops.observe_launches(self.kernel)
        self._observer.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observer.__exit__(*exc)

    @staticmethod
    def _key(t: torch.Tensor):
        if t.numel() == 0 or t.device.type == "meta":
            return None
        return (t.device.type, t.untyped_storage().data_ptr())

    def _operand(self, t: torch.Tensor) -> Operand:
        return Operand(tuple(t.shape), t.dtype, t.device.type,
                       self._key(t) in self._made)

    def _add(self, name: str, kernel: bool, ins, outs) -> None:
        op = Op(name, kernel, [self._operand(t) for t in ins], [])
        # a view (or in-place result) of a pre-existing operand stays so
        older = {self._key(t) for t, o in zip(ins, op.inputs)
                 if not o.made_in_run}
        for t in outs:
            key = self._key(t)
            if key is not None and key not in older:
                self._made.add(key)
        op.outputs = [self._operand(t) for t in outs]
        self.ops.append(op)

    def kernel(self, name, inputs, outputs) -> None:
        self._add(name, True, inputs, outputs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self._add(func.overloadpacket.__name__, False, ins, outs)
        return out


def record(fn: Callable[[], object]) -> Tuple[object, Recorder]:
    """Run ``fn`` under a fresh recorder (no autograd)."""
    rec = Recorder()
    with torch.no_grad(), rec:
        out = fn()
    return out, rec


# ---------------------------------------------------------------- helpers

def _is_rounding(op: Op) -> bool:
    if op.kernel:
        return False
    if op.name == "round":
        return True
    if op.name in ("_to_copy", "copy_") and op.inputs and op.outputs:
        src = op.inputs[-1] if op.name == "copy_" else op.inputs[0]
        return src.dtype.is_floating_point and not (
            op.outputs[0].dtype.is_floating_point
            or op.outputs[0].dtype == torch.bool)
    return False


def _shapes(op: Op) -> List[tuple]:
    return [o.shape for o in op.inputs + op.outputs]


def _has_marker(op: Op, marker_dim: int) -> bool:
    return any(marker_dim in s for s in _shapes(op))


def _f64_ops(rec: Recorder) -> List[str]:
    return sorted({f"`{op.name}`" for op in rec.ops
                   if any(o.dtype == torch.float64
                          for o in op.inputs + op.outputs)})


def _stack_reads(rec: Recorder, stack_shapes) -> List[tuple]:
    """(op, shape) of every read of a pre-existing f32 bank-stack."""
    return [(op.name, o.shape) for op in rec.ops for o in op.inputs
            if o.dtype == torch.float32 and not o.made_in_run
            and o.shape in stack_shapes]


def _w_leaf_shapes(tree) -> List[tuple]:
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "W" and isinstance(v, torch.Tensor):
                out.append(tuple(v.shape))
            else:
                out += _w_leaf_shapes(v)
    return out


def _contract_allocs(layer_names: Sequence[str], menu: Sequence[int],
                     pop: int = 4) -> List[dict]:
    """P=4 allocations cycling the menu so every layer exercises several
    (w_bits, a_bits) rows. pop=4 deliberately != the marker dim 3."""
    pairs = [(menu[i % len(menu)], menu[(i + 1) % len(menu)])
             for i in range(len(menu))]
    return [{name: pairs[(p + i) % len(pairs)]
             for i, name in enumerate(layer_names)}
            for p in range(pop)]


def _other_alloc(alloc: dict, menu: Sequence[int]) -> dict:
    """Every layer at the menu's widest (w_bits, a_bits), or the next
    widest where ``alloc`` is that already. A harness's coarse lanes can
    round every logit to zero, so a wide allocation is what surely moves
    a lane's output."""
    top = max(menu)
    alt = {n: (top, top) for n in alloc}
    if alt == alloc:
        second = sorted(menu)[-2]
        alt = {n: (second, second) for n in alloc}
    return alt


def _qp_stack(target, allocs, names, device) -> torch.Tensor:
    return torch.from_numpy(batched_eval.stack_qps(
        [target.qp_for(a) for a in allocs], list(names))).to(device)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(width[a.element_size()])
        b = b.contiguous().view(width[b.element_size()])
    return bool(torch.equal(a, b))


def _launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    after = kops.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def expected_launches(h, lane: str) -> Optional[Dict[str, int]]:
    """Kernel launches of one dispatch on a card, from the harness's
    layers, by the rule of the full models: a Bi-SRU of L layers runs 2L
    scans and 3L MxVs (2L SRU, L-1 projections, the FC), the evaluator's
    f32 lane serving layer 0's two MxVs from its u-bank; an xLSTM runs 5
    MxVs an mLSTM block, 2 + T an sLSTM block (its recurrent MxV once a
    time step) and 1 for the head. ``lane``: "f32", "packed" or
    "evaluator". None for an architecture without a rule."""
    cfg = h.target.cfg
    if hasattr(cfg, "n_sru_layers"):
        L = cfg.n_sru_layers
        mxv = 3 * L
        if lane == "packed":
            return {"bank_qmm_pop": mxv, "sru_scan_pop": 2 * L}
        if lane == "evaluator" and cfg.input_dim != cfg.hidden:
            mxv -= 2
        return {"bank_mxv_pop": mxv, "sru_scan_pop": 2 * L}
    if getattr(cfg, "family", None) == "ssm":
        T = h.marker_dim
        n = sum(5 if nm[0] == "m" else 2 + T if nm[0] == "s" else 1
                for nm in h.layer_names)
        return {"bank_mxv_pop": n}
    return None


# ---------------------------------------------------------------- checks

def _lane_flip(fwd):
    def flipped(params, feats, qp_stack, banks=None):
        return fwd(params, feats, qp_stack, banks).flip(0)
    return flipped


def _lane_mean(fwd):
    def mixed(params, feats, qp_stack, banks=None):
        out = fwd(params, feats, qp_stack, banks)
        return out - out.mean(dim=0, keepdim=True)
    return mixed


def lane_moves(run, allocs, menu, feats_for=None) -> List[str]:
    """C5 on one forward: ``run(allocs, feats)`` -> (P, ...) outputs. For
    each lane p, lane p's allocation (and, with ``feats_for(p)``, its
    input) changes; returns a message per lane that moved another lane or
    did not move itself."""
    with torch.no_grad():
        base = run(allocs, None if feats_for is None else feats_for(None))
        msgs = []
        for p in range(len(allocs)):
            alt = list(allocs)
            alt[p] = _other_alloc(allocs[p], menu)
            out = run(alt, None if feats_for is None else feats_for(p))
            moved = [q for q in range(len(allocs))
                     if q != p and not _same_bits(out[q], base[q])]
            if moved:
                msgs.append(f"changing lane {p} moved lanes {moved}")
            if _same_bits(out[p], base[p]):
                msgs.append(f"changing lane {p} left its own output "
                            "unchanged: the check cannot see it")
    return msgs


def check_harness(h) -> Tuple[List[Finding], dict]:
    """Run C1-C5 against one ContractHarness. Returns the findings (empty
    = every contract holds) and a report: each contract's verdict, the
    kernel launches of each lane's dispatch, the evaluator's dispatches
    and readbacks a generation, and the seconds taken."""
    t0 = time.perf_counter()
    findings: List[Finding] = []

    def fail(rule: str, msg: str) -> None:
        findings.append(Finding(rule, h.anchor_path, h.name, msg))

    target = h.target
    menu = tuple(target.menu)
    dev = h.feats.device
    on_card = dev.type == "cuda"
    allocs = _contract_allocs(h.layer_names, menu)
    qp = _qp_stack(target, allocs, h.layer_names, dev)
    params = target.params
    banks = target.make_banks(params)
    make_packed = getattr(target, "make_packed_banks", None)
    pbanks = make_packed(params) if make_packed is not None else None
    launches: Dict[str, Dict[str, int]] = {}

    def run_lane(label, bank_set):
        before = kops.launch_counts()
        _, rec = record(lambda: h.forward_pop(params, h.feats, qp, bank_set))
        launches[label] = _launch_delta(before)
        return rec

    # --- C1: the banked forward never requantizes a weight --------------
    banked = run_lane("forward_pop f32", banks)
    rounds = [op for op in banked.ops if _is_rounding(op)]
    if not rounds:
        fail("C1", "banked forward_pop has no rounding op at all: the "
             "activation fake-quant disappeared from the eval path")
    for op in rounds:
        if not _has_marker(op, h.marker_dim):
            fail("C1", f"banked forward_pop runs a rounding op "
                 f"`{op.name}` on shapes {_shapes(op)} without the "
                 f"activation marker dim {h.marker_dim}: a weight is "
                 "being re-quantized instead of gathered from the banks")
    requant = None
    if h.supports_requant:
        _, requant = record(lambda: h.forward_pop(params, h.feats, qp, None))
        if not any(not _has_marker(op, h.marker_dim)
                   for op in requant.ops if _is_rounding(op)):
            fail("C1", "sanity: the requantizing lane (banks=None) shows "
                 "no rounding op without the marker: the weight-quantize "
                 "detector cannot discriminate on this harness")

    # --- C1-packed: the packed lane ships integers, not f32 stacks ------
    packed = None
    if pbanks is not None:
        packed = run_lane("forward_pop packed", pbanks)
        for op in packed.ops:
            if _is_rounding(op) and not _has_marker(op, h.marker_dim):
                fail("C1-packed", f"packed forward_pop runs a rounding op "
                     f"`{op.name}` on shapes {_shapes(op)} without the "
                     f"activation marker dim {h.marker_dim}: a weight is "
                     "being re-quantized instead of dequantized from the "
                     "packed containers")
        stacks = {(len(menu),) + s for s in _w_leaf_shapes(params)}
        leaked = _stack_reads(packed, stacks)
        if leaked:
            fail("C1-packed", "packed forward_pop reads f32 bank stacks "
                 f"made before the run: {sorted(set(leaked))}; the packed "
                 "lane must ship integer containers + scales")
        if not _stack_reads(banked, stacks):
            fail("C1-packed", "sanity: the f32-bank lane reads no f32 "
                 "bank stack at any weight shape: the packed-lane leak "
                 "detector cannot discriminate on this harness")

    # --- C5: lane independence, both formats, forward and decode --------
    def pop_run(fwd, bank_set):
        return lambda al, _f: fwd(params, h.feats,
                                  _qp_stack(target, al, h.layer_names, dev),
                                  bank_set)

    formats = [("f32", banks)] + ([("packed", pbanks)]
                                  if pbanks is not None else [])
    decode_runs = {}
    for fmt, bank_set in formats:
        for msg in lane_moves(pop_run(h.forward_pop, bank_set), allocs,
                              menu):
            fail("C5", f"forward_pop ({fmt} banks) is not lane-"
                 f"independent: {msg}")
    if h.forward_decode is not None:
        P = len(allocs)
        lane0 = h.feats[:1].expand((P,) + tuple(h.feats.shape[1:]))

        def chunks(p):
            if p is None:
                return lane0.contiguous()
            f = lane0.clone()
            f[p] = h.feats[1]
            return f

        for fmt, bank_set in formats:
            def dec(al, f, b=bank_set):
                return h.forward_decode(
                    params, f, _qp_stack(target, al, h.layer_names, dev), b)
            before = kops.launch_counts()
            _, decode_runs[fmt] = record(lambda d=dec: d(allocs, chunks(None)))
            launches[f"forward_decode {fmt}"] = _launch_delta(before)
            for msg in lane_moves(dec, allocs, menu, chunks):
                fail("C5", f"forward_decode ({fmt} banks) is not lane-"
                     f"independent: {msg}")
    for label, wrap in (("flipped along the population axis", _lane_flip),
                        ("normalised by a cross-lane mean", _lane_mean)):
        if not lane_moves(pop_run(wrap(h.forward_pop), banks), allocs, menu):
            fail("C5", f"sanity: a forward whose output is {label} passed "
                 "the lane-independence check: the detector is not live "
                 "on this harness")

    # --- C2: no float64 in any lane's forward ---------------------------
    runs = {"banked": banked, "requant": requant, "packed": packed}
    runs.update({f"decode ({k})": v for k, v in decode_runs.items()})
    for label, rec in runs.items():
        if rec is not None:
            for name in _f64_ops(rec):
                fail("C2", f"{label} forward: {name} has a float64 operand "
                     "or result")

    # --- C4: one dispatch a generation, one readback --------------------
    ev = h.make_evaluator()
    dispatches = readbacks = None
    if not getattr(ev, "_folded", False):
        fail("C4", "harness evaluator is not in the folded regime "
             "(equal-shape validation subsets): the one-dispatch contract "
             "cannot hold")
    else:
        ev.errors(allocs, params)          # builds and caches the banks
        calls: List[int] = []
        real = ev._batch_err

        def counting(*args):
            calls.append(1)
            return real(*args)

        ev._batch_err = counting
        try:
            before = kops.launch_counts()
            _, rec = record(lambda: ev.errors(allocs, params))
            launches["evaluator"] = _launch_delta(before)
        finally:
            ev._batch_err = real
        dispatches = len(calls)
        syncs = sum(op.name == "_local_scalar_dense" for op in rec.ops)
        d2h = sum(1 for op in rec.ops if not op.kernel
                  and any(o.device != "cpu" for o in op.inputs)
                  and any(o.device == "cpu" for o in op.outputs))
        readbacks = syncs + d2h
        if dispatches != 1:
            fail("C4", f"scoring one generation dispatched the population "
                 f"forward {dispatches} times (expected exactly 1: folded "
                 "subsets, one compile bucket)")
        if syncs:
            fail("C4", f"scoring one generation synced the host {syncs} "
                 "times (aten._local_scalar_dense)")
        if d2h != int(on_card):
            fail("C4", f"scoring one generation copied from the device to "
                 f"the host {d2h} times (expected {int(on_card)})")
    if on_card:
        lanes = {"forward_pop f32": "f32", "forward_pop packed": "packed",
                 "forward_decode f32": "f32",
                 "forward_decode packed": "packed", "evaluator": "evaluator"}
        for label, got in launches.items():
            want = expected_launches(h, lanes[label])
            if want is not None and got != want:
                fail("C4", f"{label}: kernel launches {got} != {want}, "
                     "what the harness's layers give")
    elif any(launches.values()):
        fail("C4", f"kernel launches on the CPU: {launches}")

    failed = {f.rule for f in findings}
    verdicts = {}
    for c in CONTRACTS:
        if c == "C3":
            verdicts[c] = C3_NOT_APPLICABLE
        elif c == "C1-packed" and pbanks is None:
            verdicts[c] = "not applicable: no packed banks"
        else:
            verdicts[c] = "fail" if c in failed else "pass"
    report = {"target": h.name, "device": str(dev), "contracts": verdicts,
              "findings": [f.format() for f in findings],
              "launches": launches,
              "dispatches_per_generation": dispatches,
              "readbacks_per_generation": readbacks,
              "seconds": time.perf_counter() - t0}
    return findings, report


def run_contracts(targets: Optional[Sequence[str]] = None, device="cuda"
                  ) -> Tuple[List[Finding], List[dict]]:
    """Check every registered target (or the named subset). A harness that
    fails to build or run is a C0 finding, so the checker reports instead
    of dying."""
    names = list(targets) if targets else \
        target_registry.list_contract_targets()
    findings: List[Finding] = []
    reports = []
    for name in names:
        t0 = time.perf_counter()
        try:
            h = target_registry.get_contract_harness(name, device=device)
            f, rep = check_harness(h)
        except Exception as e:  # noqa: BLE001 - the checker must report
            f = [Finding("C0", "src/repro_torch/core/target_registry.py",
                         name, f"contract harness failed: "
                         f"{type(e).__name__}: {e}")]
            rep = {"target": name, "device": str(device),
                   "findings": [x.format() for x in f],
                   "seconds": time.perf_counter() - t0}
        findings += f
        reports.append(rep)
    return findings, reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.contracts",
        description="Check the search hot path's contracts (C1-C5) on each "
        "registered target's harness; one JSON line per target.")
    ap.add_argument("--targets", nargs="*", default=None,
                    help="targets to check (default: all registered)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    findings, reports = run_contracts(args.targets, args.device)
    for rep in reports:
        print(json.dumps(rep), flush=True)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
