"""Count a step's work: FLOPs, HBM bytes, kernel launches and live memory.

Counterpart of the reference package's ``roofline/hlo_analysis.py``. The
reference parses the compiled step's HLO; an eager program has none, so
``count(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` and counts
what it dispatches, on an executed run (CPU or card) or on meta tensors
(shapes and dtypes, no storage: the counterpart of ``jax.eval_shape``).

- ``flops``: the matmul-class aten ops (mm, bmm, addmm, baddbmm,
  convolution, SDPA), with the formulas of ``torch.utils.flop_counter``'s
  ``flop_registry``, plus the kernels' GEMMs; the reference also counts
  only dots and convolutions. ``flops_by_dtype`` splits them by operand
  dtype, so that ``report.py`` prices a bf16 product at the tensor-core
  rate and an f32 product at the CUDA-core rate.
- ``hbm_bytes``: the eager stream. Every aten op is its own kernel, so it
  reads its operands and writes its outputs; view and metadata ops cost
  nothing (a broadcast operand is charged its distinct elements). The
  counterpart of the reference's "bytes at fusion boundaries".
- The kernel wrappers of ``kernels/ops.py`` report their own counts on
  entry, by formula, whichever lane then runs (the CUDA kernel, the plain
  version on the CPU, or a meta output), and the aten ops of a wrapper's
  body are not counted: a path counts the same on the CPU, on the card
  and on meta tensors, and fusing or replacing a kernel does not change
  the work counted. ``elementwise_flops`` holds the scans' arithmetic.
- ``min_hbm_bytes``: the floor no implementation beats. Every storage that
  existed before the step (its arguments and what it closes over) is
  charged once for what the step reads of it and once for what it writes
  into it (the views it touches, at most the storage's size; a kernel's
  bank operand only its rows by index), and every output the step makes is
  written once.
- Memory: ``argument_bytes`` (the storages that existed before the step,
  declared or read), ``temp_bytes`` (the high-water mark of the storages
  the step made, alive at once) and ``output_bytes`` (those it returns);
  ``reckoned_peak_bytes`` is the first plus the second. Storages are
  followed by weak references, so a freed intermediate leaves the count.
- Trip counts: ``trips(n)`` is ``range(n)`` except under a counter, where
  a loop of more than four trips runs four: the first two, one middle trip
  whose counts are multiplied by n - 3, and the last, as the reference
  multiplies a loop body by its trip count (``hlo_analysis.py:265``). The
  trips at either end run as themselves, so what differs there (a zero
  initial state and what the second trip frees of the first's, a skipped
  last update, the order in which the backward pass sums a stacked
  weight's gradients) is counted as it happens. Fold only loops whose
  middle trips have the same shapes: the layer loops, the train step's
  microbatches, the decode loop's tokens, the sLSTM's steps and the chunk
  loops of the flash branch, the mLSTM and the Mamba scan. The backward pass of a folded loop runs after it, in
  autograd: every op it runs under an autograd node made in a middle trip
  (``torch._C._current_autograd_node``, whose sequence number lies in the
  trip's range) takes the trip's multiplier, a checkpointed block's
  recomputation included. Memory is not multiplied, but what a middle
  trip leaves alive (its net growth, a remat-saved block input or a
  state appended to a list) is held n - 4 more times from the end of the
  middle trip, and let go with the storages that carry it: at once when
  they are freed in the forward pass, once the backward pass has left the
  middle trip's nodes when they are freed in it. A loop that collects a
  value a trip passes its list through ``fill_trips``, which repeats the
  middle trip's entry (detached, so that the backward pass sums nothing
  the unfolded loop does not).

- Collectives (a step on DTensors, ``distributed/sharding.py``): DTensor
  runs each op on the local shards, which are what is counted (per-device
  numbers, as the reference's post-partitioning HLO), and moves data with
  the functional collectives (``_c10d_functional.*``). Each is priced
  with the reference's ring model (``hlo_analysis.py:14-16``) on its
  group of n ranks: all-gather the local input times (n-1), reduce-scatter
  and all-to-all the input times (n-1)/n, all-reduce the input times
  2(n-1)/n, broadcast the input once; into ``ici_bytes``,
  ``collective_bytes_by_type`` and ``n_collectives`` (they move no HBM
  bytes here). DTensor's own metadata propagation (the global-shape ops it
  runs under a fake-tensor mode) is not counted.

``top_contributors(fn, *args)`` lists the aten ops and kernels by FLOPs and
by bytes. A count reads no tensor's values, so meta tensors go through the
whole step; an op that needs data (``.item()``) raises on meta.
"""
from __future__ import annotations

import itertools
import weakref
from dataclasses import asdict, dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import dtensor_type

aten = torch.ops.aten

# ops that allocate without writing, or re-view a storage: no bytes
_ZERO_COST = {aten.empty.memory_format, aten.empty_strided.default,
              aten.empty_like.default, aten.new_empty.default,
              aten.new_empty_strided.default, aten._unsafe_view.default,
              aten.lift_fresh.default, aten.resize_.default,
              aten.set_.source_Storage_storage_offset}
# in-place ops that write ``self`` without reading it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default, aten.normal_.default,
               aten.uniform_.default, aten.random_.default}

# ops whose last output / operand is a scratch buffer that only the CPU
# kernel fills (log_sigmoid's: the CUDA kernel returns it empty); it is
# not charged, so that a path counts the same on either device
_SCRATCH_OUT = {aten.log_sigmoid_forward.default}
_SCRATCH_IN = {aten.log_sigmoid_backward.default: 2}

_ACTIVE: List["Counter"] = []

# the functional collectives' ring-model factor of the input bytes on n
# ranks, by the reference's type names
_RING = {"all_reduce": ("all-reduce", lambda n: 2 * (n - 1) / n),
         "all_gather_into_tensor": ("all-gather", lambda n: n - 1),
         "reduce_scatter_tensor": ("reduce-scatter", lambda n: (n - 1) / n),
         "all_to_all_single": ("all-to-all", lambda n: (n - 1) / n),
         "broadcast": ("broadcast", lambda n: 1.0)}
_FAKE_KEY = torch._C._TorchDispatchModeKey.FAKE




def _group_size(args) -> int:
    """The rank count of a functional collective's group (its last string
    argument names it)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


@dataclass
class RooflineCounts:
    """One step's counts (the reference's fields first)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    collective_bytes_by_type: Dict[str, float] = field(default_factory=dict)
    n_collectives: int = 0
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    # the collective bytes split by "<type>/<dtype>" (e.g. all-reduce/
    # bfloat16): what --bf16-partials moves
    collective_bytes_by_dtype: Dict[str, float] = field(default_factory=dict)
    elementwise_flops: float = 0.0
    min_hbm_bytes: float = 0.0
    launches: Dict[str, float] = field(default_factory=dict)
    argument_bytes: int = 0
    # of argument_bytes, the older storages the step read without being
    # handed them (what it closes over: a cached constant table)
    closure_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0          # written in place into older storages
    n_ops: int = 0

    @property
    def reckoned_peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes

    def as_dict(self) -> dict:
        out = asdict(self)
        out["reckoned_peak_bytes"] = self.reckoned_peak_bytes
        return out


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a view spans (a stride-0 axis, a
    broadcast, is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _view_key(t: torch.Tensor):
    return (t.storage_offset(), tuple(t.shape), tuple(t.stride()))


def _tensors(obj):
    """The tensors in a (nested) tuple / list / dict of an op's args or a
    step's result; a DTensor's local shard."""
    if isinstance(obj, torch.Tensor):
        yield obj._local_tensor if isinstance(obj, dtensor_type()) else obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _meta_key(obj):
    """A hashable key of an op's arguments that fixes the metadata of its
    result on meta tensors: each tensor's shape, strides and dtype, each
    other argument with its type (1, 1.0 and True promote differently)."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), tuple(obj.stride()), obj.dtype)
    if isinstance(obj, (tuple, list)):
        return (type(obj),) + tuple(_meta_key(x) for x in obj)
    return (type(obj), obj)


class _OpInfo(NamedTuple):
    view: bool            # returns a view: no bytes, no storage
    aliasing: bool        # mutates or aliases an argument
    mutable: bool
    written: tuple        # indices of the arguments it writes in place
    zero_cost: bool
    write_only: bool
    scratch_out: bool
    scratch_in: Optional[int]
    formula: object       # flop_registry's formula, or None
    name: str


_OP_INFO: Dict = {}


def _op_info(func) -> _OpInfo:
    """What the counter needs of an op's schema, read once an op."""
    info = _OP_INFO.get(func)
    if info is None:
        schema = func._schema
        info = _OP_INFO[func] = _OpInfo(
            view=any(r.alias_info is not None and not r.alias_info.is_write
                     for r in schema.returns),
            aliasing=schema.is_mutable or any(r.alias_info is not None
                                              for r in schema.returns),
            mutable=schema.is_mutable,
            written=tuple(i for i, a in enumerate(schema.arguments)
                          if a.alias_info is not None
                          and a.alias_info.is_write),
            zero_cost=func in _ZERO_COST, write_only=func in _WRITE_ONLY,
            scratch_out=func in _SCRATCH_OUT,
            scratch_in=_SCRATCH_IN.get(func),
            formula=flop_registry.get(func.overloadpacket),
            name=str(func.overloadpacket.__name__))
    return info


def _flat(seq, out: list) -> list:
    """Append the tensors of ``seq`` (nested tuples and lists) to ``out``."""
    for x in seq:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            _flat(x, out)
    return out


def _call_weakly(ref, method: str, key: int) -> None:
    """A storage's finalizer: calls the counter's ``method`` if the
    counter is still alive, so that a long-lived storage does not keep the
    counter that saw it alive."""
    counter = ref()
    if counter is not None:
        getattr(counter, method)(key)


class Counter(TorchDispatchMode):
    """The dispatch mode behind ``count``; use it as a context manager to
    count a block (``finish(result)`` then gives the counts)."""

    def __init__(self, arguments=(), fold_trips: bool = True):
        super().__init__()
        self.fold_trips = fold_trips
        self.counts = RooflineCounts()
        self.by_op: Dict[str, List[float]] = {}     # name: [flops, bytes, calls]
        self._mult = 1
        self._ranges: List = []          # closed middle trips: (s0, s1, k)
        self._node_mult: Dict[int, int] = {}
        self._phantom: Dict = {}         # storage key: [bytes, s0]
        self._deferred: List = []        # [bytes, s0] freed in the backward
        self._ids: Dict[int, int] = {}   # storage key: order of making
        self._logs: List[list] = []      # what open trips make, in order
        self._next_id = itertools.count()
        self._hi = 0                     # high-water of the open middle trip
        self._suppress = 0
        self._open = False
        self._made: Dict[int, int] = {}            # live storages of the step
        self._live = 0
        self._peak = 0
        self._pre: Dict[int, int] = {}             # older storages: bytes
        self._copies: Dict = {}                    # of them: trips each
        self._reads: Dict[int, Dict] = {}
        self._writes: Dict[int, Dict] = {}
        self._tombs = itertools.count()          # keys of freed older storages
        self._meta_cache: Dict = {}
        self._declared = {self._note_pre(t) for t in _tensors(arguments)}

    # ---------------------------------------------------------- storages
    def _note_pre(self, t: torch.Tensor) -> Optional[int]:
        """The key of ``t``'s storage if it existed before the step (so it
        is charged to the arguments), else None."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._made:
            return None
        if key not in self._pre:
            self._pre[key] = st.nbytes()
            weakref.finalize(st, _call_weakly, weakref.ref(self), "_retire",
                             key)
            if self._open:
                # first seen inside the step (a buffer made where no mode
                # sees it, as DTensor's redistributions on a fake group
                # make some): in a middle trip it stands for a storage a
                # trip
                m = self._m()
                if m > 1:
                    self._copies[key] = m
        return key

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._made or key in self._pre:
            return
        nbytes = st.nbytes()
        self._made[key] = nbytes
        self._ids[key] = i = next(self._next_id)
        for log in self._logs:
            log.append((key, i))
        self._grow(nbytes)
        weakref.finalize(st, _call_weakly, weakref.ref(self), "_free", key)

    def _grow(self, nbytes: int) -> None:
        self._live += nbytes
        if self._live > self._hi:
            self._hi = self._live
        if self._live > self._peak:
            self._peak = self._live

    def _free(self, key: int) -> None:
        if self._open:
            self._live -= self._made.pop(key, 0)
            self._ids.pop(key, None)
            held = self._phantom.pop(key, None)
            if held is not None:
                seq = _node_seq()
                s0 = held[1] if held[1] is not None else self._range_of(seq)
                if seq is not None and s0 is not None and seq >= s0:
                    self._deferred.append([held[0], s0])   # until the
                else:                          # trip's backward is done
                    self._live -= held[0]

    def _range_of(self, seq: Optional[int]) -> Optional[int]:
        """The start of the innermost closed middle trip whose nodes hold
        ``seq``: a checkpointed block's recomputation folds its loops
        again inside the backward pass, and what a recomputed middle trip
        saved is let go once the backward has left that trip's nodes of
        the forward pass."""
        if seq is None:
            return None
        inner = None
        for s0, s1, _ in self._ranges:
            if s0 <= seq < s1 and (inner is None or s0 > inner):
                inner = s0
        return inner

    def _release_deferred(self, seq: int) -> None:
        keep = []
        for held in self._deferred:
            if seq < held[1]:
                self._live -= held[0]
            else:
                keep.append(held)
        self._deferred = keep

    def _m(self) -> int:
        """The multiplier of an op dispatched now: the open middle trips'
        (``_mult``), times, in a backward pass, that of the closed middle
        trips whose autograd node runs it."""
        if not self._ranges:
            return self._mult
        seq = _node_seq()
        if seq is None:
            return self._mult
        if self._deferred:
            self._release_deferred(seq)
        k = self._node_mult.get(seq)
        if k is None:
            k = 1
            for s0, s1, n in self._ranges:
                if s0 <= seq < s1:
                    k *= n
            self._node_mult[seq] = k
        return self._mult * k

    # ---------------------------------------------------------- folding
    def _middle_enter(self):
        """State kept at the start of a middle trip."""
        outer_hi = self._hi
        self._hi = self._live
        log: list = []
        self._logs.append(log)
        return (_next_seq(), self._live, outer_hi, log,
                _node_seq() is not None)

    def _middle_exit(self, mark, k: int, before: list):
        """The end of a middle trip standing for ``k`` trips: its autograd
        nodes' range is closed, and its net growth is held ``k - 1`` more
        times. ``before``: what the trip before it made, in order. Returns
        the middle trip's counterparts of those of them still alive."""
        s0, live0, outer_hi, log, in_backward = mark
        self._logs.remove(log)
        s1 = _next_seq()
        if in_backward:
            s0 = None
        elif s1 > s0:
            self._ranges.append((s0, s1, k))
            self._node_mult.clear()
        growth = self._live - live0
        extra = (k - 1) * growth if growth > 0 else 0
        inner_hi = self._hi + extra
        self._peak = max(self._peak, inner_hi)
        self._hi = max(outer_hi, inner_hi)
        made = _counterparts(
            [(j, self._made[key]) for j, (key, i) in enumerate(before)
             if self._ids.get(key) == i],
            [(j, self._made[key], (key, i)) for j, (key, i) in enumerate(log)
             if self._ids.get(key) == i])
        if extra:
            self._grow(extra)
        return s0, extra, made

    def _hold(self, s0: int, extra: int, made) -> None:
        """At the end of the loop: ``extra`` (the middle trip's growth held
        again) is carried, in proportion to their bytes, by ``made``'s
        storages that are still alive: the middle trip's counterparts of
        what the trip before it made and left alive through it (a value
        appended to a list, a saved block input), not what the last trip
        left in place of the middle one's locals; with none, let go."""
        carriers = [(key, self._made[key]) for key, i in made
                    if self._ids.get(key) == i]   # not an address reused
        total = sum(n for _, n in carriers)
        if not total:
            self._live -= extra
            return
        shares = [extra * n // total for _, n in carriers]
        shares[-1] += extra - sum(shares)
        for (key, _), share in zip(carriers, shares):
            held = self._phantom.get(key)
            if held is None:
                self._phantom[key] = [share, s0]
            else:
                held[0] += share

    def _retire(self, key: int) -> None:
        """An older storage freed during the step keeps its bytes and books
        under a key of its own, so that a storage the step makes later at
        the same address is not taken for it."""
        if self._open and key in self._pre:
            tomb = ("freed", next(self._tombs))
            self._pre[tomb] = self._pre.pop(key)
            if key in self._declared:
                self._declared.add(tomb)
            if key in self._copies:
                self._copies[tomb] = self._copies.pop(key)
            for book in (self._reads, self._writes):
                if key in book:
                    book[tomb] = book.pop(key)

    def _touch(self, book: Dict, t: torch.Tensor, nbytes: float) -> None:
        key = self._note_pre(t)
        if key is not None:
            views = book.setdefault(key, {})
            vk = _view_key(t)
            views[vk] = views.get(vk, 0) + nbytes * self._m()

    # ---------------------------------------------------------- counting
    def _add(self, name: str, flops: float, dtype: str, nbytes: float,
             elementwise: float = 0.0) -> None:
        c, m = self.counts, self._m()
        if flops:
            c.flops += flops * m
            c.flops_by_dtype[dtype] = c.flops_by_dtype.get(dtype, 0.0) \
                + flops * m
        c.elementwise_flops += elementwise * m
        c.hbm_bytes += nbytes * m
        c.n_ops += 1
        row = self.by_op.setdefault(name, [0.0, 0.0, 0])
        row[0] += (flops + elementwise) * m
        row[1] += nbytes * m
        row[2] += m

    def kernel_enter(self, name: str, cost, operands) -> None:
        """A kernel wrapper's report (``kernels/ops.py``): its ``KernelCost``
        and the operands its ``reads`` are of; the wrapper's own ops are not
        counted until ``kernel_exit``."""
        if not self._suppress:
            self._add(name, cost.flops, "float32", cost.hbm_bytes,
                      cost.elementwise_flops)
            self.counts.launches[name] = self.counts.launches.get(name, 0) \
                + self._m()
            for t, nbytes in zip(operands, cost.reads):
                self._touch(self._reads, t, nbytes)
        self._suppress += 1

    def kernel_exit(self, out) -> None:
        self._suppress -= 1
        for t in _tensors(out):
            self._track(t)

    def _run(self, func, info, args, kwargs, ts):
        """``func`` on its arguments; on meta tensors a result of the same
        metadata is remade from a cache (the meta kernels of elementwise
        ops are Python reference code, ~100 us a call)."""
        if info.aliasing or not ts or any(t.device.type != "meta"
                                          for t in ts):
            return func(*args, **kwargs)
        key = (func, _meta_key(args), _meta_key(tuple(sorted(
            kwargs.items()))))
        spec = self._meta_cache.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            outs = (out,) if isinstance(out, torch.Tensor) else out
            if isinstance(outs, (tuple, list)) and all(
                    isinstance(o, torch.Tensor) for o in outs):
                self._meta_cache[key] = (
                    isinstance(out, torch.Tensor),
                    tuple((tuple(o.shape), o.stride(), o.dtype)
                          for o in outs))
            return out
        single, outs = spec
        made = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in outs)
        return made[0] if single else made

    def _collective(self, func, args) -> None:
        kind, factor = _RING[func.overloadpacket.__name__]
        n = _group_size(args)
        m = self._m()
        b = _distinct_bytes(args[0]) * factor(n) * m if n > 1 else 0
        c = self.counts
        c.ici_bytes += b
        c.collective_bytes_by_type[kind] = \
            c.collective_bytes_by_type.get(kind, 0.0) + b
        key = f"{kind}/{str(args[0].dtype).replace('torch.', '')}"
        c.collective_bytes_by_dtype[key] = \
            c.collective_bytes_by_dtype.get(key, 0.0) + b
        c.n_collectives += m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(_FAKE_KEY) is not None:
            return func(*args, **kwargs)     # DTensor's metadata propagation
        dt = dtensor_type()
        if any(issubclass(t, dt) for t in types):
            return NotImplemented            # counted on the local shards
        if func.namespace == "_c10d_functional":
            out = func(*args, **kwargs)
            if func.overloadpacket.__name__ in _RING and not self._suppress:
                self._collective(func, args)
            for t in _flat((out,), []):
                self._track(t)
            return out
        info = _op_info(func)
        ts = _flat(args, [])
        if kwargs:
            _flat(kwargs.values(), ts)
        out = self._run(func, info, args, kwargs, ts)
        if self._suppress or info.view:
            return out                  # a view: no bytes, no storage
        outs = _flat((out,), [])
        if info.scratch_out:
            outs = outs[:-1]
        if not info.mutable:
            for t in outs:
                self._track(t)
        if info.zero_cost:
            return out
        written = [args[i] for i in info.written if i < len(args)
                   and isinstance(args[i], torch.Tensor)]
        if info.scratch_in is not None:
            skip = args[info.scratch_in]
            ts = [t for t in ts if t is not skip]
        nbytes = 0
        for t in ts:
            if info.write_only and any(t is w for w in written):
                continue
            b = _distinct_bytes(t)
            nbytes += b
            self._touch(self._reads, t, b)
        for t in written or outs:
            b = _distinct_bytes(t)
            nbytes += b
            if written:
                self._touch(self._writes, t, b)
        flops, dtype = 0, ""
        if info.formula is not None:
            flops = info.formula(*args, **kwargs, out_val=out)
            dtype = str(ts[0].dtype).replace("torch.", "") if ts \
                else "float32"
        self._add(info.name, flops, dtype, nbytes)
        return out

    # ---------------------------------------------------------- lifecycle
    def __enter__(self):
        from repro_torch.kernels import ops
        self._open = True
        self._reporting = ops.report_kernels(self)
        self._reporting.__enter__()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            self._reporting.__exit__(*exc)

    def finish(self, result=None) -> RooflineCounts:
        """The counts, with the memory reckoning and ``min_hbm_bytes``;
        ``result``: what the step returned (its outputs)."""
        c = self.counts
        out_keys = {}
        for t in _tensors(result):
            st = t.untyped_storage()
            if st._cdata in self._made:
                out_keys[st._cdata] = st.nbytes()
        c.output_bytes = sum(out_keys.values())
        copies = self._copies
        c.argument_bytes = sum(n * copies.get(key, 1)
                               for key, n in self._pre.items())
        c.closure_bytes = sum(n * copies.get(key, 1)
                              for key, n in self._pre.items()
                              if key not in self._declared)
        c.temp_bytes = int(self._peak)
        touched = [sum(k * min(self._pre[key], sum(views.values()) / k)
                       for key, views in book.items()
                       for k in (copies.get(key, 1),))
                   for book in (self._reads, self._writes)]
        c.alias_bytes = int(touched[1])
        c.min_hbm_bytes = float(c.output_bytes) + touched[0] + touched[1]
        self._open = False
        return c


def count(fn, *args, fold_trips: bool = True, **kwargs) -> RooflineCounts:
    """Run ``fn(*args, **kwargs)`` once and count it (see the module's
    docstring). ``args``' tensors are the step's arguments; tensors ``fn``
    closes over count as arguments where the step touches them."""
    counter = Counter(arguments=(args, kwargs), fold_trips=fold_trips)
    with counter:
        result = fn(*args, **kwargs)
    counts = counter.finish(result)
    del result
    return counts


def top_contributors(fn, *args, top: int = 12, **kwargs):
    """The aten ops and kernels of one counted run of ``fn``, the ``top``
    by FLOPs and the ``top`` by bytes: ``{"by_flops": [(name, flops,
    bytes, calls)], "by_bytes": [...]}`` (the counterpart of
    ``hlo_analysis.py:542``, for PERF.md's "where the time goes")."""
    counter = Counter(arguments=(args, kwargs))
    with counter:
        fn(*args, **kwargs)
    counter.finish()
    rows = [(name, f, b, n) for name, (f, b, n) in counter.by_op.items()]
    return {"by_flops": sorted(rows, key=lambda r: -r[1])[:top],
            "by_bytes": sorted(rows, key=lambda r: -r[2])[:top]}


def trips(n: int):
    """``range(n)``; under a counter that folds trips, a loop of more than
    four trips runs indices 0 and 1, index 2 with its counts multiplied by
    ``n - 3`` (the middle trips), and index ``n - 1``: FLOPs, bytes,
    launches and collectives are those of ``n`` bodies, in the forward
    pass and in the backward pass that autograd runs later, and the
    reckoned peak is that of the unfolded loop (see the module's
    docstring)."""
    if n <= 4 or not _ACTIVE or not _ACTIVE[-1].fold_trips:
        return range(n)
    return _folded(_ACTIVE[-1], n)


def _counterparts(survivors, made) -> list:
    """The middle trip's storages that stand where the trip before it
    left ``survivors`` alive (``(position, bytes)`` in the order that trip
    made its storages): for each, the middle trip's storage of the same
    bytes nearest its position (``made``: ``(position, bytes, id)``; the
    two trips may make a storage more or less where a metadata cache
    answers)."""
    free: Dict[int, list] = {}
    for j, n, ident in made:
        free.setdefault(n, []).append((j, ident))
    out = []
    for j, n in survivors:
        cands = free.get(n)
        if cands:
            best = min(range(len(cands)), key=lambda c: abs(cands[c][0] - j))
            out.append(cands.pop(best)[1])
    return out


def _folded(counter: Counter, n: int):
    yield 0
    before: list = []
    counter._logs.append(before)
    try:
        yield 1
    finally:
        counter._logs.remove(before)
    mult = counter._mult
    mark = counter._middle_enter()
    try:
        counter._mult = mult * (n - 3)
        yield 2
    finally:
        counter._mult = mult
    s0, extra, made = counter._middle_exit(mark, n - 3, before)
    try:
        yield n - 1
    finally:                   # also where the last trip breaks the loop
        if extra:
            counter._hold(s0, extra, made)


def fill_trips(items: list, n: int) -> list:
    """The ``n`` values a loop over ``trips(n)`` collected, one a trip:
    ``items`` itself, or after a folded loop its four entries with the
    middle one repeated (detached) in the place of every middle trip."""
    if len(items) == n:
        return items
    if len(items) != 4:
        raise ValueError(f"{len(items)} values for {n} trips")
    return items[:3] + [_detached(items[2])] * (n - 4) + [items[3]]


def _detached(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_detached(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _detached(v) for k, v in obj.items()}
    return obj


_PROBE: List[torch.Tensor] = []
_NO_NODE = 2 ** 63


def _next_seq() -> int:
    """The sequence number the next autograd node made on this thread
    takes (a probe node is made, unseen by any dispatch mode)."""
    with torch._C._DisableTorchDispatch(), torch.enable_grad():
        if not _PROBE:
            _PROBE.append(torch.zeros(1, requires_grad=True))
        return _PROBE[0].view(-1).grad_fn._sequence_nr() + 1


def _node_seq() -> Optional[int]:
    """The sequence number of the autograd node the backward pass runs
    now (None outside it, and for a leaf's gradient accumulator)."""
    node = torch._C._current_autograd_node()
    if node is None:
        return None
    seq = node._sequence_nr()
    return None if seq >= _NO_NODE else seq
