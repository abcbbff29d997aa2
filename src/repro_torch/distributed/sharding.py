"""Logical-axis sharding on ``torch.distributed.tensor`` (MaxText-style
rules).

Port of the reference package's ``distributed/sharding.py``. Model code
annotates activations with *logical* axis names through ``shard()``; the
param init functions have a parallel tree of logical axes
(``models/*::*_axes``). A rule table maps logical names to mesh axes.
Outside a mesh everything is a no-op, so the same model code runs
unsharded and on a mesh.

The reference's ``PartitionSpec`` is a tuple here (``Spec``: one entry a
dim, each None, a mesh axis name or a tuple of names), and its
``NamedSharding`` is ``Sharding``: the spec plus its DTensor placements,
one a mesh dim. A tensor dim on several mesh axes, such as ``("pod",
"data")``, is ``Shard(d)`` on each of them, outer axis first: DTensor's
left-to-right order, which is the reference's. A mesh is anything with
``axis_names`` and a ``shape`` dict (the tests' duck-typed ``FakeMesh``
computes specs); ``Mesh`` adds the ``DeviceMesh`` that tensors are placed
on. Under an active ``Mesh`` (``axis_rules``) plain tensors meet DTensors
as replicated ones (``implicit_replication``), so host-made constants such
as positions and masks need no wrapping.

GSPMD pads a dim that its axes do not divide; DTensor splits it unevenly
(``torch.chunk``'s sizes), which ``shard()`` accepts as the reference's
``with_sharding_constraint`` does. Parameter specs are
divisibility-corrected (``fix_spec``), as jit's in_shardings need there.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


def _canon(assignment: MeshAxes) -> MeshAxes:
    """Canonical mesh-axis assignment: a 1-tuple becomes the bare string,
    an empty tuple None."""
    if isinstance(assignment, tuple):
        if not assignment:
            return None
        if len(assignment) == 1:
            return assignment[0]
    return assignment


# Default rules for the production mesh. "pod" is folded into the data axis.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qkv_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_hd": None,
    "sru_hidden": "model",
    "stack": None,            # stacked-layer leading axis
    "pop": "pop",             # GA population lane (candidate-parallel eval)
}


@dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``device_mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``) with the reference mesh's ``axis_names`` and
    ``shape`` (a dict of axis sizes)."""
    device_mesh: Any

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    def describe(self) -> dict:
        return {"axes": self.shape, "devices": self.size,
                "device_type": self.device_mesh.device_type}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, MeshAxes] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Activate a mesh and logical rules for model code in this thread (and,
    on a ``Mesh``, DTensor's implicit replication of plain tensors)."""
    old = (_CTX.mesh, _CTX.rules)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    if mesh is not None:
        names = set(mesh.axis_names)
        for k, v in list(merged.items()):
            if v is None:
                continue
            axes = (v,) if isinstance(v, str) else tuple(v)
            merged[k] = _canon(tuple(a for a in axes if a in names))
    _CTX.mesh, _CTX.rules = mesh, merged
    try:
        with _implicit(mesh):
            yield
    finally:
        _CTX.mesh, _CTX.rules = old


_IMPLICIT_DEPTH = [0]


@contextlib.contextmanager
def _implicit(mesh):
    """DTensor's ``implicit_replication`` for the outermost active ``Mesh``
    (the flag it sets is global, and an inner exit would clear it)."""
    if not isinstance(mesh, Mesh) or _IMPLICIT_DEPTH[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _IMPLICIT_DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _IMPLICIT_DEPTH[0] -= 1


def current_mesh():
    return _CTX.mesh


def logical_to_spec(logical: Sequence[Optional[str]]) -> Spec:
    return tuple(None if name is None else _canon(_CTX.rules.get(name))
                 for name in logical)


def _axes(assignment: MeshAxes) -> Tuple[str, ...]:
    if assignment is None:
        return ()
    return (assignment,) if isinstance(assignment, str) else tuple(assignment)


def _axis_size(mesh, assignment) -> int:
    n = 1
    for a in _axes(assignment):
        n *= mesh.shape[a]
    return n


def _entry(spec: Spec, i: int) -> MeshAxes:
    return spec[i] if i < len(spec) else None


def fix_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop (replicate) any dim whose size isn't divisible by its mesh axes
    (e.g. kv_heads=8 on model=16)."""
    out = []
    for i, dim in enumerate(shape):
        p = _entry(spec, i)
        if p is not None and dim % _axis_size(mesh, p) != 0:
            p = None
        out.append(p)
    return tuple(out)


def _add_fsdp(mesh, spec: Spec, shape) -> Spec:
    """ZeRO/FSDP: additionally shard one dim of every >=2-D tensor over the
    data(-and-pod) axes: the largest unsharded dim divisible by their size;
    falls back to "data" only, then to no-op."""
    used = {a for p in spec for a in _axes(p)}
    candidates = []
    if "pod" in mesh.shape and "pod" not in used and "data" not in used:
        candidates.append(("pod", "data"))
    if "data" not in used:
        candidates.append(("data",))
    for axes in candidates:
        n = _axis_size(mesh, axes)
        best, best_dim = -1, -1
        for i, d in enumerate(shape):
            if _entry(spec, i) is None and d % n == 0 and d >= n and d > best:
                best, best_dim = d, i
        if best_dim >= 0:
            parts = [_entry(spec, i) for i in range(len(shape))]
            parts[best_dim] = _canon(axes)
            return tuple(parts)
    return spec


def _ensure_axis(mesh, spec: Spec, shape, axis: str) -> Spec:
    """If ``axis`` got dropped by divisibility correction (e.g. 60 experts
    on model=16), re-home it on the largest divisible unsharded dim, so
    the tensor is not replicated across that axis."""
    if axis not in mesh.shape:
        return spec
    if any(axis in _axes(p) for p in spec):
        return spec
    n = mesh.shape[axis]
    best, best_dim = -1, -1
    for i, d in enumerate(shape):
        if _entry(spec, i) is None and d % n == 0 and d >= n and d > best:
            best, best_dim = d, i
    if best_dim < 0:
        return spec
    parts = [_entry(spec, i) for i in range(len(shape))]
    parts[best_dim] = axis
    return tuple(parts)


def placements(mesh, spec: Spec) -> List:
    """DTensor placements of ``spec``: for each mesh axis, ``Shard(d)`` on
    the tensor dim whose entry names it, else ``Replicate()``; an axis of
    one device splits nothing and is ``Replicate()`` (so a 1 x 1 mesh runs
    every op as the unsharded program does). Raises where a dim lists its
    axes in another order than the mesh's (DTensor shards the outer mesh
    dim first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.axis_names)
    out = [Replicate() for _ in names]
    for d, p in enumerate(spec):
        axes = _axes(p)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {p!r} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            if mesh.shape[names[i]] > 1:
                out[i] = Shard(d)
    return out


@dataclass(frozen=True)
class Sharding:
    """One leaf's sharding: the spec and its placements on ``mesh``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> List:
        return placements(self.mesh, self.spec)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, logical_tree, *trees):
    """``fn(axes, *leaves)`` over a tree of logical-axis tuples and trees of
    the same structure (dicts), keeping the structure."""
    if _is_axes_leaf(logical_tree) or logical_tree is None:
        return fn(logical_tree, *trees)
    return {k: map_axes(fn, v, *(t[k] for t in trees))
            for k, v in logical_tree.items()}


def tree_shardings(mesh, logical_tree, shapes_tree=None,
                   rules: Optional[Dict[str, MeshAxes]] = None,
                   fsdp: bool = False, ensure_model: bool = False):
    """A tree of ``Sharding`` for a tree of logical-axis tuples. With
    ``shapes_tree`` (tensors of the same structure, meta ones included),
    each spec is divisibility-corrected; ``fsdp=True`` also shards every
    >=2-D tensor over the data/pod axes (ZeRO-3 style); ``ensure_model``
    re-homes a dropped model axis on another dim."""
    with axis_rules(mesh, rules):
        if shapes_tree is None:
            return map_axes(lambda axes: Sharding(mesh, logical_to_spec(
                axes or ())), logical_tree)

        def one(axes, t):
            if not isinstance(t, torch.Tensor):
                return None               # an int leaf: a cache's "cur"
            shape = tuple(t.shape)
            spec = fix_spec(mesh, logical_to_spec(axes or ()), shape)
            if ensure_model and len(shape) >= 2:
                spec = _ensure_axis(mesh, spec, shape, "model")
            if fsdp and len(shape) >= 2:
                spec = _add_fsdp(mesh, spec, shape)
            return Sharding(mesh, spec)

        return map_axes(one, logical_tree, shapes_tree)


# ------------------------------------------------------------- DTensors

_DTENSOR = []


def dtensor_type():
    """DTensor's class, imported at the first use (not at import)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def is_dtensor(x) -> bool:
    return isinstance(x, dtensor_type())


def place(t, sharding: Sharding):
    """``t`` (the full tensor, the same on every rank, or a meta tensor) as
    a DTensor on ``sharding``. Each rank keeps its own slice: nothing is
    sent. A DTensor already placed so is returned as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = sharding.mesh
    pl = sharding.placements
    if isinstance(t, DTensor):
        return t if list(t.placements) == pl else t.redistribute(
            mesh.device_mesh, pl)
    if t.device.type != "meta":
        return distribute_tensor(t, mesh.device_mesh, pl, src_data_rank=None)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local_shape, _ = compute_local_shape_and_global_offset(
        t.shape, mesh.device_mesh, pl)
    return DTensor.from_local(
        torch.empty(local_shape, dtype=t.dtype, device="meta"),
        mesh.device_mesh, pl, run_check=False, shape=t.shape,
        stride=t.stride())


def place_tree(tree, shardings):
    """``place`` over a tree and its tree of ``Sharding``; leaves that are
    not tensors (a cache's ``cur``) stay as they are."""
    def one(t, s):
        if isinstance(t, dict):
            return {k: one(t[k], s[k]) for k in t}
        if isinstance(t, torch.Tensor) and isinstance(s, Sharding):
            return place(t, s)
        return t
    return one(tree, shardings)


def place_by_axes(tree, logical_tree):
    """``tree`` placed on the active mesh by its logical axes
    (``tree_shardings`` of its shapes); a no-op outside a ``Mesh``."""
    mesh = current_mesh()
    if not isinstance(mesh, Mesh):
        return tree
    return place_tree(tree, tree_shardings(mesh, logical_tree, tree,
                                           rules=_CTX.rules))


def from_local(local, mesh, placements, shape):
    """``DTensor.from_local`` of a contiguous local shard of a tensor of
    global ``shape`` (no check, no communication)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def full(x):
    """The whole tensor of a DTensor (a collective: every rank calls it);
    anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def split_over(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose dim ``dim`` is split over a mesh
    axis of more than one device."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    dim = dim % x.ndim
    return any(isinstance(p, Shard) and p.dim == dim and n > 1
               for p, n in zip(x.placements, x.device_mesh.shape))


def on_row_shards(fn, *xs):
    """``fn(*xs)`` on each rank's rows: DTensor inputs (dim 0 their rows,
    the batch) are made whole on every mesh axis but those that split the
    rows, ``fn`` runs on the local tensors, and each tensor it returns
    (dim 0 its rows) comes back as a DTensor of those placements. For a
    computation that is independent row by row and that DTensor's
    rules would reshard (a recurrence's chunk loop). Plain inputs:
    ``fn(*xs)``."""
    lead = next((x for x in xs if is_dtensor(x)), None)
    if lead is None:
        return fn(*xs)
    from torch.distributed.tensor import Replicate, Shard
    mesh = lead.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in lead.placements]
    out = fn(*(x.redistribute(mesh, pl).to_local() if is_dtensor(x) else x
               for x in xs))

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return from_local(t.contiguous(), mesh, pl,
                          (lead.shape[0],) + tuple(t.shape[1:]))
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) \
        else wrap(out)


def whole(x):
    """A DTensor replicated on every mesh axis (pending sums reduced, splits
    gathered); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` of its local
    shard (pending sums reduced first), placements kept: for the ops that
    DTensor has no sharding rule for (``log_sigmoid``'s backward)."""
    if not is_dtensor(x):
        return fn(x)
    x = reduce_partial(x)
    return from_local(fn(x.to_local()), x.device_mesh, x.placements,
                      x.shape)


def _whole_last(x, groups: int):
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim == last
          and groups % n else p
          for p, n in zip(x.placements, x.device_mesh.shape)]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


class _WholeForGroups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _whole_last(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _whole_last(g, ctx.groups), None


def whole_for_groups(x, groups: int):
    """``x`` with its last dim made whole on every mesh axis whose size
    does not divide ``groups``, and its gradient too: a reshape of that dim
    into ``groups`` (heads) needs each shard to hold whole groups, in the
    forward pass before an unflatten and in the backward pass after a
    flatten. Anything else as it is."""
    if not is_dtensor(x):
        return x
    return _WholeForGroups.apply(x, groups)


def reduce_partial(y):
    """A DTensor's pending cross-shard sums (``Partial`` placements)
    reduced, in ``y``'s dtype, to replicated; anything else as it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Partial, Replicate
    pl = [Replicate() if isinstance(p, Partial) else p for p in y.placements]
    return y if pl == list(y.placements) else y.redistribute(
        y.device_mesh, pl)


def shard(x, *logical: Optional[str]):
    """Constrain activation ``x`` to the sharding of its logical axes: on a
    DTensor under an active ``Mesh``, a ``redistribute`` to that spec;
    otherwise ``x`` as it is. A dim smaller than its axes stays
    replicated; an uneven dim is split unevenly."""
    mesh = _CTX.mesh
    if not isinstance(mesh, Mesh) or not is_dtensor(x):
        return x
    spec = logical_to_spec(logical)
    spec = tuple(None if p is not None and dim < _axis_size(mesh, p) else p
                 for dim, p in zip(x.shape, spec + (None,) * x.ndim))
    pl = placements(mesh, spec)
    if list(x.placements) == pl:
        return x
    return x.redistribute(mesh.device_mesh, pl)
