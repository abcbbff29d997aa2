"""Population-axis sharding for MOHAQ candidate evaluation.

Port of the reference package's ``distributed/pop_sharding.py``. A GA
generation is a (P, ...) batch of independent candidates: one quantization
candidate per lane, no cross-lane reduction anywhere in the forward or the
error count. So the population axis partitions over a 1-D mesh
(``launch/mesh.py::PopulationMesh``): every shard scores a contiguous slice
of the lanes, everything else (parameters, quantized-weight banks,
validation features and labels) is replicated, and the per-candidate
integer error counts come back to the host in lane order. Nothing here is
model-specific: any lane-independent ``fn(*replicated, batched)``
partitions the same way.

Two modes (``PARTITION_MODES``):

- ``"shard_map"`` (default): one process drives every shard. Each shard's
  slice goes through the *unchanged* single-device ``fn`` on its device, on
  a CUDA stream of its own that waits on the producer's stream; the
  replicated arguments are placed once per distinct device and cached (on
  a shared card they are not copied at all). The kernels' bits do not
  depend on how many lanes share a call (``csrc/bank_gemm.cuh``: one
  ``fmaf`` chain per output; ``sru_scan_pop`` is per lane), so a sharded
  generation gives the unsharded one's counts bit for bit.
- ``"process_group"``: the counterpart of the reference's ``"gspmd"``.
  Eager PyTorch has no SPMD partitioner; its idiom for several devices is
  one process per device under ``torch.distributed``. The caller
  initialises the group (``torchrun``, ``torch.multiprocessing.spawn``) and
  builds the mesh with ``mesh.make_process_group_mesh``. Every rank runs
  the same host program from the same seed (SPMD over the host loop, so
  NSGA-II and the error memo stay identical on every rank), dispatches its
  own slice and gathers the host ``int64`` counts with ``all_gather`` over
  a gloo group: gloo works with the compute on CUDA, and also when two
  ranks share one card, where NCCL refuses. ``mode="gspmd"`` raises and
  names ``"process_group"``.

Uneven populations pad up to a multiple of the shard count (``padded_pop``:
the last row is duplicated and its lanes are sliced off after the gather),
on top of the evaluator's population buckets. ``shrink_mesh`` is the
surviving mesh after a device loss; on a process-group mesh it makes a new
gloo group of the first ``keep`` ranks, and every rank must call it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import PopulationMesh

POP_AXIS = "pop"

# "gspmd" (the reference's partitioner lowering) has no eager counterpart:
# "process_group" is the one-process-per-device idiom that stands in for it
PARTITION_MODES = ("shard_map", "process_group")


class LeftMesh(RuntimeError):
    """Raised on a rank that a device loss removed from a process-group
    mesh: the rank has no shard left and leaves the search."""


def pop_axis_size(mesh: Optional[PopulationMesh], axis: str = POP_AXIS
                  ) -> int:
    """Number of population shards a mesh provides (1 without a mesh)."""
    if mesh is None:
        return 1
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.axis_names} has no {axis!r} axis")
    return int(mesh.shape[axis])


def padded_pop(bucket: int, n_shards: int) -> int:
    """The population bucket rounded up to a multiple of the shard count
    (every shard gets the same number of lanes)."""
    return -(-bucket // n_shards) * n_shards


def shrink_mesh(mesh: PopulationMesh, keep: int, axis: str = POP_AXIS
                ) -> PopulationMesh:
    """The surviving mesh after a device loss: the first ``keep`` shards,
    same axis. On a process-group mesh every rank must call it (it makes
    the survivors' gloo group); a rank outside the result has
    ``group`` None."""
    n = pop_axis_size(mesh, axis)
    if not 0 < keep < n:
        raise ValueError(f"keep={keep} must shrink the {n}-shard mesh")
    if not mesh.process_group:
        return PopulationMesh(mesh.devices[:keep], mesh.axis)
    import torch.distributed as dist

    ranks = mesh.ranks[:keep]
    group = dist.new_group(ranks=list(ranks), backend="gloo")
    return PopulationMesh(mesh.devices[:keep], mesh.axis, ranks=ranks,
                          rank=mesh.rank,
                          group=group if mesh.rank in ranks else None)


def _place(tree, dev: torch.device):
    """``tree`` (tensors in dicts, lists, tuples) with every tensor on
    ``dev``; a tensor already there is the same object. The copies are
    synchronous: they happen once per argument and device."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _place(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, dev) for v in tree)
    return tree


def _record(tree, stream) -> None:
    """``record_stream`` every CUDA tensor of ``tree`` on ``stream``."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            tree.record_stream(stream)
    elif isinstance(tree, dict):
        for v in tree.values():
            _record(v, stream)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _record(v, stream)


class ShardedCall:
    """``fn(*replicated, batched)`` partitioned over the population axis of
    its last argument (see the module docstring). Calls return the
    concatenated per-lane result as a CPU tensor in lane order.
    ``last_launches``: each shard's kernel launches in the last call
    (``kernels.ops.launch_counts`` deltas)."""

    def __init__(self, fn: Callable, mesh: PopulationMesh, n_replicated: int,
                 mode: str):
        self.fn = fn
        self.mesh = mesh
        self.n_replicated = n_replicated
        self.mode = mode
        self.last_launches: List[Dict[str, int]] = []
        # (argument slot, device) -> (argument, its copy on the device)
        self._placed: Dict[tuple, tuple] = {}
        self._streams: Dict[int, torch.cuda.Stream] = {}

    def _replicas(self, replicated, dev):
        out = []
        for slot, arg in enumerate(replicated):
            hit = self._placed.get((slot, dev))
            if hit is None or hit[0] is not arg:
                hit = (arg, _place(arg, dev))
                self._placed[(slot, dev)] = hit
            out.append(hit[1])
        return out

    def _run_shard(self, replicated, local):
        from repro_torch.kernels import ops as kops

        before = kops.launch_counts()
        out = self.fn(*replicated, local)
        after = kops.launch_counts()
        self.last_launches.append({k: after[k] - before.get(k, 0)
                                   for k in after
                                   if after[k] != before.get(k, 0)})
        return out

    def __call__(self, *args):
        if len(args) != self.n_replicated + 1:
            raise TypeError(f"expected {self.n_replicated} replicated "
                            f"arguments and one batched, got {len(args)}")
        replicated, batched = args[:-1], args[-1]
        n = self.mesh.size
        if batched.shape[0] % n:
            raise ValueError(f"population {batched.shape[0]} is not a "
                             f"multiple of the {n} shards (pad it with "
                             "padded_pop)")
        per = batched.shape[0] // n
        self.last_launches = []
        if self.mode == "process_group":
            return self._process_group(replicated, batched, per)
        return self._shard_map(replicated, batched, per)

    def _shard_map(self, replicated, batched, per):
        outs = []
        src = batched.device
        for i, dev in enumerate(self.mesh.devices):
            rep = self._replicas(replicated, dev)
            local = batched[i * per:(i + 1) * per]
            if dev.type != "cuda":
                outs.append((self._run_shard(rep, local.to(dev).contiguous()),
                             None))
                continue
            stream = self._streams.get(i)
            if stream is None:
                stream = self._streams[i] = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            if src.type == "cuda" and src != dev:
                stream.wait_stream(torch.cuda.current_stream(src))
            with torch.cuda.stream(stream):
                local = local.to(dev, non_blocking=True).contiguous()
                _record(local, stream)
                _record(rep, stream)
                out = self._run_shard(rep, local)
            outs.append((out, stream))
        for _, stream in outs:
            if stream is not None:
                stream.synchronize()
        return torch.cat([out.cpu() for out, _ in outs], dim=0)

    def _process_group(self, replicated, batched, per):
        import torch.distributed as dist

        mesh = self.mesh
        if mesh.group is None or mesh.rank not in mesh.ranks:
            raise LeftMesh(f"rank {mesh.rank} is outside the "
                           f"{mesh.size}-shard mesh {mesh.ranks}")
        i = mesh.ranks.index(mesh.rank)
        dev = mesh.devices[i]
        local = batched[i * per:(i + 1) * per].to(dev).contiguous()
        out = self._run_shard(self._replicas(replicated, dev), local)
        mine = out.to(device="cpu", dtype=torch.int64).contiguous()
        parts = [torch.empty_like(mine) for _ in mesh.ranks]
        dist.all_gather(parts, mine, group=mesh.group)
        return torch.cat(parts, dim=0)


def shard_population(fn: Callable, mesh: PopulationMesh, *,
                     n_replicated: int, axis: str = POP_AXIS,
                     mode: str = "shard_map") -> ShardedCall:
    """Partition ``fn(*replicated_args, batched_arg)`` over the population
    axis of its LAST argument. ``fn`` must be lane-independent in that
    argument's leading axis. ``mode="process_group"`` needs a mesh from
    ``make_process_group_mesh``."""
    if mode == "gspmd":
        raise ValueError("mode 'gspmd' (the reference's SPMD partitioner) "
                         "has no eager PyTorch counterpart: use "
                         "'process_group', one process per device")
    if mode not in PARTITION_MODES:
        raise ValueError(f"mode must be one of {PARTITION_MODES}: {mode!r}")
    pop_axis_size(mesh, axis)          # validates the axis exists
    if (mode == "process_group") != mesh.process_group:
        raise ValueError(
            f"mode {mode!r} needs a "
            + ("process-group mesh (make_process_group_mesh)"
               if mode == "process_group"
               else "one-process mesh (make_population_mesh)"))
    return ShardedCall(fn, mesh, n_replicated, mode)


def gather_counts(counts) -> np.ndarray:
    """Per-candidate counts as a host numpy array (a sharded call's result
    is already gathered on the host; an unsharded one is copied here)."""
    if isinstance(counts, torch.Tensor):
        return counts.cpu().numpy()
    return np.asarray(counts)
