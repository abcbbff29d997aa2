"""Device meshes of the port: the population axis of the MOHAQ search.

Port of the reference package's ``launch/mesh.py::make_population_mesh``.
A ``PopulationMesh`` is the one-axis counterpart of a ``jax.sharding.Mesh``
(``axis_names``, ``shape``): a tuple of ``torch.device`` shards over which
``distributed/pop_sharding.py`` partitions a generation's candidates.

- ``make_population_mesh(n_devices, device="cuda")``: every visible CUDA
  device by default; more shards than devices go round-robin onto the
  visible ones, the counterpart of the reference's
  ``--xla_force_host_platform_device_count``, which is how one card runs a
  4-shard mesh. ``device="cpu"`` gives CPU shards (the tests).
- ``make_process_group_mesh(device)``: the ranks of an initialised
  ``torch.distributed`` group, one shard a rank, each on its own device
  (``pop_sharding``'s ``"process_group"`` mode). It makes a gloo group
  over those ranks for the counts' gather; every rank must call it.

``physical_devices`` counts the distinct devices behind the shards: every
caller prints it beside the shard count, so a 4-shard mesh on one card
never reads as four cards.

The LM half of the reference's meshes, over the ranks of an initialised
``torch.distributed`` group (``distributed/sharding.py::Mesh``, a named
``DeviceMesh``):

- ``make_mesh_for(n_devices, model_parallel, axes)``: the elastic (data,
  model) grid of the trainer;
- ``make_production_mesh(multi_pod)``: the reference's (16, 16) ("data",
  "model") pod and (2, 16, 16) ("pod", "data", "model") two-pod mesh,
  over ranks 0..255 or 0..511;
- ``init_process_group(device)``: joins the group a launcher set up
  (``torchrun``'s environment) or makes a 1-rank group, with NCCL where
  every rank has a card of its own and gloo where ranks share one (NCCL
  refuses two ranks on one card); it prints the choice;
- ``init_fake_group(world_size)``: a process group of ``world_size``
  ranks in one process whose collectives move nothing, for the dry run on
  meta tensors (PyTorch's testing ``FakeStore`` and ``"fake"`` backend,
  imported here and nowhere else).
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh


@dataclass(frozen=True)
class PopulationMesh:
    """One population axis of ``len(devices)`` shards. A process-group
    mesh also carries the global ``ranks`` of its shards, this process's
    ``rank`` and the gloo ``group`` (None on a rank outside the mesh)."""
    devices: Tuple[torch.device, ...]
    axis: str = "pop"
    ranks: Optional[Tuple[int, ...]] = None
    rank: Optional[int] = None
    group: Any = field(default=None, compare=False, hash=False, repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def physical_devices(self) -> int:
        """Distinct devices behind the shards (1 for a 4-shard mesh on one
        card)."""
        return len(set(self.devices))

    @property
    def process_group(self) -> bool:
        return self.ranks is not None

    def describe(self) -> dict:
        return {"shards": self.size, "physical_devices":
                self.physical_devices,
                "devices": [str(d) for d in self.devices],
                "mode": "process_group" if self.process_group
                else "shard_map"}


def make_population_mesh(n_devices: Optional[int] = None, axis: str = "pop",
                         device="cuda") -> PopulationMesh:
    """A 1-D mesh over the GA population axis. With ``device="cuda"`` the
    default is one shard per visible CUDA device, and ``n_devices`` above
    the visible count places the shards round-robin on them; raises where
    no CUDA device is present. With ``device="cpu"`` every shard is the
    CPU (default 1)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        n = n_devices or visible
        devices = tuple(torch.device("cuda", i % visible) for i in range(n))
    else:
        n = n_devices or 1
        devices = (dev,) * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return PopulationMesh(devices, axis)


def make_process_group_mesh(device="cuda", axis: str = "pop"
                            ) -> PopulationMesh:
    """The population mesh of an initialised process group: one shard per
    rank, in rank order, each on the device its rank runs on (``device``
    here; ranks may share a card). Collective: every rank calls it. Raises
    when no process group is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the process_group mesh needs an initialised "
                           "torch.distributed process group")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    ranks = tuple(range(world))
    group = dist.new_group(ranks=list(ranks), backend="gloo")
    names = [None] * world
    dist.all_gather_object(names, str(dev), group=group)
    return PopulationMesh(tuple(torch.device(n) for n in names), axis,
                          ranks=ranks, rank=dist.get_rank(), group=group)


# ------------------------------------------------------- the LM meshes

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device="cuda", verbose: bool = True) -> bool:
    """Join the process group this process was launched into (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` from ``torchrun``), or
    make a 1-rank group on a free localhost port; a group that is already
    initialised is kept. The backend is NCCL when the ranks are on CUDA and
    each has a card of its own, else gloo. Returns whether a group was
    made here (its maker destroys it)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    nccl = dev.type == "cuda" and world <= torch.cuda.device_count()
    backend = "nccl" if nccl else "gloo"
    if "MASTER_ADDR" in os.environ:
        init = "env://"
    else:
        init = f"tcp://localhost:{_free_port()}"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    if verbose and rank == 0:
        why = ("each rank has a card of its own" if nccl else
               "ranks share a card" if dev.type == "cuda" else "CPU ranks")
        print(f"[mesh] process group: {world} rank(s), {backend} ({why})",
              flush=True)
    return True


def init_fake_group(world_size: int) -> None:
    """A process group of ``world_size`` ranks in this one process (rank 0)
    whose collectives return at once and move nothing: DTensor's placement
    and collective logic runs in full on meta tensors, the counterpart of
    the reference's ``--xla_force_host_platform_device_count``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() >= world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _device_type() -> str:
    """The default device type of a mesh: "cpu" under the fake group and
    where no card is present, else "cuda" (callers with CPU ranks on a
    machine with cards pass ``device_type="cpu"``)."""
    import torch.distributed as dist
    if dist.get_backend() == "fake" or not torch.cuda.is_available():
        return "cpu"
    return "cuda"


def _grid(shape, axes, device_type=None) -> Mesh:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("a (data, model) mesh needs an initialised "
                           "process group (mesh.init_process_group)")
    n = 1
    for d in shape:
        n *= d
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    ranks = torch.arange(n).reshape(shape)
    return Mesh(DeviceMesh(device_type or _device_type(), ranks,
                           mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> Mesh:
    """The reference's production mesh: a (16, 16) ("data", "model") pod,
    or (multi_pod) two of them, (2, 16, 16) ("pod", "data", "model"), over
    the first 256 or 512 ranks of the process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, device_type)


def make_mesh_for(n_devices: Optional[int] = None, model_parallel: int = 1,
                  axes: Tuple[str, ...] = ("data", "model"),
                  device_type: Optional[str] = None) -> Mesh:
    """Elastic mesh: the best (data, model) grid of ``n_devices`` ranks
    (default: the whole process group) with ``model_parallel`` on the
    model axis; used by the trainer after restarts on more or fewer
    ranks."""
    import torch.distributed as dist

    n = n_devices or dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel "
                         f"groups of {model_parallel}")
    return _grid((n // model_parallel, model_parallel), axes, device_type)
