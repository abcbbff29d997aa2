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

The LM half of the reference's meshes (``make_mesh_for``,
``make_production_mesh``: a (data, model) grid for tensor parallelism)
waits for ROADMAP queue 1, item 9b.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device


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
