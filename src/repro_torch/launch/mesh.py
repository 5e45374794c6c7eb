"""The search mesh: the sharded ANNS datapath across processes.

The JAX package's ``("search",)`` mesh is a set of devices driven by one
controller.  Here it is a set of processes, one shard each, that make the
same calls (SPMD), as ``torchrun`` starts them::

    torchrun --nproc-per-node 4 my_search.py   # each process:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        torch.distributed.init_process_group("nccl")
        mesh = make_search_mesh()
        res = Database.wrap(index).query(q, plan=QueryPlan(shards=4),
                                         mesh=mesh)

A ``SearchMesh`` is the axis object of ``anns.sharding``: it gathers the
ranks' blocks in rank order (``all_gather``) and sums owner-masked parts
(``all_reduce``).  With no process group it is a one-process mesh whose
collectives are identities.

The LM's meshes (``make_production_mesh``, ``make_host_mesh``,
``dp_axes``) are not ported yet; they come with the multi-device LM.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXIS = "search"


@dataclass(frozen=True, eq=False)
class SearchMesh:
    """``size`` processes on the ``"search"`` axis; this one is ``rank``.

    ``group`` is the process group (None: one process, no collective).
    ``device`` is where this rank's shard lives.  Equality is identity, so
    a mesh is a cache key of its own.

    On NCCL the collectives are enqueued on the current stream and the
    host does not wait for them.  Gloo on CUDA tensors copies through the
    host, so each collective synchronizes the stream."""

    size: int
    rank: int
    device: torch.device
    group: object = None

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.group is None:
            return t
        if t.dtype == torch.bool:       # sent as bytes, the same bits
            return self.all_gather(t.to(torch.uint8), dim).bool()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (written into ``t``)."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def make_search_mesh(n: int | None = None, *, device=None) -> SearchMesh:
    """A 1-D ``("search",)`` mesh over the first ``n`` ranks of the
    initialised process group (default: all of them).

    ``device``: None is this rank's current CUDA device (raising with no
    GPU); ``"cpu"`` is allowed on a ``gloo`` group or with no group, as
    the tests use it.  With no process group, ``n`` of None or 1 gives a
    one-process mesh.  Every rank of the group must call this (it creates
    a subgroup when ``n`` is smaller than the world); a rank at or past
    ``n`` holds no shard and raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        if n not in (None, 1):
            raise ValueError(
                f"make_search_mesh({n}) needs {n} processes but no process "
                f"group is initialised; start one process per shard with "
                f"torchrun (or call torch.distributed.init_process_group "
                f"in each) before building the mesh")
        return SearchMesh(size=1, rank=0, device=dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(
            f"make_search_mesh({n}) needs {n} processes but the process "
            f"group has {world}; start {n} with torchrun --nproc-per-node "
            f"{n} (or init_process_group with world_size={n})")
    backend = dist.get_backend()
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU search mesh needs a gloo process group, "
                         f"not {backend}")
    group = dist.group.WORLD if n == world \
        else dist.new_group(ranks=list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is not on make_search_mesh({n}): "
                         f"only ranks 0..{n - 1} hold a shard")
    return SearchMesh(size=n, rank=rank, device=dev, group=group)


def mesh_axis_sizes(mesh: SearchMesh) -> dict[str, int]:
    return {AXIS: mesh.size}
