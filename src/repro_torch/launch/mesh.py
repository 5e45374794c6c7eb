"""The meshes of the port: the search mesh of the sharded ANNS datapath
and the LM's meshes, each a set of processes.

The JAX package's meshes are sets of devices driven by one controller.
Here a mesh is a set of processes, one device each, that make the same
calls (SPMD), as ``torchrun`` starts them::

    torchrun --nproc-per-node 4 my_search.py   # each process:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        torch.distributed.init_process_group("nccl")
        mesh = make_search_mesh()
        res = Database.wrap(index).query(q, plan=QueryPlan(shards=4),
                                         mesh=mesh)

A ``SearchMesh`` is the axis object of ``anns.sharding``: it gathers the
ranks' blocks in rank order (``all_gather``) and sums owner-masked parts
(``all_reduce``).  An ``LMMesh`` is the LM's ``(data, model)`` or
``(pod, data, model)`` mesh (``make_production_mesh``, ``make_host_mesh``,
``make_lm_mesh``), with one process group per set of axes; the steps of
``launch.steps`` run on it.  With no process group either is a
one-process mesh whose collectives are identities.

Equal meshes are one object: each builder returns the mesh it built
before for the same arguments over the same process group (as
``jax.make_mesh`` returns the same ``Mesh``), so a mesh is a cache key
and no second subgroup is made.
"""

from __future__ import annotations

import itertools
import math
import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXIS = "search"


@dataclass(frozen=True, eq=False)
class SearchMesh:
    """``size`` processes on the ``"search"`` axis; this one is ``rank``.

    ``group`` is the process group (None: one process, no collective).
    ``device`` is where this rank's shard lives.  Equality is identity;
    ``make_search_mesh`` returns one object for equal arguments, so a mesh
    is a cache key of its own.

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


def _world():
    """The default process group, None where there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


_MEMO: dict = {"world": lambda: None, "entries": {}}


def _memo() -> dict:
    """The meshes and subgroups built over the current default process
    group (or over none); a new group starts an empty memo."""
    world = _world()
    if _MEMO["world"]() is not world:
        _MEMO["world"] = (lambda: None) if world is None \
            else weakref.ref(world)
        _MEMO["entries"] = {}
    return _MEMO["entries"]


def _rank_device(device) -> torch.device:
    """``device`` resolved; None is this rank's current CUDA device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_backend(dev: torch.device, what: str) -> None:
    backend = dist.get_backend()
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU {what} needs a gloo process group, not "
                         f"{backend}")


def make_search_mesh(n: int | None = None, *, device=None) -> SearchMesh:
    """A 1-D ``("search",)`` mesh over the first ``n`` ranks of the
    initialised process group (default: all of them).

    ``device``: None is this rank's current CUDA device (raising with no
    GPU); ``"cpu"`` is allowed on a ``gloo`` group or with no group, as
    the tests use it.  With no process group, ``n`` of None or 1 gives a
    one-process mesh.  Every rank of the group must call this (it creates
    a subgroup when ``n`` is smaller than the world, once per ``n``); a
    rank at or past ``n`` holds no shard and raises.  A second call with
    the same ``n`` and device over the same process group returns the
    first call's mesh."""
    dev = _rank_device(device)
    memo = _memo()
    if _world() is None:
        if n not in (None, 1):
            raise ValueError(
                f"make_search_mesh({n}) needs {n} processes but no process "
                f"group is initialised; start one process per shard with "
                f"torchrun (or call torch.distributed.init_process_group "
                f"in each) before building the mesh")
        return memo.setdefault(("search", 1, dev),
                               SearchMesh(size=1, rank=0, device=dev))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(
            f"make_search_mesh({n}) needs {n} processes but the process "
            f"group has {world}; start {n} with torchrun --nproc-per-node "
            f"{n} (or init_process_group with world_size={n})")
    _check_backend(dev, "search mesh")
    hit = memo.get(("search", n, dev))
    if hit is not None:
        return hit
    group = memo.get(("search-group", n))
    if group is None:
        group = memo[("search-group", n)] = dist.group.WORLD if n == world \
            else dist.new_group(ranks=list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is not on make_search_mesh({n}): "
                         f"only ranks 0..{n - 1} hold a shard")
    return memo.setdefault(("search", n, dev), SearchMesh(
        size=n, rank=rank, device=dev, group=group))


# ------------------------------------------------------------ the LM meshes


@dataclass(frozen=True, eq=False)
class LMMesh:
    """The LM's mesh: ``prod(shape)`` processes laid out row-major over
    ``axis_names``, rank r at the coordinates of r unravelled (the layout
    ``jax.make_mesh`` gives its devices); this one is at ``coords``.

    ``groups`` maps each set of axes (a tuple in mesh order) whose size is
    above 1 to the process group of the ranks that share this rank's
    coordinates on every other axis; in rank order, its ranks are in
    row-major order over those axes.  The counterpart of ``jax.make_mesh``
    is this class, not ``torch``'s ``DeviceMesh``: a ``DeviceMesh`` needs a
    process group even for one process, and its ``DTensor``s do not mix
    with the plain tensors the models compute on.

    A mesh built without groups and device (``LMMesh(("data", "model"),
    (16, 16))``) describes a layout only: the spec functions read its
    names and sizes, a collective over axes of size above 1 raises, and
    ``steps.place_model`` / ``place`` / ``init_cache`` refuse it (they put
    data on ``device``).  Collectives over axes of size 1 are
    identities."""

    axis_names: tuple
    shape: tuple
    coords: tuple | None = None          # None: rank 0's
    device: torch.device | None = None   # None: a layout only
    groups: dict = field(default_factory=dict)

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} for a mesh of shape "
                             f"{self.shape}")
        if self.coords is None:
            object.__setattr__(self, "coords", (0,) * len(self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axes(self, axes) -> tuple:
        """``axes`` (a name, a tuple of names or None) as a tuple of this
        mesh's names in mesh order; names it does not have are left out."""
        if axes is None:
            return ()
        want = {axes} if isinstance(axes, str) else set(axes)
        return tuple(a for a in self.axis_names if a in want)

    def axis_size(self, axes) -> int:
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes[a] for a in self.axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        out = 0
        for a in self.axes(axes):
            i = self.axis_names.index(a)
            out = out * self.shape[i] + self.coords[i]
        return out

    def _group(self, axes):
        key = self.axes(axes)
        if self.axis_size(key) == 1:
            return None
        group = self.groups.get(key)
        if group is None:
            raise ValueError(f"mesh axes {key} have size "
                             f"{self.axis_size(key)} but this mesh has no "
                             f"process group for them (a layout-only mesh)")
        return group

    def all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """The ``t`` of every rank on ``axes`` (with this rank's other
        coordinates) concatenated along ``dim`` in index order."""
        group = self._group(axes)
        if group is None:
            return t
        n = self.axis_size(axes)
        out = t.new_empty((n, *t.shape))    # the parts in one buffer
        dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
        return out.movedim(0, dim).reshape(*t.shape[:dim], n * t.shape[dim],
                                           *t.shape[dim + 1:])

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (or ``op="max"``) of ``t`` over the ranks on ``axes``,
        written into ``t``."""
        group = self._group(axes)
        if group is not None:
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=group)
        return t


def _lm_groups(shape: tuple, names: tuple, rank: int) -> dict:
    """This rank's process group for every set of axes of size above 1.
    Every rank makes every subgroup, in the same order."""
    coords = list(itertools.product(*(range(n) for n in shape)))
    mine = coords[rank]
    groups = {}
    for r in range(1, len(shape) + 1):
        for dims in itertools.combinations(range(len(shape)), r):
            if math.prod(shape[d] for d in dims) == 1:
                continue
            axes = tuple(names[d] for d in dims)
            if r == len(shape):
                groups[axes] = dist.group.WORLD
                continue
            others = [d for d in range(len(shape)) if d not in dims]
            cosets: dict = {}
            for rk, c in enumerate(coords):
                cosets.setdefault(tuple(c[d] for d in others), []).append(rk)
            for key, ranks in cosets.items():
                group = dist.new_group(ranks=ranks)
                if key == tuple(mine[d] for d in others):
                    groups[axes] = group
    return groups


def make_lm_mesh(shape, axis_names, *, device=None) -> LMMesh:
    """The LM mesh of ``shape`` over ``axis_names`` (``jax.make_mesh``'s
    arguments), one process per device: the initialised process group
    must have ``prod(shape)`` ranks, each of which calls this.  A mesh of
    one process needs no group.

    ``device``: None is this rank's current CUDA device (raising with no
    GPU); ``"cpu"`` is allowed on a ``gloo`` group or with no group.  A
    second call with the same arguments over the same process group
    returns the first call's mesh."""
    shape, names = tuple(shape), tuple(axis_names)
    dev = _rank_device(device)
    memo = _memo()
    key = ("lm", shape, names, dev)
    if key in memo:
        return memo[key]
    n = math.prod(shape)
    if n == 1:
        return memo.setdefault(key, LMMesh(names, shape, device=dev))
    if _world() is None:
        raise ValueError(
            f"make_lm_mesh({shape}) needs {n} processes but no process "
            f"group is initialised; start one process per device with "
            f"torchrun (or call torch.distributed.init_process_group in "
            f"each) before building the mesh")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(
            f"make_lm_mesh({shape}) needs {n} processes but the process "
            f"group has {world}; start {n} with torchrun --nproc-per-node "
            f"(or init_process_group with world_size={n})")
    _check_backend(dev, "LM mesh")
    groups = memo.get(("lm-groups", shape, names))
    if groups is None:
        groups = memo[("lm-groups", shape, names)] = _lm_groups(
            shape, names, rank)
    return memo.setdefault(key, LMMesh(names, shape, _unravel(rank, shape),
                                       dev, groups))


def _unravel(rank: int, shape: tuple) -> tuple:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> LMMesh:
    """Single pod: (data=16, model=16), 256 processes.  Multi-pod: (pod=2,
    data=16, model=16), 512; the ``pod`` axis is pure data parallelism.
    The JAX package's production mesh, over as many processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_lm_mesh(shape, axes, device=device)


def make_host_mesh(device=None) -> LMMesh:
    """The (1, 1) ``("data", "model")`` mesh of this process alone (for
    smoke tests and examples), whatever process group there is."""
    return make_lm_mesh((1, 1), ("data", "model"), device=device)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes used for batch/data parallelism (pod folds into data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, SearchMesh):
        return {AXIS: mesh.size}
    return dict(zip(mesh.axis_names, mesh.shape))
