"""Roofline terms of one LM step, counted while the step runs (the port of
``repro.launch.roofline``).

    compute term    = matmul FLOPs / peak FLOP/s of the step's dtype
    memory term     = bytes of every op's operands / HBM rate
    collective term = collective bytes / link rate          (per device)

The JAX package reads these from a compiled artifact: XLA's
``cost_analysis`` and the collectives of the partitioned HLO.  The port
has no compiler pass, so it counts them on the step itself, run for one
rank (``launch.dryrun`` runs it on the meta device, where it moves no
data):

  * FLOPs: the formulas of ``torch.utils.flop_counter`` (the registry
    ``FlopCounterMode`` counts with), which cover the matmul-class ops
    only (mm, bmm, addmm, convolutions, attention); a composite op is
    counted by the ops it decomposes into, as ``FlopCounterMode`` does.
    XLA's ``flops`` also counts elementwise ops: here the compute term is
    matmul FLOPs, and the elementwise work shows in the bytes.  The count
    is ``FlopCounterMode``'s, but it is taken in this module's own
    dispatch mode: ``FlopCounterMode``'s module tracker hooks the
    backward pass, and those hooks keep every remat block's recomputed
    activations alive until the backward ends, which would inflate the
    peak memory it is counted beside (and the real one on a GPU).
  * Bytes: the input and output bytes of every aten op that computes
    (not a view, not an op that only relabels its input's storage, and
    not an ``empty`` factory, which allocates and writes nothing), each
    op's operands counted whole: a pre-fusion upper bound, as XLA's
    ``bytes accessed`` is.
  * Peak memory per device: the step's argument bytes (the rank's shards
    of parameters, optimizer state, batch and cache) plus the high-water
    mark of the storages the step allocates, each released when the last
    tensor referencing it dies.
  * Collectives: ``RecordingMesh``, an ``LMMesh`` on the meta device whose
    collectives move nothing and record JAX's counts: the result bytes of
    each collective, an all-reduce counted twice (a ring), one count per
    call.

The constants are for one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power
limit, from NVIDIA's H100 data sheet; they are data-sheet figures, not
measurements:

  * ``PEAK_FLOPS``: 989.4 TFLOP/s, bfloat16 (and float16) on the dense
    tensor cores, the dry run's dtype; ``PEAK_FLOPS_F32``: 66.9 TFLOP/s,
    float32 with TF32 off (outside the tensor cores).
  * ``HBM_BW``: 3.35 TB/s of HBM3.
  * ``LINK_BW``: 50 GB/s a GPU, one 400 Gb/s NDR InfiniBand port, in place
    of the TPU's ICI link.  Every group of size above 1 in the production
    meshes spans at least two 8-GPU nodes (``model`` is 16 consecutive
    ranks, ``data`` and ``pod`` stride 16 and 256 ranks), so no collective
    of theirs runs on NVLink alone.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import LMMesh

PEAK_FLOPS = 989.4e12           # bfloat16, dense tensor cores
PEAK_FLOPS_F32 = 66.9e12        # float32, TF32 off
HBM_BW = 3.35e12
LINK_BW = 50e9

_PEAKS = {torch.bfloat16: PEAK_FLOPS, torch.float16: PEAK_FLOPS,
          torch.float32: PEAK_FLOPS_F32}

ALL_GATHER, ALL_REDUCE = "all-gather", "all-reduce"

# factories that allocate without writing: their storage is live, their
# bytes are not moved
_UNWRITTEN = {torch.ops.aten.empty, torch.ops.aten.empty_like,
              torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided}


def peak_flops(dtype: torch.dtype) -> float:
    """The compute peak a step in ``dtype`` is held to."""
    return _PEAKS[dtype]


@dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int] = field(default_factory=dict)
    count_by_op: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def add(self, op: str, nbytes: int, count: int = 1) -> None:
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + nbytes
        self.count_by_op[op] = self.count_by_op.get(op, 0) + count


# ------------------------------------------------------ the recording mesh


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass(frozen=True, eq=False)
class RecordingMesh(LMMesh):
    """An ``LMMesh`` on the meta device whose collectives move no data:
    ``all_gather`` returns an empty tensor of the gathered shape,
    ``all_reduce`` its input.  Each collective over axes of size above 1
    appends ``(op, axes, bytes)`` to ``log`` with JAX's conventions: the
    bytes of its result, twice that for an all-reduce (a ring's
    reduce-scatter and all-gather); collectives over axes of size 1 are
    identities and are not logged, as on a real mesh.

    The mesh is rank 0's (``coords`` all zero).  Rank 0 stands for every
    rank: the spec rules split a dimension only where its axes divide it
    (they degrade to replication elsewhere), so every rank holds shards
    of the same shapes and makes the same calls on them."""

    log: list = field(default_factory=list)

    def __post_init__(self):
        super().__post_init__()
        if self.device is None:
            object.__setattr__(self, "device", torch.device("meta"))
        if self.device.type != "meta":
            raise ValueError(f"a recording mesh lies on the meta device, "
                             f"not {self.device}")

    def all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        n = self.axis_size(axes)
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= n
        out = t.new_empty(shape)
        self.log.append((ALL_GATHER, self.axes(axes), _nbytes(out)))
        return out

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op {op!r}")
        if self.axis_size(axes) > 1:
            self.log.append((ALL_REDUCE, self.axes(axes), 2 * _nbytes(t)))
        return t


# ------------------------------------------------------------- counting


@dataclass
class StepCounts:
    """What a step did on one device: matmul FLOPs, bytes of the ops'
    operands, its collectives, per op ``name → [calls, bytes, flops]``,
    and the high-water mark of what it allocated (``live_peak``)."""

    flops: int = 0
    bytes: int = 0
    coll: CollectiveStats = field(default_factory=CollectiveStats)
    ops: dict = field(default_factory=dict)
    live_peak: int = 0

    def op(self, name: str, calls: int, nbytes: int, flops: int) -> None:
        row = self.ops.setdefault(name, [0, 0, 0])
        row[0] += calls
        row[1] += nbytes
        row[2] += flops


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _OpCounts(TorchDispatchMode):
    """Adds each computing op's FLOPs and operand bytes to ``part`` and
    hands every storage an op allocates to ``counter``'s live tally."""

    def __init__(self, counter: StepCounter, part: StepCounts):
        super().__init__()
        self.counter, self.part = counter, part

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.ops.prim.device.default:
            with self:          # a composite op: counted by its parts
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        seen = {_storage_key(t) for t in ins}
        fresh = [t for t in outs if _storage_key(t) not in seen]
        if func.is_view or not (fresh or func._schema.is_mutable):
            return out                  # relabels storage it was given
        formula = flop_registry.get(func.overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        nbytes = 0 if func.overloadpacket in _UNWRITTEN else \
            sum(_nbytes(t) for t in ins + outs)
        self.part.flops += flops
        self.part.bytes += nbytes
        self.part.op(str(func.overloadpacket), 1, nbytes, flops)
        for t in fresh:
            self.counter.allocated(t)
        return out


class StepCounter:
    """Counts the code run under ``count()`` (see the module docstring).

    ``count(repeat=k)`` adds k times what the code inside did (its FLOPs,
    bytes, ops and the collectives ``mesh`` logged), for a body that runs
    k times alike, such as one of k equal micro-batches.  The live tally
    spans every ``count`` of one counter: a storage allocated in one and
    alive in the next stays counted, and the high-water mark is not
    multiplied."""

    def __init__(self, mesh: RecordingMesh | None = None):
        self.mesh = mesh
        self.counts = StepCounts()
        self.live = 0
        self._live: dict[int, int] = {}

    def allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live += st.nbytes()
        self.counts.live_peak = max(self.counts.live_peak, self.live)
        weakref.finalize(st, self._released, key)

    def _released(self, key: int) -> None:
        self.live -= self._live.pop(key)

    @contextlib.contextmanager
    def count(self, repeat: int = 1):
        part = StepCounts()
        start = len(self.mesh.log) if self.mesh is not None else 0
        with _OpCounts(self, part):
            yield self
        total = self.counts
        total.flops += repeat * part.flops
        total.bytes += repeat * part.bytes
        for name, (calls, nbytes, flops) in part.ops.items():
            total.op(name, repeat * calls, repeat * nbytes, repeat * flops)
        if self.mesh is not None:
            for op, _, nbytes in self.mesh.log[start:]:
                total.coll.add(op, repeat * nbytes, repeat)


def argument_bytes(*trees) -> int:
    """The bytes of every tensor in ``trees`` (dicts, lists, modules'
    parameters given as dicts), each storage once."""
    seen: dict[int, int] = {}
    for t in pytree.tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


# --------------------------------------------------------------- the report


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                # per device
    hbm_bytes: float            # per device
    coll_bytes: float           # per device
    coll_detail: dict
    peak_memory_bytes: float
    model_flops: float          # 6·N·D (global)
    peak_flops: float = PEAK_FLOPS      # of the step's dtype

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips × counted FLOPs): recomputation (remat) and
        work repeated across ranks."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (step_time × chips × peak), the roofline score.
        Conservative: the memory term counts every op's operands (a
        pre-fusion upper bound)."""
        denom = self.step_time_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    @property
    def mfu_optimistic(self) -> float:
        """MFU with the fusion-optimistic memory floor: the peak memory
        read once a step (perfect fusion).  True MFU lies between ``mfu``
        and this."""
        mem_floor = self.peak_memory_bytes / HBM_BW
        step = max(self.compute_s, min(self.memory_s, mem_floor),
                   self.collective_s)
        denom = step * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_detail": self.coll_detail,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck, "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio, "mfu": self.mfu,
            "mfu_optimistic": self.mfu_optimistic,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch tokens."""
    n = cfg.active_params_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens      # forward only
    return 2.0 * n * shape.global_batch   # one token per sequence


def analyze(counts: StepCounts, *, arch: str, shape, mesh_name: str,
            chips: int, cfg, argument_bytes: int,
            dtype: torch.dtype = torch.bfloat16) -> RooflineReport:
    """The report of one rank's counted step (``StepCounter.counts``,
    micro-batches already multiplied) whose arguments take
    ``argument_bytes`` on the device."""
    coll = counts.coll
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops=float(counts.flops), hbm_bytes=float(counts.bytes),
        coll_bytes=float(coll.total_bytes),
        coll_detail={"bytes": dict(coll.bytes_by_op),
                     "count": dict(coll.count_by_op)},
        peak_memory_bytes=float(argument_bytes + counts.live_peak),
        model_flops=model_flops_for(cfg, shape),
        peak_flops=peak_flops(dtype))
