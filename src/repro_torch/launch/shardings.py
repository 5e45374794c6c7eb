"""Parameter, batch and cache specs for every model family (the port of
``repro.launch.shardings``), and the helpers that cut a rank's shard.

A spec is a tuple with one entry per dimension, the counterpart of a
``PartitionSpec``: a mesh axis name, a tuple of names (split in that
order, the first outermost) or None (whole).  The rules are the JAX
package's, over its leaf names and shapes:

  * 2-D sharding of every large weight: TP along ``model`` on the "wide"
    dim (heads / d_ff / vocab), FSDP along ``(pod, data)`` on the other;
    the optimizer state inherits it.
  * MoE experts: expert-parallel along ``model`` when n_experts divides
    the axis, otherwise TP inside each expert.
  * Every rule checks divisibility and degrades to replication.
  * Caches: batch → data axes, KV heads → model; a batch that does not
    divide falls back to sequence sharding.

``param_specs`` walks the port's ``named_parameters()``: each parameter
is mapped to its JAX leaf (``jax_leaf``), with the layer-stack dimensions
of JAX's tree (one module per layer here) and the (in, out) ↔ (out, in)
transpose of an ``nn.Linear``, and JAX's spec is re-indexed to the
port's layout.  The spec functions read only the mesh's axis names and
sizes, so a layout-only ``launch.mesh.LMMesh`` stands in for a mesh of
256 processes.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import dp_axes, mesh_axis_sizes

# weight-name → (tp_dim, fsdp_dim); tp_dim = the dim sharded along `model`
_TP_LAST = ("wq", "wk", "wv", "wg", "wu", "up", "in_proj", "wi", "w_gates",
            "lm_head", "w_if")
_TP_FIRST = ("wo", "wd", "down", "out_proj")
_REPLICATE = ("ln", "ln1", "ln2", "lnx", "final_norm", "enc_norm",
              "gate_norm", "out_norm", "A_log", "dt_bias", "conv",
              "router", "r_gates", "dec_pos", "enc_pos")


def _divides(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _axis_size(mesh, name) -> int:
    sizes = mesh_axis_sizes(mesh)
    if isinstance(name, tuple):
        out = 1
        for a in name:
            out *= sizes.get(a, 1)
        return out
    return sizes.get(name, 1)


# containers whose leading dim(s) are layer-stack dims in JAX's tree
_STACK1 = ("blocks", "enc_blocks", "dec_blocks", "tail", "slstm_blocks")
_STACK2 = ("mlstm_blocks", "groups")


def _stack_dims(parts: tuple[str, ...]) -> int:
    if any(p in _STACK2 for p in parts):
        return 2
    if any(p in _STACK1 for p in parts):
        return 1
    return 0


def param_spec(mesh, name: str, shape: tuple[int, ...], *, fsdp: bool = True,
               mode: str = "2d") -> tuple:
    """The spec of one JAX leaf by path (``"blocks/attn/wq"``) and JAX
    shape; leading layer-stack dims are never sharded.

    mode="2d": TP along ``model`` + FSDP along the data axes (default).
    mode="fsdp": pure FSDP over all mesh axes, no tensor parallelism."""
    model = "model"
    msize = _axis_size(mesh, model)
    dp = dp_axes(mesh)
    if mode == "fsdp":
        dp = tuple(mesh.axis_names)          # fold model into FSDP
        msize = 10**9                        # nothing divides → no TP
        fsdp = True
    dsize = _axis_size(mesh, dp)
    parts = tuple(name.split("/"))
    base = parts[-1]
    lead = _stack_dims(parts)
    core = shape[lead:]
    head = [None] * lead

    def maybe_fsdp(dim_size):
        return dp if (fsdp and _divides(dim_size, dsize)) else None

    if base in _REPLICATE or len(core) == 0:
        return (None,) * len(shape)
    if base in ("bq", "bk", "bv"):
        tp = model if _divides(core[0], msize) else None
        return (*head, tp)
    if base == "embed":
        # vocab-sharded along model, d_model FSDP along data; if vocab
        # doesn't divide, shard d_model instead (never replicate a table)
        if _divides(shape[0], msize):
            return (model, maybe_fsdp(shape[1]))
        if _divides(shape[1], msize):
            return (None, model)
        return (None, maybe_fsdp(shape[1]))
    if "moe" in parts and len(core) == 3 and base in ("wg", "wu", "wd"):
        # MoE experts (E, D, F) / (E, F, D)
        e = core[0]
        if _divides(e, msize):
            return (*head, model, maybe_fsdp(core[1]), None)  # expert-par
        tp_dim = 2 if base in ("wg", "wu") else 1
        spec = [None, None, None]
        if _divides(core[tp_dim], msize):
            spec[tp_dim] = model
        other = 2 if tp_dim == 1 else 1
        spec[other] = maybe_fsdp(core[other])
        return (*head, *spec)
    if base in _TP_LAST and len(core) >= 2:
        tp = model if _divides(core[-1], msize) else None
        return (*head, maybe_fsdp(core[0]), *([None] * (len(core) - 2)), tp)
    if base in _TP_FIRST and len(core) >= 2:
        tp = model if _divides(core[0], msize) else None
        return (*head, tp, *([None] * (len(core) - 2)),
                maybe_fsdp(core[-1]))
    return (None,) * len(shape)


def jax_leaf(model: nn.Module, name: str) -> tuple[str, tuple, bool]:
    """The JAX leaf of the port's parameter ``name``: (its path, e.g.
    ``"blocks/attn/wq"``; its JAX shape, with the layer-stack dims in
    front; whether it is an ``nn.Linear`` weight, stored transposed).  A
    q/k/v projection's bias is the leaf ``bq``/``bk``/``bv``."""
    parts = name.split(".")
    path, stack, obj = [], [], model
    for p in parts[:-1]:
        if p.isdigit():
            stack.append(len(obj))
            obj = obj[int(p)]
        else:
            path.append(p)
            obj = getattr(obj, p)
    shape = tuple(getattr(obj, parts[-1]).shape)
    linear = isinstance(obj, nn.Linear) and parts[-1] == "weight"
    if isinstance(obj, nn.Linear) and parts[-1] == "bias":
        path[-1] = "b" + path[-1][1:]
    elif not isinstance(obj, nn.Linear):
        path.append(parts[-1])
    if linear:
        shape = shape[::-1]
    return "/".join(path), tuple(stack) + shape, linear


def param_specs(mesh, model: nn.Module, *, fsdp: bool = True,
                mode: str = "2d") -> dict:
    """name → spec for every parameter of ``model`` (which may lie on the
    meta device): JAX's spec of its leaf, without the stack dims and
    transposed for an ``nn.Linear`` weight."""
    out = {}
    for name, p in model.named_parameters():
        path, shape, linear = jax_leaf(model, name)
        spec = param_spec(mesh, path, shape, fsdp=fsdp, mode=mode)
        spec = spec[len(shape) - p.dim():]           # the stack dims
        out[name] = spec[::-1] if linear else spec
    return out


def batch_specs(mesh, batch: dict, *, mode: str = "2d") -> dict:
    """tokens/labels (B, S) → batch over (pod, data) [all axes in fsdp
    mode]; embeds/frames too.  ``batch`` holds tensors (meta ones too)."""
    dp = dp_axes(mesh) if mode == "2d" else tuple(mesh.axis_names)
    dsize = _axis_size(mesh, dp)

    def spec(leaf):
        if leaf.dim() == 0:
            return ()
        first = dp if _divides(leaf.shape[0], dsize) else None
        return (first, *([None] * (leaf.dim() - 1)))

    return {k: spec(v) for k, v in batch.items()}


def cache_spec_for(mesh, shape: tuple[int, ...], kind: str) -> tuple:
    """KV caches (L, B, S, KV, hd) and SSM states — batch→data,
    heads→model, falling back to sequence→data for batch=1 long-context."""
    dp = dp_axes(mesh)
    dsize = _axis_size(mesh, dp)
    msize = _axis_size(mesh, "model")
    if kind == "kv":                        # (L|G, B, S, KV, hd)
        _, b, s, kv, _ = shape
        spec = [None, None, None, None, None]
        if _divides(b, dsize):
            spec[1] = dp
        elif _divides(s, dsize):
            spec[2] = dp                    # batch=1 → shard sequence
        if _divides(kv, msize):
            spec[3] = "model"
        elif spec[2] is None and _divides(s, msize):
            spec[2] = "model"
        return tuple(spec)
    # generic state: try batch dim then the largest trailing dim
    spec = [None] * len(shape)
    for i, n in enumerate(shape):
        if spec.count(dp) == 0 and _divides(n, dsize) and n >= dsize \
                and i >= len(shape) - 4:
            spec[i] = dp
            break
    for i in range(len(shape) - 1, -1, -1):
        if spec[i] is None and _divides(shape[i], msize) \
                and shape[i] >= msize:
            spec[i] = "model"
            break
    return tuple(spec)


def cache_specs(mesh, cache: dict) -> dict:
    """The spec of every tensor of ``cache`` (nested dicts), keyed as the
    cache is; a host value (the ``len`` int) gets none.  A leaf is a KV
    cache where JAX's path of it names one, else a state."""
    def walk(tree: dict, path: str) -> dict:
        out = {}
        for key, leaf in tree.items():
            name = f"{path}['{key}']"
            if isinstance(leaf, dict):
                out[key] = walk(leaf, name)
            elif isinstance(leaf, torch.Tensor):
                if leaf.dim() == 0:
                    out[key] = ()
                elif any(k in name for k in ("'k'", "'v'", "attn_k",
                                             "attn_v", "xk", "xv")) \
                        and leaf.dim() == 5:
                    out[key] = cache_spec_for(mesh, tuple(leaf.shape), "kv")
                else:
                    out[key] = cache_spec_for(mesh, tuple(leaf.shape),
                                              "state")
        return out
    return walk(cache, "")


def named(mesh, specs):
    """Each spec (in a dict, nested or not) as its per-mesh-dimension
    placements: ``Shard(d)`` on each axis that splits dimension d,
    ``Replicate()`` on the others (the ``NamedSharding`` counterpart)."""
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    out = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(specs):
        for a in spec_axes(entry):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


# ------------------------------------------------------- a rank's shard


def spec_axes(entry) -> tuple:
    """One spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded(mesh, spec) -> bool:
    """Whether ``spec`` splits any dimension over axes of size above 1."""
    return any(mesh.axis_size(spec_axes(e)) > 1 for e in spec)


def shard_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec`` (a view
    where it can be): along each split dimension the chunk at this rank's
    index over the dimension's axes.  A dimension that its axes' size
    does not divide raises."""
    for d, entry in enumerate(spec):
        n = mesh.axis_size(spec_axes(entry))
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"split {n} ways ({spec})")
        size = t.shape[d] // n
        t = t.narrow(d, mesh.index(spec_axes(entry)) * size, size)
    return t


def gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's shard ``t`` under ``spec``: one
    all-gather over each split dimension's axes (every rank of those axes
    calls it, in the same order)."""
    for d, entry in enumerate(spec):
        if mesh.axis_size(spec_axes(entry)) > 1:
            t = mesh.all_gather(t, d, spec_axes(entry))
    return t


def map_tree(fn, tree: dict, specs: dict) -> dict:
    """``fn(leaf, spec)`` over every tensor of a nested dict that has a
    spec; other values are kept."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = map_tree(fn, leaf, specs[key])
        elif isinstance(leaf, torch.Tensor) and key in specs:
            out[key] = fn(leaf, specs[key])
        else:
            out[key] = leaf
    return out
