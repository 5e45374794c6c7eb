"""Train / prefill / decode step builders on an LM mesh (the port of
``repro.launch.steps``).

Each ``make_*`` returns ``(step_fn, structs, in_placements,
out_placements, meta)``, the reference's five values: ``structs`` are
meta-device stand-ins of the arguments at their global shapes
(``launch.input_specs``), the placements are per-mesh-dimension
``Shard``/``Replicate`` lists (``shardings.named``) and ``meta`` holds
the specs themselves (``meta["specs"]``) beside the reference's keys.
The reference lowers these steps under pjit; here they run, one process
per device, and compute what the one-process step computes:

  * Parameters, AdamW moments and caches are held as this rank's shards
    by the ported specs (the local slice, not a ``DTensor``):
    ``place_model`` cuts a model's parameters, ``place`` a batch or a
    cache.  Training uses ``fsdp=True`` and the ``sharding_mode``;
    serving the TP-only specs, as the reference has it.
  * The data axes (every axis in ``"fsdp"`` mode) split the batch: each
    rank is given its rows (``place``).
  * The model runs on local tensors.  A placed model gathers a layer's
    parameters when the layer first reads one (one all-gather per layer,
    FSDP-style, the next layer's read dropping them), so at full width
    at most one layer's weights are whole at a time; with ``remat`` the
    backward pass gathers each layer again.  Each layer's gradients are
    summed exactly over the batch axes (one all-reduce per layer),
    divided by their size and cut back to the rank's shards.
  * The ``model`` axis shards storage and, in decode, the attention over
    the cache: its sequence chunk (flash decode, when the KV heads do
    not divide the axis) or its KV heads.  Tensor-parallel matmuls and
    sequence-parallel activations move no data here: every rank of a
    ``model`` group computes the same whole-width products on its batch
    rows, and ``meta`` says so (``"tensor_parallel": False``,
    ``"seq_parallel": False``).  They would change no result.

  * A MoE router forms the reference's groups over the whole batch
    (``models.moe.route``: a group that spans ranks offsets its expert
    positions by one all-gather of the lower ranks' counts) and its aux
    loss's ``f_e`` is the whole batch's (one all-reduce); a train step's
    micro-batch ``i`` is the reference's rows of micro-batch ``i``, dealt
    over the ranks from one all-gather of the batch.
  * A decode cache whose sequence the data axes split (a batch that does
    not divide them) is attended chunk by chunk and combined over those
    axes, as flash decode does over ``model``; a recurrent state (zamba2,
    xlstm) that its spec splits on another dim than the batch rows is
    gathered whole one layer at a time (``_LayerStates``: an all-gather
    for each dim its spec splits), written, and cut back.

On a mesh of one process (``make_host_mesh()``) each step is the
one-process path bit for bit.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import dp_axes, mesh_axis_sizes
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.model_zoo import ModelApi, build_model, loss_fn
from repro_torch.train import optimizer
from repro_torch.train.loop import _grads

# ---------------------------------------------------------------- placing


class _Units:
    """This rank's shards of a model's parameters, gathered a unit at a
    time: a unit is one layer of a layer stack (``blocks.3``,
    ``groups.1.0``) or one top-level parameter or module.  The unit read
    last is kept whole (``slot``) until another unit is read."""

    def __init__(self, mesh, batch_axes: tuple):
        self.mesh, self.batch_axes = mesh, mesh.axes(batch_axes)
        self.units: dict = {}            # key → [(name, spec, full shape)]
        self.where: dict = {}            # (id(module), attr) → (key, i)
        self.params: dict = {}           # key → [shard parameter]
        self.slot = (None, None)

    def clear(self) -> None:
        self.slot = (None, None)

    def full(self, module, attr: str) -> torch.Tensor:
        key, i = self.where[(id(module), attr)]
        if self.slot[0] != key:
            self.slot = (None, None)     # drop the last unit first
            self.slot = (key, _GatherUnit.apply(self, key,
                                                *self.params[key]))
        return self.slot[1][i]

    def axes_of(self, key) -> tuple:
        """The union of the axes of size above 1 the unit's specs split."""
        named = {a for _, spec, _ in self.units[key] for e in spec
                 for a in sh.spec_axes(e)
                 if self.mesh.axis_size(a) > 1}
        return self.mesh.axes(tuple(named))

    def gather(self, key, shards) -> list:
        """Every parameter of the unit whole: one all-gather of the split
        shards, packed, over the unit's axes."""
        entries, axes = self.units[key], self.axes_of(key)
        out = [s.view_as(s) for s in shards]
        split = [i for i, (_, spec, _) in enumerate(entries)
                 if sh.sharded(self.mesh, spec)]
        if not split:
            return out
        for dtype in sorted({shards[i].dtype for i in split}, key=str):
            part = [i for i in split if shards[i].dtype == dtype]
            # the packed shards die with the call: only the gathered
            # pieces and the whole tensors are live while they assemble
            pieces = self.mesh.all_gather(torch.cat(
                [shards[i].reshape(-1) for i in part])[None], 0, axes)
            off = 0
            for i in part:
                n = shards[i].numel()
                out[i] = _assemble(pieces[:, off:off + n], entries[i][1],
                                   entries[i][2], shards[i].shape,
                                   self.mesh, axes)
                off += n
        return out

    def reduce(self, key, grads, kinds) -> list:
        """Each whole gradient summed over the batch axes, divided by
        their size, and cut back to this rank's shard (``kinds``: the
        shards' dtypes and devices, for a gradient autograd left None).

        Where the batch axes are above 1 the gradients are summed packed,
        one flat buffer per dtype; every gradient returned is then a copy
        out of it (a shard, or a replicated leaf whole), never a view, so
        the buffer dies with this unit's backward instead of being pinned
        by ``.grad`` until the update."""
        entries = self.units[key]
        gs = [g if g is not None else torch.zeros(e[2], dtype=dt, device=dv)
              for g, e, (dt, dv) in zip(grads, entries, kinds)]
        n = self.mesh.axis_size(self.batch_axes)
        if n > 1:
            for dtype in sorted({g.dtype for g in gs}, key=str):
                part = [i for i, g in enumerate(gs) if g.dtype == dtype]
                flat = torch.cat([gs[i].reshape(-1) for i in part])
                self.mesh.all_reduce(flat, self.batch_axes).div_(n)
                off = 0
                for i in part:
                    gs[i] = flat[off:off + gs[i].numel()].view(gs[i].shape)
                    off += gs[i].numel()
        return [sh.shard_of(g, e[1], self.mesh).clone()
                if sh.sharded(self.mesh, e[1]) else
                g.clone() if n > 1 else g
                for g, e in zip(gs, entries)]


def _assemble(pieces, spec, full_shape, shard_shape, mesh, axes):
    """The whole tensor from the shards of every rank on ``axes``
    (``pieces[j]`` from the rank at row-major index j over them): the
    block of each rank at coordinate 0 on the axes ``spec`` does not name
    (the others hold copies of it), its axes moved beside the dimension
    they split, in one copy."""
    mine = {a for e in spec for a in sh.spec_axes(e)}
    x = pieces.view(*(mesh.axis_size(a) for a in axes), *shard_shape)
    for i in reversed(range(len(axes))):
        if axes[i] not in mine:
            x = x.select(i, 0)
    kept = [a for a in axes if a in mine]
    order, split = [], []
    for d, entry in enumerate(spec):
        for a in mesh.axes(sh.spec_axes(entry)):
            if a in kept:
                order.append(kept.index(a))
                split.append(mesh.axis_size(a))
        order.append(len(kept) + d)
        split.append(shard_shape[d])
    full = pieces.new_empty(full_shape)
    full.view(split).copy_(x.permute(order))
    return full


class _GatherUnit(torch.autograd.Function):
    """shards → whole parameters (an all-gather); its backward sums the
    whole gradients over the batch axes and cuts the shards' out."""

    @staticmethod
    def forward(ctx, units, key, *shards):
        ctx.units, ctx.key = units, key
        ctx.kinds = [(s.dtype, s.device) for s in shards]
        return tuple(units.gather(key, shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.units.reduce(ctx.key, grads, ctx.kinds))


def _unit_key(name: str) -> str:
    parts = name.split(".")
    last = max((i for i, p in enumerate(parts) if p.isdigit()), default=0)
    return ".".join(parts[:last + 1])


def place_model(model: nn.Module, specs: dict, mesh, *,
                batch_axes: tuple = (), state: dict | None = None
                ) -> nn.Module:
    """Hold ``model``'s parameters as this rank's shards under ``specs``
    (name → spec, ``meta["specs"]["params"]``), in place, on the mesh's
    device; ``named_parameters()`` then yields the shards under their
    names.  ``state`` (name → whole tensor, e.g. a state dict mapped from
    a file) is where the shards are cut from; by default the model's own
    parameters, which may then lie on the meta device only with a
    ``state``.  Reading a parameter attribute (``blk.attn.wq.weight``)
    gathers its unit (``_Units``).  ``batch_axes``: the axes whose ranks
    hold other batch rows, over which the gradients are summed.  Load
    weights before placing: a parameter attribute is read-only after."""
    if "_lm_units" in model.__dict__:
        raise ValueError("this model is already placed on a mesh")
    dev = _device(mesh)
    units = _Units(mesh, batch_axes)
    owners: dict = {}
    for name, p in list(model.named_parameters()):
        module = model.get_submodule(name.rpartition(".")[0])
        attr = name.rpartition(".")[2]
        src = state[name] if state is not None else p.detach()
        shard = nn.Parameter(sh.shard_of(src, specs[name], mesh).to(
            dev, dtype=p.dtype, copy=True),
            requires_grad=p.requires_grad)
        module._parameters[attr] = shard
        key = _unit_key(name)
        units.where[(id(module), attr)] = (key, len(units.units.get(key,
                                                                    [])))
        units.units.setdefault(key, []).append(
            (name, specs[name], tuple(p.shape)))
        units.params.setdefault(key, []).append(shard)
        owners.setdefault(id(module), (module, []))[1].append(attr)
    for module, attrs in owners.values():
        cls = type(module)
        props = {a: property(lambda m, a=a: units.full(m, a)) for a in attrs}
        module.__class__ = type(cls.__name__, (cls,), props)
    model.__dict__["_lm_units"] = units
    return model


def place(tree: dict, specs: dict, mesh) -> dict:
    """This rank's shard of every tensor of a batch or cache (nested dicts)
    under ``specs``, on the mesh's device; host values are kept."""
    dev = _device(mesh)
    return sh.map_tree(lambda t, s: sh.shard_of(t, s, mesh).to(
        dev, copy=True), tree, specs)


def _device(mesh) -> torch.device:
    if mesh.device is None:
        raise ValueError("a layout-only mesh holds no data: build the mesh "
                         "with make_lm_mesh or make_host_mesh, which give it "
                         "this rank's device")
    return mesh.device


def _effective(spec, mesh) -> tuple:
    return tuple(tuple(a for a in mesh.axes(sh.spec_axes(e))
                       if mesh.axis_size(a) > 1) for e in spec)


def _units(model: nn.Module, mesh, specs: dict, batch_axes: tuple):
    """The model's ``_Units``; a model that was not placed is accepted
    only where no spec splits it and no axis splits the batch."""
    units = model.__dict__.get("_lm_units")
    if units is None and (mesh.axis_size(batch_axes) > 1 or any(
            sh.sharded(mesh, s) for s in specs.values())):
        raise ValueError("place the model on the mesh first "
                         "(steps.place_model with meta['specs']['params'])")
    return units


@contextlib.contextmanager
def _active(mesh, rows: tuple, *, flash_decode: bool = False,
            cache_specs: dict | None = None):
    """The model hooks' mesh state while a step runs (restored after):
    ``rows`` the axes that split the step's batch rows, ``cache_specs``
    the decode cache's specs (with them the ``layer_state`` hook)."""
    saved, saved_cache = L.mesh_axes(), L.cache_layout()
    L.set_mesh_axes(rows, mesh.axis_size(rows),
                    mesh_axis_sizes(mesh).get("model", 1), mesh=mesh,
                    flash_decode=flash_decode)
    hook = _LayerStates(mesh, cache_specs, rows) if cache_specs else None
    L.set_cache_layout(cache_specs or {}, hook)
    try:
        yield
    finally:
        L.set_mesh_axes(*saved[0], **saved[1])
        L.set_cache_layout(*saved_cache)


def _rows_of(spec, mesh) -> tuple:
    """The axes that split a batch leaf's rows under its spec."""
    return _effective(spec, mesh)[0] if spec else ()


class _LayerStates:
    """The ``layers.layer_state`` hook of a decode step: one layer's
    recurrent state with this rank's batch rows (split over ``rows``, as
    the tokens are) and every other dim whole, for the step to write in
    place; on leaving, each leaf is cut back to this rank's shard under
    its spec.  A leaf whose spec splits its batch dim over ``rows`` keeps
    it (one all-gather of its other split dims; the cut back moves
    nothing); one split otherwise (a batch of 1: a state dim over the
    data axes) is gathered whole and its rows cut, and after the step
    its rows are gathered again to cut the shard.  Where the spec splits
    a layer-stack dim, the layer is the owner's: gathered over those
    axes, and written back by the ranks that hold it."""

    def __init__(self, mesh, specs: dict, rows: tuple):
        self.mesh, self.specs, self.rows = mesh, specs, rows

    @contextlib.contextmanager
    def __call__(self, state: dict, idx: tuple, key: str):
        run, backs = {}, []
        for name, t in state.items():
            run[name], back = self._take(t, self.specs[key][name], idx)
            backs.append(back)
        yield run
        for back in backs:
            back()

    def _take(self, t, spec, idx):
        """→ (layer ``idx`` of ``t`` for the step, the write-back)."""
        mesh, rows = self.mesh, self.rows
        layer, mine = _layer_of(t, spec, idx, mesh)
        tail = spec[len(idx):]
        same = _effective(tail, mesh)[0] == rows
        gspec = (None, *tail[1:]) if same else tail
        cut = (rows,) + (None,) * (len(tail) - 1)
        whole = sh.gather_leaf(layer, gspec, mesh)
        run = whole if same else sh.shard_of(whole, cut, mesh)

        def back():
            w = run if same else sh.gather_leaf(run, cut, mesh)
            out = sh.shard_of(w, gspec, mesh)
            if mine is not None and out is not mine:
                mine.copy_(out)
        return run, back


def _layer_of(t, spec, idx: tuple, mesh):
    """Layer ``idx`` (indices of the leading layer-stack dims) of the
    stacked leaf whose shard under ``spec`` is ``t``: (its shard under
    the rest of the spec, the tensor of ``t`` it is where this rank holds
    the layer, else None).  Where the spec splits a stack dim, the ranks
    whose index over its axes holds the layer's index have it: one
    all-gather over those axes, the owners' piece taken."""
    lead = [_effective((e,), mesh)[0] for e in spec[:len(idx)]]
    if not any(lead):
        view = t[idx]
        return view, view
    loc, coord = [], {}
    for d, axes in enumerate(lead):
        size = t.shape[d]
        loc.append(idx[d] % size)
        c = idx[d] // size
        for a in reversed(axes):
            coord[a], c = c % mesh.axis_size(a), c // mesh.axis_size(a)
    local = t[tuple(loc)]
    axes = mesh.axes(tuple(coord))
    pieces = mesh.all_gather(local[None], 0, axes)
    j = 0
    for a in axes:
        j = j * mesh.axis_size(a) + coord[a]
    owner = all(mesh.index(a) == coord[a] for a in axes)
    return pieces[j], local if owner else None


# ------------------------------------------------------------------ steps


def _dp(mesh) -> int:
    return math.prod(n for a, n in mesh_axis_sizes(mesh).items()
                     if a in ("pod", "data"))


def choose_microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                        seq_parallel: bool, budget_bytes: float = 4e9
                        ) -> int:
    """Gradient-accumulation factor: smallest divisor of the per-device
    batch keeping the layer-carry residual stack under `budget_bytes`."""
    dp = _dp(mesh)
    msize = mesh_axis_sizes(mesh).get("model", 1)
    b_loc = max(shape.global_batch // dp, 1)
    tokens = b_loc * shape.seq_len
    if seq_parallel:
        tokens = tokens // msize
    layers = cfg.n_layers + (cfg.n_enc_layers or 0)
    resid = layers * tokens * cfg.d_model * 6        # f32 + bf16 copies
    micro = 1
    while resid / micro > budget_bytes and micro < b_loc:
        micro *= 2
    while shape.global_batch % (micro * dp) and micro > 1:
        micro //= 2
    return micro


def make_train_step(api: ModelApi, mesh, shape: ShapeConfig, *,
                    dtype=torch.bfloat16, lr: float = 3e-4,
                    num_micro: int | None = None,
                    sharding_mode: str = "2d"):
    """loss + grad + AdamW update, FSDP × TP sharded storage,
    gradient-accumulation micro-batching.

    ``step_fn(model, opt, batch) → (loss, model, opt)``: ``model`` placed
    (``place_model``), ``opt`` its ``optimizer.init``, ``batch`` this
    rank's rows (``place``).  The loss is the whole batch's mean on every
    rank; the model and ``opt`` are updated in place.  With ``num_micro``
    > 1 the rows go in that many micro-batches whose gradients are summed
    and divided by ``num_micro``, the loss their mean.

    ``step_fn.micro_batches(batch)``, ``step_fn.micro_step(model,
    part)`` and ``step_fn.finish(model, opt, losses)`` are its parts
    (``launch.dryrun`` counts one micro-batch and the rest apart):
    ``step_fn`` zeroes the gradients, runs ``micro_step`` on each of
    ``micro_batches``' parts (micro-batch ``i`` is the reference's rows
    of it across the ranks), then ``finish``.

    sharding_mode="fsdp": pure FSDP over all axes, the batch split over
    all of them.  The activations here are whole (no sequence
    parallelism), so ``num_micro`` (when not given) is chosen for whole
    activations and ``meta["seq_parallel"]`` is False."""
    cfg = api.cfg
    batch_axes = dp_axes(mesh) if sharding_mode == "2d" \
        else tuple(mesh.axis_names)
    if num_micro is None:
        num_micro = choose_microbatches(cfg, shape, mesh, seq_parallel=False)
    params_s = ispec.params_structs(api, dtype)
    opt_s = optimizer.AdamWState(
        step=0, mu={n: ispec.sds(p.shape, torch.float32)
                    for n, p in params_s.named_parameters()},
        nu={n: ispec.sds(p.shape, torch.float32)
            for n, p in params_s.named_parameters()})
    batch_s = ispec.train_batch_specs(cfg, shape, dtype)
    p_spec = sh.param_specs(mesh, params_s, fsdp=True, mode=sharding_mode)
    b_spec = sh.batch_specs(mesh, batch_s, mode=sharding_mode)
    n_dp = mesh.axis_size(batch_axes)
    rows_axes = _rows_of(b_spec["tokens"], mesh)

    def clear(model):
        units = _units(model, mesh, p_spec, batch_axes)
        if units is not None:
            units.clear()

    def micro_step(model, part):
        """One micro-batch's forward and backward, its gradients added to
        the parameters' ``.grad``; → its loss, detached."""
        with _active(mesh, rows_axes):
            clear(model)
            loss = loss_fn(api, model, part)
            clear(model)
            loss.backward()
        return loss.detach()

    def finish(model, opt, losses):
        """The update from the gradients ``num_micro`` micro-batches
        summed, whose losses are ``losses``; → (loss, model, opt)."""
        with _active(mesh, rows_axes):
            params = dict(model.named_parameters())
            if num_micro > 1:
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(num_micro)
                loss = torch.stack(losses).mean()
            else:
                loss = losses[0]
            if n_dp > 1:           # the whole batch's mean
                loss = mesh.all_reduce(loss.clone(), batch_axes) / n_dp
            _, opt = optimizer.update(_grads(params), opt, params, lr=lr,
                                      mesh=mesh, specs=p_spec)
            model.zero_grad(set_to_none=True)
            clear(model)
        return loss, model, opt

    def micro_batches(batch):
        """This rank's part of each micro-batch: micro-batch ``i`` is the
        reference's, the whole batch's rows ``[i·B/n, (i+1)·B/n)``, of
        which rank ``r`` over the batch rows' axes takes block ``r``
        (from one all-gather of the batch where they split it)."""
        rows = next(iter(batch.values())).shape[0]
        if rows % num_micro:
            raise ValueError(f"{rows} rows do not split into "
                             f"{num_micro} micro-batches")
        if num_micro == 1:
            return [batch]
        m, n, r = rows // num_micro, mesh.axis_size(rows_axes), \
            mesh.index(rows_axes)
        whole = {k: mesh.all_gather(v, 0, rows_axes)
                 for k, v in batch.items()}
        return [{k: v[(i * n + r) * m:(i * n + r + 1) * m]
                 for k, v in whole.items()} for i in range(num_micro)]

    def train_step(model, opt, batch):
        clear(model)
        model.zero_grad(set_to_none=True)
        losses = [micro_step(model, part) for part in micro_batches(batch)]
        return finish(model, opt, losses)

    train_step.micro_step, train_step.finish = micro_step, finish
    train_step.micro_batches = micro_batches

    p_pl = sh.named(mesh, p_spec)
    in_pl = (p_pl, optimizer.AdamWState(step=None, mu=p_pl, nu=p_pl),
             sh.named(mesh, b_spec))
    out_pl = (sh.named(mesh, ()), in_pl[0], in_pl[1])
    meta = {"num_micro": num_micro, "seq_parallel": False,
            "tensor_parallel": False, "cost_repeat": num_micro,
            "sharding_mode": sharding_mode, "batch_axes": batch_axes,
            "specs": {"params": p_spec, "batch": b_spec}}
    return train_step, (params_s, opt_s, batch_s), in_pl, out_pl, meta


def make_prefill_step(api: ModelApi, mesh, shape: ShapeConfig, *,
                      dtype=torch.bfloat16, cache_len: int | None = None):
    """Prompt pass → last-position logits (inference prefill), weights
    TP-only: ``step_fn(model, batch)`` → (B_l, 1, V).

    ``cache_len`` (the transformer families): ``step_fn(model, batch,
    cache)`` → (logits (B_l, V), cache) through ``transformer.prefill``,
    which fills this rank's shard of a decode cache of ``cache_len``
    positions (placed as ``make_decode_step`` places it,
    ``meta["specs"]["cache"]``)."""
    cfg = api.cfg
    params_s = ispec.params_structs(api, dtype)
    batch_s = ispec.prefill_batch_specs(cfg, shape, dtype)
    p_spec = sh.param_specs(mesh, params_s, fsdp=False)   # weights TP-only
    b_spec = sh.batch_specs(mesh, batch_s)
    specs = {"params": p_spec, "batch": b_spec}
    rows_axes = _rows_of(next(iter(b_spec.values())), mesh)
    structs = (params_s, batch_s)
    flash = _flash(cfg, mesh)
    fill_cache = cache_len is not None
    if fill_cache:
        if cfg.enc_dec or cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"{cfg.name}: a cache_len needs the "
                             f"transformer's prefill")
        cache_s = ispec.cache_structs(api, shape.global_batch, cache_len,
                                      dtype)
        specs["cache"] = _decode_cache_specs(cfg, mesh, cache_s)
        structs = structs + (cache_s,)

    @torch.no_grad()
    def prefill_step(model, batch, cache=None):
        units = _units(model, mesh, p_spec, ())
        with _active(mesh, rows_axes, flash_decode=flash,
                     cache_specs=specs.get("cache")):
            if units is not None:
                units.clear()
            if fill_cache:
                out = transformer.prefill(model, batch.get("tokens"), cfg,
                                          cache, embeds=batch.get("embeds"))
            else:
                out = api.forward(model, batch, last_only=True,
                                  remat=False)[0]
            if units is not None:
                units.clear()
        return out

    rows = _rows(mesh, shape)
    in_pl = tuple(sh.named(mesh, s) for s in
                  (p_spec, b_spec, *((specs["cache"],) if fill_cache
                                     else ())))
    logits_pl = sh.named(mesh, (rows, None) if fill_cache
                         else (rows, None, None))
    out_pl = (logits_pl, in_pl[2]) if fill_cache else logits_pl
    return prefill_step, structs, in_pl, out_pl, {
        "cost_repeat": 1, "tensor_parallel": False, "specs": specs,
        "flash_decode": flash}


def _rows(mesh, shape: ShapeConfig):
    """The batch axes of a step's logits, None where the batch is whole."""
    return dp_axes(mesh) if shape.global_batch % _dp(mesh) == 0 else None


def _flash(cfg: ArchConfig, mesh) -> bool:
    """Flash decode runs exactly where the cache falls back to sequence
    sharding: the KV heads do not divide the model axis."""
    return cfg.n_kv_heads % mesh_axis_sizes(mesh).get("model", 1) != 0


def _decode_cache_specs(cfg: ArchConfig, mesh, cache_s: dict) -> dict:
    """The ported cache specs, checked against what flash decode needs:
    where it is on (the KV heads do not divide the model axis) a KV cache
    that is whole on every rank is refused, as the reference's flash
    decode refuses a sequence the axis does not divide."""
    specs = sh.cache_specs(mesh, cache_s)
    if cfg.enc_dec or cfg.family in ("ssm", "hybrid"):
        return specs
    if _flash(cfg, mesh) and not _effective(specs["k"], mesh)[2]:
        raise ValueError(
            f"{cfg.name}: flash decode splits the cache's "
            f"{cache_s['k'].shape[2]} positions over the model axis of "
            f"{mesh_axis_sizes(mesh)['model']}, which does not divide them")
    return specs


def make_decode_step(api: ModelApi, mesh, shape: ShapeConfig, *,
                     dtype=torch.bfloat16):
    """One-token serve_step against a seq_len KV cache:
    ``step_fn(model, tokens, cache)`` → (logits (B_l, V), cache), the
    cache this rank's shard (``place``), updated in place and returned.

    Flash decode is on exactly when the KV heads don't divide the model
    axis (the reference's ``meta["flash_decode"]``); the attention
    combines chunks over whatever axes split the cache's sequence
    (``model`` then, the data axes for a batch that does not divide
    them).  Every cache leaf stays in its spec: a KV cache's rank writes
    its slot and KV heads, and a recurrent state goes through
    ``_LayerStates`` one layer at a time."""
    cfg = api.cfg
    flash = _flash(cfg, mesh)
    params_s = ispec.params_structs(api, dtype)
    cache_s = ispec.cache_structs(api, shape.global_batch, shape.seq_len,
                                  dtype)
    tok_s = ispec.decode_token_specs(shape)
    p_spec = sh.param_specs(mesh, params_s, fsdp=False)
    c_spec = _decode_cache_specs(cfg, mesh, cache_s)
    t_spec = sh.batch_specs(mesh, {"t": tok_s})["t"]
    rows_axes = _rows_of(t_spec, mesh)

    @torch.no_grad()
    def serve_step(model, tokens, cache):
        units = _units(model, mesh, p_spec, ())
        with _active(mesh, rows_axes, flash_decode=flash, cache_specs=c_spec):
            if units is not None:
                units.clear()
            logits, cache = api.decode_step(model, tokens, cache)
            if units is not None:
                units.clear()
        return logits, cache

    in_pl = (sh.named(mesh, p_spec), sh.named(mesh, t_spec),
             sh.named(mesh, c_spec))
    out_pl = (sh.named(mesh, (_rows(mesh, shape), None)), in_pl[2])
    return serve_step, (params_s, tok_s, cache_s), in_pl, out_pl, {
        "cost_repeat": 1, "flash_decode": flash, "tensor_parallel": False,
        "specs": {"params": p_spec, "tokens": t_spec, "cache": c_spec}}


def init_cache(api: ModelApi, batch: int, max_len: int, specs: dict, mesh,
               dtype=torch.float32) -> dict:
    """This rank's shard (under ``specs``, ``meta["specs"]["cache"]``) of
    an empty decode cache: the whole cache made on the host, then cut."""
    whole = api.init_cache(_Host, batch, max_len, dtype)
    return place(whole, specs, mesh)


class _Host:
    """Stands in for a model whose cache is made on the host."""
    embed = torch.empty(0)


def make_step(arch: ArchConfig, mesh, shape: ShapeConfig,
              dtype=torch.bfloat16, **kwargs):
    """Dispatch on shape.kind; returns (fn, structs, in_placements,
    out_placements, meta).  kwargs forward to the specific builder."""
    api = build_model(arch)
    if shape.kind == "train":
        return make_train_step(api, mesh, shape, dtype=dtype, **kwargs)
    if shape.kind == "prefill":
        return make_prefill_step(api, mesh, shape, dtype=dtype, **kwargs)
    return make_decode_step(api, mesh, shape, dtype=dtype, **kwargs)
