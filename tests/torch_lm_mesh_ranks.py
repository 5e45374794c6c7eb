"""The rank side of ``tests/test_torch_lm_mesh.py``: what each of the four
spawned gloo ranks runs on its three meshes, (1, 4), (2, 2) and (4, 1).
It imports no JAX (only the test process does), so each rank starts in
the time torch takes."""

import os

import numpy as np
import torch

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.launch.input_specs import params_structs
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import build_model, loss_fn
from repro_torch.models.flash_decode import flash_decode
from repro_torch.train import optimizer

ARCH = "qwen2.5-3b"
TRAIN_CASES = (("2d", 1), ("fsdp", 1), ("2d", 2))     # (mode, num_micro)
FAMILIES = ("zamba2-1.2b", "xlstm-1.3b", "whisper-medium")
FAMILY_BATCH, FAMILY_SEQ, FAMILY_STEPS = 4, 8, 2
LR = 3e-4


def gathered(model, specs, mesh) -> dict:
    """Every parameter of a placed model whole (shards gathered)."""
    return {n: sh.gather_leaf(p.detach(), specs[n], mesh)
            for n, p in model.named_parameters()}


def spied_step(step, model, opt, batch, specs, mesh) -> dict:
    """One train step, with the gradients it hands the optimizer (before
    the clip scales them) gathered on the way: the loss, those gradients,
    their global norm over the shards and the updated parameters,
    whole."""
    seen, real = {}, optimizer.update

    def spy(grads, state, params, **kw):
        seen["norm"] = float(optimizer.global_norm(grads, mesh=kw["mesh"],
                                                   specs=kw["specs"]))
        seen["grads"] = {n: sh.gather_leaf(g.detach().clone(), specs[n],
                                           mesh) for n, g in grads.items()}
        return real(grads, state, params, **kw)

    optimizer.update = spy
    try:
        loss, model, opt = step(model, opt, batch)
    finally:
        optimizer.update = real
    return {"loss": loss, "grads": seen["grads"], "norm": seen["norm"],
            "params": gathered(model, specs, mesh), "opt_step": opt.step}


def flash_case(mesh, f) -> dict:
    """``flash_decode`` on this rank's chunk of the cache, without and
    with a window of 16."""
    q, k, v = (torch.from_numpy(f[n]) for n in ("q", "k", "v"))
    spec = (None, "model", None, None)
    kc, vc = sh.shard_of(k, spec, mesh), sh.shard_of(v, spec, mesh)
    n_rep = q.shape[2] // k.shape[2]
    pos = int(f["pos"])
    return {w: flash_decode(q, kc, vc, pos, mesh=mesh, dp_axes=("data",),
                            n_rep=n_rep, window=w) for w in (None, 16)}


def serve_case(api, mesh, state, f) -> dict:
    """The prefill step (JAX's, last-position logits), the prefill step
    that fills the cache, and decode steps on it: this rank's rows."""
    prompt = torch.from_numpy(f["prompt"])
    b, s = prompt.shape
    dec_tokens = torch.from_numpy(f["decode"])             # (steps, B, 1)
    max_len = int(f["max_len"])
    pshape = ShapeConfig("prefill", s, b, "prefill")
    dshape = ShapeConfig("decode", max_len, b, "decode")
    kw = dict(dtype=torch.float32)
    plain, *_ = steps.make_prefill_step(api, mesh, pshape, **kw)
    fill, _, _, _, pmeta = steps.make_prefill_step(api, mesh, pshape,
                                                   cache_len=max_len, **kw)
    dec, _, _, _, dmeta = steps.make_decode_step(api, mesh, dshape, **kw)
    model = steps.place_model(params_structs(api, torch.float32),
                              dmeta["specs"]["params"], mesh, state=state)
    batch = steps.place({"tokens": prompt}, pmeta["specs"]["batch"], mesh)
    cache = steps.init_cache(api, b, max_len, dmeta["specs"]["cache"], mesh)
    out = {"prefill": plain(model, batch)}
    logits, cache = fill(model, batch, cache)
    out["fill"] = logits
    out["decode"] = []
    for tok in dec_tokens:
        t = steps.place({"t": tok}, {"t": dmeta["specs"]["tokens"]},
                        mesh)["t"]
        logits, cache = dec(model, t, cache)
        out["decode"].append(logits)
    out["flash_decode"] = dmeta["flash_decode"]
    out["cache_k"] = cache["k"]
    return out


def train_case(api, mesh, state, f, mode: str, micro: int) -> dict:
    """One train step from ``state`` on this rank's rows: the loss and
    every parameter gathered after the update."""
    tokens = torch.from_numpy(f["tokens"])
    shape = ShapeConfig("train", tokens.shape[1], tokens.shape[0], "train")
    step, _, _, _, meta = steps.make_train_step(
        api, mesh, shape, dtype=torch.float32, lr=LR, num_micro=micro,
        sharding_mode=mode)
    specs = meta["specs"]["params"]
    model = steps.place_model(params_structs(api, torch.float32), specs,
                              mesh, batch_axes=meta["batch_axes"],
                              state=state)
    batch = steps.place({"tokens": tokens,
                         "labels": torch.from_numpy(f["labels"])},
                        meta["specs"]["batch"], mesh)
    return {**spied_step(step, model, optimizer.init(model), batch, specs,
                         mesh), "num_micro": meta["num_micro"]}


def clone(tree: dict) -> dict:
    return {k: clone(v) if isinstance(v, dict) else
            v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def family_case(name: str, m22, m41, path: str) -> dict:
    """A family's train step on (2, 2) from JAX's weights and batch
    (``path/{name}.pt``), its data-parallel decode on (4, 1) beside the
    one-process decode of the same weights (every rank computes that
    too), and the axes its (2, 2) decode cache's specs name."""
    cfg = ARCHS[name].reduced()
    api = build_model(cfg)
    f = torch.load(os.path.join(path, f"{name}.pt"))
    state, batch = f["state"], f["batch"]
    model = api.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state[n])
        # one process: decode from an empty (or encoded) cache
        cache = api.init_cache(model, FAMILY_BATCH, FAMILY_SEQ)
        if cfg.enc_dec:
            cache = api.prefill(model, batch, cache)
        enc = clone(cache)
        out = {"plain_decode": [
            api.decode_step(model, batch["tokens"][:, i:i + 1], cache)[0]
            for i in range(FAMILY_STEPS)]}
    # the train step on (2, 2)
    shape = ShapeConfig("train", FAMILY_SEQ, FAMILY_BATCH, "train")
    step, _, _, _, meta = steps.make_train_step(api, m22, shape,
                                                dtype=torch.float32, lr=LR)
    specs = meta["specs"]["params"]
    placed = steps.place_model(params_structs(api, torch.float32), specs,
                               m22, batch_axes=meta["batch_axes"],
                               state=state)
    out.update(spied_step(step, placed, optimizer.init(placed),
                          steps.place(batch, meta["specs"]["batch"], m22),
                          specs, m22))
    # the data-parallel decode on (4, 1), from the same cache
    dshape = ShapeConfig("decode", FAMILY_SEQ, FAMILY_BATCH, "decode")
    dec, _, _, _, dmeta = steps.make_decode_step(api, m41, dshape,
                                                 dtype=torch.float32)
    served = steps.place_model(params_structs(api, torch.float32),
                               dmeta["specs"]["params"], m41, state=state)
    cache = steps.place(enc, dmeta["specs"]["cache"], m41)
    out["decode"] = []
    for i in range(FAMILY_STEPS):
        t = steps.place({"t": batch["tokens"][:, i:i + 1]},
                        {"t": dmeta["specs"]["tokens"]}, m41)["t"]
        out["decode"].append(dec(served, t, cache)[0])
    *_, meta22 = steps.make_decode_step(api, m22, dshape,
                                        dtype=torch.float32)
    out["model_axis"] = {a for spec in _leaves(meta22["specs"]["cache"])
                         for e in spec for a in sh.spec_axes(e)}
    return out


def _leaves(tree: dict) -> list:
    return [s for v in tree.values()
            for s in (_leaves(v) if isinstance(v, dict) else [v])]


def rank_main(rank: int, world: int, port: int, path: str) -> None:
    """One gloo rank: every case on its meshes; its results to
    ``path/rank{rank}.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        f = dict(np.load(os.path.join(path, "inputs.npz")))
        state = torch.load(os.path.join(path, "weights.pt"))
        api = build_model(ARCHS[ARCH].reduced())
        m14 = make_lm_mesh((1, 4), ("data", "model"), device="cpu")
        m22 = make_lm_mesh((2, 2), ("data", "model"), device="cpu")
        m41 = make_lm_mesh((4, 1), ("data", "model"), device="cpu")
        out = {"coords": {"14": m14.coords, "22": m22.coords,
                          "41": m41.coords},
               "same_mesh": make_lm_mesh((2, 2), ("data", "model"),
                                         device="cpu") is m22,
               "flash": flash_case(m14, f),
               "serve14": serve_case(api, m14, state, f),
               "serve22": serve_case(api, m22, state, f),
               "train": {f"{mode}/{micro}": train_case(api, m22, state, f,
                                                       mode, micro)
                         for mode, micro in TRAIN_CASES}}
        for name in FAMILIES:
            out[name] = family_case(name, m22, m41, path)
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
