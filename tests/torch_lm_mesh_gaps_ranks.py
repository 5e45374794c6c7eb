"""The rank side of ``tests/test_torch_lm_mesh_gaps.py``: what each of the
four spawned gloo ranks runs on the (1, 4), (2, 2) and (4, 1) meshes.  It
imports no JAX (only the test process does)."""

import os

import torch

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.input_specs import params_structs
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import build_model
from repro_torch.train import optimizer
from torch_lm_mesh_ranks import clone, spied_step

MOE = "mixtral-8x22b"
FAMILIES = ("zamba2-1.2b", "xlstm-1.3b", "whisper-medium")
MESHES = {"14": (1, 4), "22": (2, 2), "41": (4, 1)}
# the MoE train batch, 8 x 16: one group of 128 tokens (64 a micro-batch
# of 2) that spans the ranks of the batch axes
MOE_TRAIN = (("22", 1), ("22", 2), ("41", 1), ("41", 2))  # (mesh, micro)
MOE_B, MOE_S = 8, 16
# MoE serving on (4, 1): a prefill of 8 x 4 and 4 decode steps of 8
# tokens, one group whose capacity is 5 (a rank's 2 tokens alone: 1)
MOE_PROMPT, MOE_STEPS = 4, 4
FAM_B, FAM_PROMPT, FAM_LEN, FAM_STEPS = 4, 8, 8, 4
ONE_LEN = 8                      # zamba2 at batch 1: 8 positions
LR = 3e-4
F32 = dict(dtype=torch.float32)


def moe_train(api, mesh, state, f, micro: int) -> dict:
    """One "2d" train step from ``state`` on this rank's rows."""
    shape = ShapeConfig("train", MOE_S, MOE_B, "train")
    step, _, _, _, meta = steps.make_train_step(api, mesh, shape, lr=LR,
                                                num_micro=micro, **F32)
    specs = meta["specs"]["params"]
    model = steps.place_model(params_structs(api, torch.float32), specs,
                              mesh, batch_axes=meta["batch_axes"],
                              state=state)
    batch = steps.place({"tokens": f["tokens"], "labels": f["labels"]},
                        meta["specs"]["batch"], mesh)
    return {**spied_step(step, model, optimizer.init(model), batch, specs,
                         mesh), "num_micro": meta["num_micro"]}


def moe_serve(api, mesh, state, f) -> dict:
    """The prefill step, the prefill that fills the cache and the decode
    steps on it: this rank's rows' logits."""
    prompt = f["prompt"]
    b, s = prompt.shape
    max_len = s + MOE_STEPS
    pshape = ShapeConfig("p", s, b, "prefill")
    plain, *_ = steps.make_prefill_step(api, mesh, pshape, **F32)
    fill, *_, pmeta = steps.make_prefill_step(api, mesh, pshape,
                                              cache_len=max_len, **F32)
    dec, *_, dmeta = steps.make_decode_step(
        api, mesh, ShapeConfig("d", max_len, b, "decode"), **F32)
    model = steps.place_model(params_structs(api, torch.float32),
                              dmeta["specs"]["params"], mesh, state=state)
    batch = steps.place({"tokens": prompt}, pmeta["specs"]["batch"], mesh)
    cache = steps.init_cache(api, b, max_len, dmeta["specs"]["cache"], mesh)
    out = {"prefill": plain(model, batch)}
    out["fill"], cache = fill(model, batch, cache)
    out["decode"] = [dec(model, _tokens(tok, dmeta, mesh), cache)[0]
                     for tok in f["decode"]]
    return out


def _tokens(tok, meta, mesh):
    return steps.place({"t": tok}, {"t": meta["specs"]["tokens"]},
                       mesh)["t"]


def _one_process(api, state):
    """The weights in a one-process model (to fill whisper's cross K/V
    where the reference's prefill_encoder runs on one device)."""
    model = api.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state[n])
    return model


def family_serve(name: str, mesh, state, f) -> dict:
    """A family's prefill step (last-position logits) and 4 decode steps
    from an empty cache (whisper: the encoded frames' cross K/V), placed
    by the decode step's specs; its logits and its cache shard after."""
    cfg = ARCHS[name].reduced()
    api = build_model(cfg)
    batch = {k: f[k] for k in ("tokens", "frames") if k in f}
    b, s = batch["tokens"].shape
    plain, *_, pmeta = steps.make_prefill_step(
        api, mesh, ShapeConfig("p", s, b, "prefill"), **F32)
    dec, *_, dmeta = steps.make_decode_step(
        api, mesh, ShapeConfig("d", FAM_LEN, b, "decode"), **F32)
    model = steps.place_model(params_structs(api, torch.float32),
                              dmeta["specs"]["params"], mesh, state=state)
    out = {"prefill": plain(model, steps.place(batch, pmeta["specs"]["batch"],
                                               mesh))}
    if cfg.enc_dec:
        one = _one_process(api, state)
        with torch.no_grad():
            whole = api.prefill(one, {"frames": batch["frames"]},
                                api.init_cache(one, b, FAM_LEN))
        cache = steps.place(whole, dmeta["specs"]["cache"], mesh)
    else:
        cache = steps.init_cache(api, b, FAM_LEN, dmeta["specs"]["cache"],
                                 mesh)
    out["decode"] = [dec(model, _tokens(f["decode"][:, i:i + 1], dmeta,
                                        mesh), cache)[0]
                     for i in range(FAM_STEPS)]
    out["cache"], out["specs"] = clone(cache), dmeta["specs"]["cache"]
    return out


def zamba_one(mesh, state, f) -> dict:
    """zamba2 at batch 1: 4 decode steps from an empty cache whose
    sequence the data axes split; the logits and the cache shard."""
    cfg = ARCHS["zamba2-1.2b"].reduced()
    api = build_model(cfg)
    dec, *_, dmeta = steps.make_decode_step(
        api, mesh, ShapeConfig("d", ONE_LEN, 1, "decode"), **F32)
    model = steps.place_model(params_structs(api, torch.float32),
                              dmeta["specs"]["params"], mesh, state=state)
    cache = steps.init_cache(api, 1, ONE_LEN, dmeta["specs"]["cache"], mesh)
    out = {"decode": [dec(model, _tokens(f["one"][:, i:i + 1], dmeta, mesh),
                          cache)[0] for i in range(FAM_STEPS)]}
    out["cache"], out["specs"] = clone(cache), dmeta["specs"]["cache"]
    return out


def rank_main(rank: int, world: int, port: int, path: str) -> None:
    """One gloo rank: every case; its results to ``path/rank{rank}.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        meshes = {k: make_lm_mesh(v, ("data", "model"), device="cpu")
                  for k, v in MESHES.items()}
        files = {n: torch.load(os.path.join(path, f"{n}.pt"))
                 for n in (MOE,) + FAMILIES}
        out = {"coords": {k: m.coords for k, m in meshes.items()}}
        f = files[MOE]
        api = build_model(ARCHS[MOE].reduced())
        out["moe_train"] = {(m, micro): moe_train(api, meshes[m], f["state"],
                                                  f, micro)
                            for m, micro in MOE_TRAIN}
        out["moe_serve"] = moe_serve(api, meshes["41"], f["state"], f)
        for name in FAMILIES:
            out[name] = {m: family_serve(name, meshes[m],
                                         files[name]["state"], files[name])
                         for m in ("14", "22")}
        out["zamba_one"] = {m: zamba_one(meshes[m],
                                         files["zamba2-1.2b"]["state"],
                                         files["zamba2-1.2b"])
                            for m in ("41", "22")}
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
