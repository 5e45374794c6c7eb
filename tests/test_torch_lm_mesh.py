"""The LM across processes (``repro_torch.launch.steps``, ``mesh``,
``shardings``, ``models.flash_decode``) on the CPU under ``gloo``.

Four spawned ranks (``tests/torch_lm_mesh_ranks.py``, JAX-free) run every
case on three meshes of one process group: (1, 4), (2, 2) and (4, 1).
They are held to the JAX package on the same numpy inputs and JAX's
weights of the reduced qwen2.5-3b:

  * ``flash_decode`` over a cache of 64 positions in chunks of 16 (pos
    37: the last chunk holds no valid position), with and without a
    window of 16, within 2e-5 of JAX's ``attention``;
  * a train step on (2, 2), ``"2d"``, ``"fsdp"`` and ``num_micro=2``:
    the loss within ``LOSS_RTOL`` of JAX's ``make_train_step`` function
    (built on ``make_host_mesh()``), the gradients each rank hands the
    optimizer, gathered, within ``tests/test_torch_train_grads.py``'s
    tolerance of ``jax.value_and_grad``'s (the mean over the micro-batches
    for ``num_micro=2``), and every rank's gathered updated parameters
    within ``tests/test_torch_train.py``'s optimizer tolerance of the
    one-process ``optimizer.update`` on those gradients (a sharded update
    counts each element of the clip's norm once);
  * the prefill step (JAX's last-position logits), the prefill that fills
    the cache and 4 decode steps on (1, 4) (sequence-sharded cache, flash
    decode) and (2, 2) (batch and KV heads split) within ``tests/
    test_torch_models.py``'s decode tolerance of JAX's one-process
    prefill and decode.

zamba2, xlstm and whisper from JAX's weights take a train step on
(2, 2), held the same way to ``jax.value_and_grad`` of JAX's ``loss_fn``
(loss and gradients) and to the one-process update, and decode
data-parallel on (4, 1) within the decode tolerance of the port's
one-process decode of those weights; their decode step on (2, 2) builds
with a cache split over ``model``.  Then the
single-process cases: a step on ``make_host_mesh()`` equals the plain
path bit for bit, and the builders' refusals."""

import multiprocessing
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import ARCHS, ShapeConfig  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import LMMesh, make_host_mesh, \
    make_lm_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.loop import TrainConfig, make_step_fn  # noqa: E402
from torch_lm_mesh_ranks import ARCH, FAMILIES, FAMILY_BATCH, \
    FAMILY_SEQ, LR, TRAIN_CASES, rank_main  # noqa: E402

WORLD = 4
JOIN_S = 120                     # a rank that takes longer is hung
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_flash_decode.py's
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_models.py's
LOSS_RTOL = 1e-4                 # tests/test_torch_train.py's
OPT_TOL = dict(rtol=1e-6, atol=1e-7)        # tests/test_torch_train.py's
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6           # tests/test_torch_train_grads.py's
B, S, KV, H, HD, POS = 4, 64, 2, 8, 16, 37   # tests/test_flash_decode.py's
PROMPT, MAX_LEN, DECODE_STEPS = 8, 16, 4
TRAIN_B, TRAIN_S = 4, 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grads_close(got: dict, want: dict) -> None:
    """Each gradient within 1e-4 · max|reference leaf| + 1e-6."""
    for name, w in want.items():
        w = w.detach().numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=0,
            atol=GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL,
            err_msg=name)


def _norm_close(got: dict) -> None:
    """The clip's norm over the shards counts each element once: it is
    the one-process norm of the gathered gradients, within float32 sums
    of the squares in another order (a leaf counted twice would move it
    by far more), and above the clip of 1, so the update's scale depends
    on it."""
    whole = float(optimizer.global_norm(got["grads"]))
    np.testing.assert_allclose(got["norm"], whole, rtol=1e-5)
    assert whole > 1.0


def _update_close(got: dict, state: dict, grads: dict) -> None:
    """``got`` is one AdamW step at ``LR`` from ``state`` (name → whole
    tensor) on ``grads``, within the optimizer tolerance."""
    params = {n: t.detach().clone() for n, t in state.items()}
    zeros = {n: torch.zeros_like(t) for n, t in params.items()}
    optimizer.update({n: g.clone() for n, g in grads.items()},
                     optimizer.AdamWState(0, zeros, dict(
                         (n, z.clone()) for n, z in zeros.items())),
                     params, lr=LR)
    for name, p in params.items():
        np.testing.assert_allclose(got[name].numpy(), p.numpy(), **OPT_TOL,
                                   err_msg=name)


def _jax_grads(japi, params, batch, micro: int) -> dict:
    """JAX's gradients of the loss, the mean over ``micro`` micro-batches
    of rows, by the port's parameter names."""
    cfg = ARCHS[ARCH].reduced()
    parts = [jax.tree.map(lambda a: a[i * TRAIN_B // micro:
                                      (i + 1) * TRAIN_B // micro], batch)
             for i in range(micro)]
    grads = [jax.grad(lambda p: jloss_fn(japi, p, b))(params) for b in parts]
    mean = jax.tree.map(lambda *g: np.asarray(sum(g) / micro), *grads)
    model = params_from_numpy(cfg, mean, device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


def _family_batch(cfg) -> dict:
    """``tests/test_torch_train_grads.py``'s batch at the family cases'
    size."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (FAMILY_BATCH, FAMILY_SEQ + 1)
                        ).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (FAMILY_BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _jax_family(name: str, path):
    """JAX's init of a family's reduced config and a batch, written for
    the ranks by the port's parameter names; returns what
    ``_jax_family_grads`` needs."""
    japi = jbuild_model(JARCHS[name].reduced())
    params = jax.jit(japi.init)(jax.random.PRNGKey(0))
    cfg = ARCHS[name].reduced()
    batch = _family_batch(cfg)
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    state = {n: p.detach() for n, p in model.named_parameters()}
    torch.save({"state": state, "batch": {k: torch.from_numpy(v)
                                          for k, v in batch.items()}},
               path / f"{name}.pt")
    return japi, params, batch, state


def _jax_family_grads(name: str, japi, params, batch, state):
    """(JAX's loss, its gradients by the port's names, the weights)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(japi, p, jbatch)))(params)
    shadow = params_from_numpy(ARCHS[name].reduced(),
                               jax.tree.map(np.asarray, grads), device="cpu")
    return float(loss), {n: p.detach()
                         for n, p in shadow.named_parameters()}, state


def _jax_train(japi, params, batch, mode: str, micro: int):
    """The loss of JAX's train step on ``make_host_mesh()``."""
    fn, *_ = jsteps.make_train_step(
        japi, jhost_mesh(), JShapeConfig("t", TRAIN_S, TRAIN_B, "train"),
        dtype=jnp.float32, lr=LR, num_micro=micro, sharding_mode=mode)
    # make_train_step sets the model's sharding constraints; the values
    # are the same without them, and a (1, 1) mesh of explicit axes
    # refuses them outside a mesh context
    jlayers.clear_mesh_axes()
    loss, _, _ = jax.jit(fn)(params, jopt.init(params), batch)
    return float(loss)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, request):
    """JAX's weights and inputs written for the ranks, the ranks started,
    then JAX's answers computed while they run."""
    jcfg = JARCHS[ARCH].reduced()
    japi = jbuild_model(jcfg)
    params = jax.jit(japi.init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = ARCHS[ARCH].reduced()
    model = params_from_numpy(cfg, tree, device="cpu")
    path = tmp_path_factory.mktemp("lm_mesh")
    torch.save({n: p.detach() for n, p in model.named_parameters()},
               path / "weights.pt")
    rng = np.random.default_rng(0)
    f = {"q": rng.standard_normal((B, 1, H, HD), dtype=np.float32),
         "k": rng.standard_normal((B, S, KV, HD), dtype=np.float32),
         "v": rng.standard_normal((B, S, KV, HD), dtype=np.float32),
         "pos": POS, "max_len": MAX_LEN,
         "prompt": rng.integers(0, cfg.vocab, (2, PROMPT), dtype=np.int32),
         "decode": rng.integers(0, cfg.vocab, (DECODE_STEPS, 2, 1),
                                dtype=np.int32),
         "tokens": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                                dtype=np.int32),
         "labels": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                                dtype=np.int32)}
    np.savez(path / "inputs.npz", **f)
    families = {name: _jax_family(name, path) for name in FAMILIES}
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(r, WORLD, port, str(path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()

    def stop():                       # ranks no test waited for
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    request.addfinalizer(stop)

    want = {}
    q, k, v = (jnp.asarray(f[n]) for n in ("q", "k", "v"))
    for w in (None, 16):
        want[("flash", w)] = np.asarray(jlayers.attention(
            q, jlayers.repeat_kv(k, H // KV), jlayers.repeat_kv(v, H // KV),
            causal=True, offset=POS, kv_len_valid=POS + 1, window=w))
    batch = {"tokens": jnp.asarray(f["tokens"]),
             "labels": jnp.asarray(f["labels"])}
    for mode, micro in TRAIN_CASES:
        want[("train", mode, micro)] = _jax_train(japi, params, batch, mode,
                                                  micro)
    for micro in {m for _, m in TRAIN_CASES}:
        want[("grads", micro)] = _jax_grads(japi, params, batch, micro)
    want["state"] = {n: p.detach() for n, p in model.named_parameters()}
    prompt = jnp.asarray(f["prompt"])
    want["prefill"] = np.asarray(japi.forward(
        params, {"tokens": prompt}, last_only=True)[0])
    cache = japi.init_cache(params, 2, MAX_LEN)
    logits, cache = jtransformer.prefill(params, prompt, jcfg, cache)
    want["fill"] = np.asarray(logits)
    for name, args in families.items():
        want[("family", name)] = _jax_family_grads(name, *args)
    want["decode"] = []
    for tok in f["decode"]:
        logits, cache = japi.decode_step(params, jnp.asarray(tok), cache)
        want["decode"].append(np.asarray(logits))
    return want, (path, procs)


@pytest.fixture(scope="module")
def ranks(setup):
    path, procs = setup[1]
    for p in procs:
        p.join(timeout=JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"gloo ranks {hung} did not finish in {JOIN_S} s (a " \
                     f"collective that not every rank reached?)"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(path / f"rank{r}.pt") for r in range(WORLD)]


def _rows(rank: dict, mesh: str) -> slice:
    """This rank's rows of a batch of 2 on ``mesh`` (split over data)."""
    d = rank["coords"][mesh][0]
    return slice(None) if mesh == "14" else slice(d, d + 1)


def test_meshes_are_laid_out_row_major(ranks):
    assert [r["coords"]["22"] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    assert [r["coords"]["14"] for r in ranks] == [(0, i) for i in range(4)]
    assert [r["coords"]["41"] for r in ranks] == [(i, 0) for i in range(4)]
    assert all(r["same_mesh"] for r in ranks)       # one mesh per arguments


@pytest.mark.parametrize("window", [None, 16])
def test_flash_decode_matches_jax(setup, ranks, window):
    want = setup[0][("flash", window)]
    for rank in ranks:
        np.testing.assert_allclose(rank["flash"][window].numpy(), want,
                                   **FLASH_TOL)


@pytest.mark.parametrize("mode,micro", TRAIN_CASES)
def test_train_step_matches_jax(setup, ranks, mode, micro):
    want = setup[0]
    for rank in ranks:
        got = rank["train"][f"{mode}/{micro}"]
        assert got["num_micro"] == micro and got["opt_step"] == 1
        np.testing.assert_allclose(float(got["loss"]),
                                   want[("train", mode, micro)],
                                   rtol=LOSS_RTOL)
        _grads_close(got["grads"], want[("grads", micro)])
        _norm_close(got)
        _update_close(got["params"], want["state"], got["grads"])


@pytest.mark.parametrize("mesh,flash", [("14", True), ("22", False)])
def test_prefill_and_decode_match_jax(setup, ranks, mesh, flash):
    want = setup[0]
    for rank in ranks:
        got, rows = rank[f"serve{mesh}"], _rows(rank, mesh)
        assert got["flash_decode"] is flash
        # (1, 4): a quarter of the positions, both KV heads; (2, 2): one
        # row, every position, one KV head
        assert tuple(got["cache_k"].shape[1:4]) == (
            (2, MAX_LEN // 4, KV) if flash else (1, MAX_LEN, 1))
        np.testing.assert_allclose(got["prefill"].numpy(),
                                   want["prefill"][rows], **DECODE_TOL)
        np.testing.assert_allclose(got["fill"].numpy(), want["fill"][rows],
                                   **DECODE_TOL)
        for g, w in zip(got["decode"], want["decode"]):
            np.testing.assert_allclose(g.numpy(), w[rows], **DECODE_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_and_data_parallel_decode(setup, ranks, name):
    """zamba2, xlstm, whisper: the (2, 2) train step against JAX's loss
    and gradients and the one-process update, the (4, 1) decode against
    the one-process decode of the same weights, and the model-axis decode
    built, a cache leaf split over ``model`` (its values:
    ``tests/test_torch_lm_mesh_gaps.py``)."""
    loss, grads, state = setup[0][("family", name)]
    for rank in ranks:
        got = rank[name]
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
        _grads_close(got["grads"], grads)
        _norm_close(got)
        _update_close(got["params"], state, got["grads"])
        d = rank["coords"]["41"][0]
        for g, w in zip(got["decode"], got["plain_decode"]):
            np.testing.assert_allclose(g.numpy(), w[d:d + 1].numpy(),
                                       **DECODE_TOL)
        assert "model" in got["model_axis"]


# ----------------------------------------------------- one process


def test_host_mesh_steps_are_the_plain_path():
    """On ``make_host_mesh()`` a train step is ``make_step_fn``'s and the
    prefill and decode steps are ``transformer.prefill`` and
    ``decode_step``'s, bit for bit."""
    cfg = ARCHS[ARCH].reduced()
    api = build_model(cfg)
    mesh = make_host_mesh(device="cpu")
    assert make_host_mesh(device="cpu") is mesh and mesh.shape == (1, 1)
    one = api.init(torch.Generator().manual_seed(0), device="cpu")
    two = api.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 8), generator=gen)
             for k in ("tokens", "labels")}
    step, *_ = steps.make_train_step(api, mesh,
                                     ShapeConfig("t", 8, 2, "train"),
                                     dtype=torch.float32)
    loss, one, _ = step(one, optimizer.init(one), batch)
    want, two, _ = make_step_fn(api, TrainConfig())(two, optimizer.init(two),
                                                    batch)
    assert torch.equal(loss, want)
    for (n, a), b in zip(one.named_parameters(), two.parameters()):
        assert torch.equal(a, b), n
    fill, *_, meta = steps.make_prefill_step(
        api, mesh, ShapeConfig("p", 8, 2, "prefill"), dtype=torch.float32,
        cache_len=12)
    dec, *_ = steps.make_decode_step(api, mesh,
                                     ShapeConfig("d", 12, 2, "decode"),
                                     dtype=torch.float32)
    cache = steps.init_cache(api, 2, 12, meta["specs"]["cache"], mesh)
    plain = transformer.init_cache(cfg, 2, 12, device="cpu")
    got, cache = fill(one, {"tokens": batch["tokens"]}, cache)
    ref, plain = transformer.prefill(one, batch["tokens"], cfg, plain)
    assert torch.equal(got, ref)
    for i in range(3):
        tok = batch["labels"][:, i:i + 1]
        got, cache = dec(one, tok, cache)
        ref, plain = transformer.decode_step(one, tok, plain, cfg)
        assert torch.equal(got, ref)
    assert torch.equal(cache["k"], plain["k"]) and cache["len"] == 11


def test_lm_meshes_need_their_processes():
    with pytest.raises(ValueError, match="256 processes"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 processes"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        make_lm_mesh((2, 2), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
    with pytest.raises(ValueError, match="no process group"):
        LMMesh(("data", "model"), (2, 2)).all_gather(torch.zeros(1), 0,
                                                     "model")


def test_builders_refuse_what_local_tensors_cannot_run():
    """On a layout-only (2, 2) mesh (the builders read only its names and
    sizes): flash decode over positions the model axis does not divide,
    and flash decode asked for as an option.  (A split MoE batch, the
    model-axis steps of the state and cross-attention caches and a cache
    whose sequence splits over data run: ``tests/
    test_torch_lm_mesh_gaps.py``.)"""
    mesh = LMMesh(("data", "model"), (2, 2))
    api = build_model(ARCHS[ARCH].reduced())
    with pytest.raises(ValueError, match="does not divide"):
        steps.make_decode_step(api, LMMesh(("data", "model"), (1, 4)),
                               ShapeConfig("d", 10, 2, "decode"))
    # flash decode is not an option: it runs exactly where the cache's
    # sequence is split (2 KV heads on 4 ranks), never over a head split
    for shape, flash, spec in (
            ((1, 4), True, ((), ("data",), ("model",), (), ())),
            ((2, 2), False, ((), ("data",), (), ("model",), ()))):
        *_, meta = steps.make_decode_step(
            api, LMMesh(("data", "model"), shape),
            ShapeConfig("d", 8, 2, "decode"))
        assert meta["flash_decode"] is flash
        assert tuple(map(sh.spec_axes, meta["specs"]["cache"]["k"])) == spec
    with pytest.raises(TypeError):
        steps.make_decode_step(api, mesh, ShapeConfig("d", 8, 4, "decode"),
                               flash_decode=False)


def test_a_layout_only_mesh_holds_no_data():
    """``LMMesh(names, shape)`` has no device: placing weights, a batch or
    a cache on it raises (entry points put data on the GPU unless given
    ``device="cpu"``, through ``make_lm_mesh``/``make_host_mesh``)."""
    api = build_model(ARCHS[ARCH].reduced())
    mesh = LMMesh(("data", "model"), (1, 1))
    assert mesh.device is None
    *_, meta = steps.make_decode_step(api, mesh,
                                      ShapeConfig("d", 8, 2, "decode"))
    with pytest.raises(ValueError, match="layout-only"):
        steps.place_model(api.init(torch.Generator().manual_seed(0),
                                   device="cpu"),
                          meta["specs"]["params"], mesh)
    with pytest.raises(ValueError, match="layout-only"):
        steps.place({"t": torch.zeros(2, 1, dtype=torch.int32)},
                    {"t": meta["specs"]["tokens"]}, mesh)
    with pytest.raises(ValueError, match="layout-only"):
        steps.init_cache(api, 2, 8, meta["specs"]["cache"], mesh)


def test_mesh_hooks_change_no_value():
    """``set_mesh_axes`` / ``clear_mesh_axes`` keep JAX's module state;
    the constrain hooks return their input (a local tensor's rows already
    are this rank's) and check its dims; ``cache_offsets`` is the whole
    cache off a mesh, and on one follows the cache's specs
    (``set_cache_layout``)."""
    from repro_torch.models import layers as L
    cfg = ARCHS[ARCH].reduced()
    x = torch.randn(2, 3, 4)
    assert L.constrain_batch(x) is x and L.constrain_batch_vocab(x) is x
    assert L.cache_offsets(cfg, cfg.n_kv_heads, 16) == (0, 0, 16)
    mesh = LMMesh(("data", "model"), (1, 2), coords=(0, 1))
    L.set_mesh_axes(("data",), 1, 2, mesh=mesh, flash_decode=True)
    try:
        assert L.mesh_axes() == ((("data",), 1, 2), dict(
            seq_parallel=False, mesh=mesh, flash_decode=True))
        assert L.constrain_batch(x) is x
        with pytest.raises(ValueError, match="batch dim"):
            L.constrain_batch(torch.zeros(()))
        with pytest.raises(ValueError, match="logits"):
            L.constrain_batch_vocab(torch.zeros(3))
        L.set_cache_layout({"k": (None, "data", None, "model", None)},
                           None)
        # qwen2.5-3b's 2 KV heads on 2 ranks: this rank's head is the 2nd
        assert L.cache_offsets(cfg, 1, 16) == (0, 1, 16)
        # every head held: 2 heads divide the axis, so no flash chunks
        assert L.cache_offsets(cfg, cfg.n_kv_heads, 16) == (0, 0, 16)
        # on 4 ranks flash decode splits the sequence: rank 3's chunk
        L.set_mesh_axes(("data",), 1, 4, mesh=LMMesh(
            ("data", "model"), (1, 4), coords=(0, 3)), flash_decode=True)
        L.set_cache_layout({"k": (None, "data", "model", None, None)},
                           None)
        assert L.cache_seq_axes() == ("model",)
        assert L.cache_offsets(cfg, cfg.n_kv_heads, 8) == (24, 0, 32)
        # a batch of 1 on 4 data ranks splits the sequence over data
        L.set_mesh_axes((), 1, 1, mesh=LMMesh(
            ("data", "model"), (4, 1), coords=(2, 0)))
        L.set_cache_layout({"k": (None, None, ("data",), None, None)},
                           None)
        assert L.cache_offsets(cfg, cfg.n_kv_heads, 8) == (16, 0, 32)
    finally:
        L.clear_mesh_axes()
    assert L.mesh_axes()[0] == ((), 1, 1) and L.cache_layout() == ({}, None)
