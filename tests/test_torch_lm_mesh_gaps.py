"""The LM steps across processes where the batch, the state or the cache
is split beyond the plain layout (``repro_torch.launch.steps``,
``models.moe``, ``models.layers``, ``models.flash_decode``), on the CPU
under ``gloo``, held to the JAX package.

Four spawned ranks (``tests/torch_lm_mesh_gaps_ranks.py``, JAX-free) run
on (1, 4), (2, 2) and (4, 1) meshes of one process group, from JAX's
weights (``interop.params_from_numpy``) and numpy inputs:

  * reduced mixtral (E 4, k 2, capacity factor 1.25), its MoE groups
    spanning the ranks of the batch axes: a train step on (2, 2) and
    (4, 1) with 1 and 2 micro-batches of an 8 x 16 batch, the loss (aux
    included) within ``LOSS_RTOL`` and the gathered gradients within the
    gradient tolerance of ``jax.value_and_grad`` of JAX's ``loss_fn``
    (the mean over the reference's micro-batches of rows); on (4, 1) the
    prefill step, the prefill that fills the cache and 4 decode steps,
    whose one group of 8 tokens has capacity 5 (a rank's 2 tokens alone
    would have 1), within the decode tolerance of JAX's;
  * reduced zamba2, xlstm and whisper on (1, 4) and (2, 2) (KV caches
    split over KV heads, states over a state dim, both over ``model``):
    the prefill step against JAX's last-position logits, 4 decode steps
    against JAX's one-process decode within the decode bounds of
    ``PERF.md`` §2 (2e-3; 5e-3 for zamba2 and xlstm), and every rank's
    cache shard after them against its slice of JAX's cache;
  * zamba2 at batch 1 on (4, 1) and (2, 2), the cache's sequence split
    over the data axis (flash decode's combine over it), the same way.
"""

import multiprocessing
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.mesh import LMMesh  # noqa: E402
from torch_lm_mesh_gaps_ranks import FAM_B, FAM_LEN, FAM_PROMPT, \
    FAM_STEPS, FAMILIES, MESHES, MOE, MOE_B, MOE_PROMPT, MOE_S, \
    MOE_STEPS, MOE_TRAIN, ONE_LEN, rank_main  # noqa: E402

WORLD = 4
JOIN_S = 120                     # a rank that takes longer is hung
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_models.py's
LOSS_RTOL = 1e-4                 # tests/test_torch_train.py's
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6           # tests/test_torch_train_grads.py's
FAMILY_TOL = {"zamba2-1.2b": 5e-3, "xlstm-1.3b": 5e-3,
              "whisper-medium": 2e-3}       # PERF.md §2's decode bounds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree if isinstance(tree, int) else np.asarray(tree)


def _jax_init(name: str):
    japi = jbuild_model(JARCHS[name].reduced())
    params = jax.jit(japi.init)(jax.random.PRNGKey(0))
    model = params_from_numpy(ARCHS[name].reduced(),
                              jax.tree.map(np.asarray, params), device="cpu")
    return japi, params, {n: p.detach() for n, p in model.named_parameters()}


def _by_name(name: str, tree) -> dict:
    """A JAX tree of the parameters' shapes by the port's names."""
    model = params_from_numpy(ARCHS[name].reduced(),
                              jax.tree.map(np.asarray, tree), device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


def _moe_inputs(cfg) -> dict:
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (MOE_B, MOE_S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "prompt": rng.integers(0, cfg.vocab, (MOE_B, MOE_PROMPT),
                                   dtype=np.int32),
            "decode": rng.integers(0, cfg.vocab, (MOE_STEPS, MOE_B, 1),
                                   dtype=np.int32)}


def _family_inputs(cfg) -> dict:
    rng = np.random.default_rng(12)
    f = {"tokens": rng.integers(0, cfg.vocab, (FAM_B, FAM_PROMPT),
                                dtype=np.int32),
         "decode": rng.integers(0, cfg.vocab, (FAM_B, FAM_STEPS),
                                dtype=np.int32),
         "one": rng.integers(0, cfg.vocab, (1, FAM_STEPS), dtype=np.int32)}
    if cfg.enc_dec:
        f["frames"] = rng.standard_normal(
            (FAM_B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return f


def _save(path, name: str, state: dict, f: dict) -> None:
    torch.save({"state": state, **{k: torch.from_numpy(v)
                                   for k, v in f.items()}},
               path / f"{name}.pt")


def _jax_moe(japi, params, f) -> dict:
    """JAX's loss and gradients (by the port's names) for 1 and 2
    micro-batches of rows, its prefill logits and its decode logits."""
    jcfg = JARCHS[MOE].reduced()
    want = {}
    grad = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(japi, p, b)))
    for micro in sorted({m for _, m in MOE_TRAIN}):
        n = MOE_B // micro
        parts = [grad(params, {k: jnp.asarray(f[k][i * n:(i + 1) * n])
                               for k in ("tokens", "labels")})
                 for i in range(micro)]
        loss = float(np.mean([float(lo) for lo, _ in parts]))
        mean = jax.tree.map(lambda *g: np.asarray(sum(g) / micro),
                            *[g for _, g in parts])
        want[("train", micro)] = (loss, _by_name(MOE, mean))
    prompt = jnp.asarray(f["prompt"])
    want["prefill"] = np.asarray(japi.forward(params, {"tokens": prompt},
                                              last_only=True)[0])
    cache = japi.init_cache(params, MOE_B, MOE_PROMPT + MOE_STEPS)
    logits, cache = jtransformer.prefill(params, prompt, jcfg, cache)
    want["fill"], want["decode"] = np.asarray(logits), []
    for tok in f["decode"]:
        logits, cache = japi.decode_step(params, jnp.asarray(tok), cache)
        want["decode"].append(np.asarray(logits))
    return want


def _jax_decode(japi, params, toks, batch: int, max_len: int,
                frames=None) -> tuple:
    """JAX's one-process decode of ``toks`` (B, steps) from an empty cache
    (or the encoded ``frames``'): its logits and its cache after."""
    cache = japi.init_cache(params, batch, max_len)
    if frames is not None:
        cache = japi.prefill(params, {"frames": jnp.asarray(frames)}, cache)
    logits = []
    for i in range(toks.shape[1]):
        lg, cache = japi.decode_step(params, jnp.asarray(toks[:, i:i + 1]),
                                     cache)
        logits.append(np.asarray(lg))
    return logits, _to_numpy(cache)


def _jax_family(name: str, japi, params, f) -> dict:
    batch = {k: jnp.asarray(f[k]) for k in ("tokens", "frames") if k in f}
    want = {"prefill": np.asarray(japi.forward(params, batch,
                                               last_only=True)[0])}
    want["decode"] = _jax_decode(japi, params, f["decode"], FAM_B, FAM_LEN,
                                 f.get("frames"))
    if name == "zamba2-1.2b":
        want["one"] = _jax_decode(japi, params, f["one"], 1, ONE_LEN)
    return want


@pytest.fixture(scope="module")
def setup(tmp_path_factory, request):
    """JAX's weights and inputs written for the ranks, the ranks started,
    then JAX's answers computed while they run."""
    path = tmp_path_factory.mktemp("lm_mesh_gaps")
    jax_side = {}
    for name in (MOE,) + FAMILIES:
        japi, params, state = _jax_init(name)
        cfg = ARCHS[name].reduced()
        f = _moe_inputs(cfg) if name == MOE else _family_inputs(cfg)
        _save(path, name, state, f)
        jax_side[name] = (japi, params, f)
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
    want = {MOE: _jax_moe(*jax_side[MOE])}
    for name in FAMILIES:
        want[name] = _jax_family(name, *jax_side[name])
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


def _rows(rank: dict, mesh: str, batch: int) -> slice:
    """This rank's rows of ``batch`` on ``mesh`` (split over data)."""
    n = MESHES[mesh][0]
    if batch % n:
        return slice(None)
    d = rank["coords"][mesh][0]
    return slice(d * batch // n, (d + 1) * batch // n)


def _named_axes(specs: dict) -> set:
    """Every mesh axis a tree of specs names."""
    return {a for v in specs.values()
            for a in (_named_axes(v) if isinstance(v, dict) else
                      {x for e in v for x in sh.spec_axes(e)})}


def _cache_close(got: dict, want: dict, specs: dict, coords, mesh: str,
                 tol: float, path: str = "") -> None:
    """Each leaf of a rank's cache shard against its slice of JAX's
    whole cache under the leaf's spec."""
    layout = LMMesh(("data", "model"), MESHES[mesh], coords)
    for key, g in got.items():
        if isinstance(g, dict):
            _cache_close(g, want[key], specs[key], coords, mesh, tol,
                         f"{path}{key}.")
        elif isinstance(g, torch.Tensor):
            w = sh.shard_of(torch.tensor(want[key]), specs[key], layout)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol,
                                       atol=tol, err_msg=path + key)
        else:
            assert g == int(want[key]), path + key


@pytest.mark.parametrize("mesh,micro", MOE_TRAIN)
def test_moe_train_step_routes_over_the_whole_batch(setup, ranks, mesh,
                                                    micro):
    """The loss (aux included) and the gathered gradients against
    ``jax.value_and_grad`` of JAX's ``loss_fn`` over the reference's
    micro-batches, on every rank."""
    loss, grads = setup[0][MOE][("train", micro)]
    for rank in ranks:
        got = rank["moe_train"][(mesh, micro)]
        assert got["num_micro"] == micro and got["opt_step"] == 1
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
        for name, w in grads.items():
            w = w.numpy()
            np.testing.assert_allclose(
                got["grads"][name].numpy(), w, rtol=0,
                atol=GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL,
                err_msg=name)


def test_moe_prefill_and_decode_route_over_the_whole_batch(setup, ranks):
    """(4, 1): the prefill step, the cache-filling prefill and 4 decode
    steps, each rank's rows against JAX's."""
    want = setup[0][MOE]
    for rank in ranks:
        got, rows = rank["moe_serve"], _rows(rank, "41", MOE_B)
        np.testing.assert_allclose(got["prefill"].numpy(),
                                   want["prefill"][rows], **DECODE_TOL)
        np.testing.assert_allclose(got["fill"].numpy(), want["fill"][rows],
                                   **DECODE_TOL)
        for g, w in zip(got["decode"], want["decode"]):
            np.testing.assert_allclose(g.numpy(), w[rows], **DECODE_TOL)


@pytest.mark.parametrize("mesh", ["14", "22"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_prefill_and_decode_on_a_model_axis(setup, ranks, name, mesh):
    """The prefill step's last-position logits, 4 decode steps' logits and
    the cache shard after them, each rank against JAX's."""
    want, tol = setup[0][name], FAMILY_TOL[name]
    logits, cache = want["decode"]
    for rank in ranks:
        got, rows = rank[name][mesh], _rows(rank, mesh, FAM_B)
        np.testing.assert_allclose(got["prefill"].numpy(),
                                   want["prefill"][rows], rtol=tol, atol=tol)
        for g, w in zip(got["decode"], logits):
            np.testing.assert_allclose(g.numpy(), w[rows], rtol=tol,
                                       atol=tol)
        _cache_close(got["cache"], cache, got["specs"],
                     rank["coords"][mesh], mesh, tol)
        assert "model" in _named_axes(got["specs"])


@pytest.mark.parametrize("mesh", ["41", "22"])
def test_zamba2_batch_one_decode_over_a_data_split_sequence(setup, ranks,
                                                            mesh):
    """zamba2 at batch 1: the attention cache's 8 positions split over
    the data axis, 4 decode steps (so some chunks hold no valid position)
    and the cache shard against JAX's."""
    logits, cache = setup[0]["zamba2-1.2b"]["one"]
    for rank in ranks:
        got = rank["zamba_one"][mesh]
        assert sh.spec_axes(got["specs"]["attn_k"][2]) == ("data",)
        tol = FAMILY_TOL["zamba2-1.2b"]
        for g, w in zip(got["decode"], logits):
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)
        _cache_close(got["cache"], cache, got["specs"],
                     rank["coords"][mesh], mesh, tol)
