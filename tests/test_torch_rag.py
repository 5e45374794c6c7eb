"""The port's decode ``Engine`` and ``rag_answer`` against the JAX
package's.

``tests/test_serving.py``'s ``TestEngine`` and RAG round trip hold in the
port; then one reduced qwen2.5 model (JAX's ``api.init(PRNGKey(0))``
with drawn norms and biases, carried by ``interop.params_from_numpy``)
and one JAX-built index
(``interop.index_from_numpy``) run ``rag_answer`` in both packages with an
``embed_fn`` that returns the same numpy-seeded vectors, so the retrieval
input is bit-equal: in each of its forms (a default ``Retriever`` with
and without ``plan=``, a caller's ``retriever=``, a ``ServingEngine``
with a throttled tenant) the ids, the ledger, ``degraded`` and the engine
stats must equal JAX's, and the tokens JAX's at every step up to one
where JAX's top-2 logit margin is at most 1e-3 (a near-tie that float32
rounding may flip).  The JAX side runs its ``reference`` backend."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.anns.api import QueryPlan as JPlan  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Retriever as JRetriever  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import TenantQoS as JTenantQoS  # noqa: E402
from repro.serving import rag_answer as jrag_answer  # noqa: E402
from repro_torch.anns import PipelineConfig, build  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.index import ivf as pivf  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.quant.kmeans import random_init  # noqa: E402
from repro_torch.serving import (Engine, QueryPlan, RagResult,  # noqa: E402
                                 Retriever, ServeStats, ServingEngine,
                                 TenantQoS, rag_answer)
from repro_torch.serving import engine as engine_shim  # noqa: E402
from test_torch_models import _drawn_affine  # noqa: E402
from test_torch_pipeline import export_jax_index  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# tests/test_serving.py's RAG index, at the reduced model's width
CFG = dict(dim=128, pq_m=16, pq_k=32, nlist=16, nprobe=4, final_k=5,
           refine_budget=20)
B, PROMPT, STEPS, K, MAX_LEN = 4, 8, 6, 5, 32
MARGIN = 1e-3


@pytest.fixture(scope="module")
def lm():
    """A reduced qwen2.5 with random weights, port only."""
    cfg = ARCHS["qwen2.5-3b"].reduced()
    api = build_model(cfg)
    return cfg, api, api.init(torch.Generator().manual_seed(0))


# ------------------------------------------------------------- TestEngine


class TestEngine:
    def test_batched_decode_shapes(self, lm):
        cfg, api, model = lm
        eng = Engine(api, model, batch=3, max_len=32)
        out = eng.decode(torch.zeros((3, 1), dtype=torch.int32), steps=5)
        assert out.shape == (3, 5) and out.dtype == torch.int32
        assert eng.stats.tokens == 15 and eng.stats.steps == 5
        assert eng.cache["len"] == 5

    def test_greedy_deterministic(self, lm):
        cfg, api, model = lm
        e1 = Engine(api, model, batch=2, max_len=32)
        e2 = Engine(api, model, batch=2, max_len=32)
        seed = torch.ones((2, 1), dtype=torch.int32)
        assert torch.equal(e1.decode(seed, 6), e2.decode(seed, 6))

    def test_decode_is_greedy_argmax(self, lm):
        """Each token is the first index of its step's largest logit."""
        cfg, api, model = lm
        eng = Engine(api, model, batch=2, max_len=32)
        seed = torch.tensor([[3], [7]], dtype=torch.int32)
        out = eng.decode(seed, 4)
        cache, cur = api.init_cache(model, 2, 32), seed
        for t in range(4):
            logits, cache = api.decode_step(model, cur, cache)
            cur = logits.argmax(-1, keepdim=True).int()
            assert torch.equal(out[:, t], cur[:, 0])

    def test_prefill_then_decode(self, lm):
        cfg, api, model = lm
        eng = Engine(api, model, batch=2, max_len=32)
        eng.prefill({"tokens": torch.arange(10).reshape(2, 5)})
        assert eng.cache["len"] == 5
        eng.decode(torch.zeros((2, 1), dtype=torch.int32), 3)
        assert eng.cache["len"] == 8

    def test_engine_shim_reexports(self):
        assert engine_shim.Engine is Engine
        assert engine_shim.rag_answer is rag_answer
        assert engine_shim.ServeStats is ServeStats
        assert engine_shim.RagResult is RagResult
        assert engine_shim.Retriever is Retriever


class TestRAG:
    def test_round_trip(self, lm):
        """``tests/test_serving.py::TestRAG::test_round_trip`` on the port."""
        cfg, api, model = lm
        d = cfg.d_model
        ds = make_dataset(n=3000, d=d, n_queries=2,
                          generator=torch.Generator().manual_seed(1))
        index = build(ds.x, PipelineConfig(**CFG), device="cpu",
                      generator=torch.Generator().manual_seed(2))
        eng = Engine(api, model, batch=2, max_len=32)

        def embed_fn(tokens):
            e = model.embed_tokens(tokens).mean(dim=1)
            return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

        prompts = torch.randint(0, cfg.vocab, (2, 4),
                                generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            res = rag_answer(eng, index, embed_fn, prompts, k=5,
                             decode_steps=4)
        assert res.tokens.shape == (2, 4) and res.ids.shape == (2, 5)
        assert res.cost.total_seconds() > 0
        assert res.degraded is False
        assert eng.stats.retrievals == 2


# ------------------------------------------------------ parity with JAX


@pytest.fixture(scope="module")
def pair():
    """One reduced qwen2.5 and one JAX-built index in both packages, the
    prompts, the embeddings, and JAX's greedy tokens with each step's
    top-2 logit margin."""
    jcfg = JARCHS["qwen2.5-3b"].reduced()
    japi = jbuild_model(jcfg)
    tree = _drawn_affine(jax.tree.map(np.asarray,
                                      japi.init(jax.random.PRNGKey(0))), 2)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = ARCHS["qwen2.5-3b"].reduced()
    model = params_from_numpy(cfg, tree, device="cpu")
    ds = jmake_dataset(jax.random.PRNGKey(1), n=3000, d=cfg.d_model,
                       n_queries=2)
    jidx = jbuild(jax.random.PRNGKey(2), ds.x, JConfig(**CFG))
    pidx = index_from_numpy(export_jax_index(jidx), PipelineConfig(**CFG),
                            device="cpu")
    rng = np.random.default_rng(5)
    x = np.asarray(ds.x)
    vecs = x[rng.integers(0, x.shape[0], B)] \
        + 0.05 * rng.standard_normal((B, cfg.d_model))
    vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)) \
        .astype(np.float32)
    prompts = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    # JAX's greedy decode from the round trip's seed, with its margins
    cache = japi.init_cache(jparams, B, MAX_LEN)
    cur = jnp.asarray(prompts[:, -1:])
    toks, margins = [], []
    for _ in range(STEPS):
        logits, cache = japi.decode_step(jparams, cur, cache)
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(cur[:, 0]))
    return dict(cfg=cfg, japi=japi, jparams=jparams, api=build_model(cfg),
                model=model, jidx=jidx, pidx=pidx, vecs=vecs,
                prompts=prompts, jtokens=np.stack(toks, 1),
                margins=np.stack(margins, 1))


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _same_tokens(got: np.ndarray, want: np.ndarray, margins: np.ndarray):
    """Equal at every step up to a step where JAX's margin is at most
    ``MARGIN``; past a differing token the rows' inputs differ."""
    for row in range(want.shape[0]):
        for t in range(want.shape[1]):
            if got[row, t] != want[row, t]:
                assert margins[row, t] <= MARGIN, (row, t, margins[row, t])
                break


def _forms(p):
    """form → (port kwargs, JAX kwargs) for ``rag_answer``."""
    return {
        "default": ({}, {}),
        "plan": ({"plan": QueryPlan(refine_budget=10)},
                 {"plan": JPlan(backend="reference", refine_budget=10)}),
        "retriever": (
            {"retriever": Retriever(index=p["pidx"], micro_batch=2)},
            {"retriever": JRetriever(index=p["jidx"], micro_batch=2)}),
        "serving": (
            {"serving": ServingEngine(
                p["pidx"], max_batch=2,
                qos={"default": TenantQoS(rate_rps=1000.0, burst=2)})},
            {"serving": JServingEngine(
                p["jidx"], plan=JPlan(backend="reference"), max_batch=2,
                qos={"default": JTenantQoS(rate_rps=1000.0, burst=2)})}),
    }


@pytest.mark.parametrize("form", ["default", "plan", "retriever",
                                  "serving"])
def test_rag_answer_matches_jax(pair, form):
    p = pair
    kw, jkw = _forms(p)[form]
    eng = Engine(p["api"], p["model"], batch=B, max_len=MAX_LEN)
    jeng = JEngine(p["japi"], p["jparams"], batch=B, max_len=MAX_LEN)
    vecs = p["vecs"]
    res = rag_answer(eng, p["pidx"], lambda t: torch.from_numpy(vecs),
                     torch.from_numpy(p["prompts"]), k=K, decode_steps=STEPS,
                     **kw)
    jres = jrag_answer(jeng, p["jidx"], lambda t: jnp.asarray(vecs),
                       jnp.asarray(p["prompts"]), k=K, decode_steps=STEPS,
                       **jkw)
    np.testing.assert_array_equal(np.asarray(res.ids), np.asarray(jres.ids))
    assert _ledger(res.cost) == _ledger(jres.cost)
    assert res.cost.total_seconds() == pytest.approx(
        jres.cost.total_seconds(), rel=1e-12)
    assert res.degraded is jres.degraded
    assert res.degraded is (form == "serving")      # burst 2 of 4 requests
    assert vars(eng.stats) == vars(jeng.stats)
    np.testing.assert_array_equal(np.asarray(jres.tokens), p["jtokens"])
    _same_tokens(res.tokens.numpy(), p["jtokens"], p["margins"])
    assert res.tokens.shape == (B, STEPS) and res.ids.shape == (B, K)


def test_rag_tokens_match_jax_at_clear_margins(pair):
    """The round trip's port tokens equal JAX's at every step whose margin
    is clear (the sanity of the comparison above: most steps count)."""
    p = pair
    eng = Engine(p["api"], p["model"], batch=B, max_len=MAX_LEN)
    res = rag_answer(eng, p["pidx"], lambda t: torch.from_numpy(p["vecs"]),
                     torch.from_numpy(p["prompts"]), k=K, decode_steps=STEPS)
    clear = p["margins"] > MARGIN
    assert clear.mean() > 0.5
    _same_tokens(res.tokens.numpy(), p["jtokens"], p["margins"])


@pytest.mark.parametrize("kw", ["serving+retriever", "serving+plan",
                                "plan+retriever"])
def test_rag_answer_exclusive_arguments(pair, kw):
    p = pair
    eng = Engine(p["api"], p["model"], batch=B, max_len=MAX_LEN)
    args = {"serving": ServingEngine(p["pidx"]),
            "retriever": Retriever(index=p["pidx"]),
            "plan": QueryPlan()}
    given = {name: args[name] for name in kw.split("+")}
    with pytest.raises(ValueError, match="alone" if "serving" in given
                       else "not both"):
        rag_answer(eng, p["pidx"], lambda t: torch.from_numpy(p["vecs"]),
                   torch.from_numpy(p["prompts"]), **given)
    assert eng.stats.retrievals == 0


def test_launch_serve_cpu():
    """``python -m repro_torch.launch.serve --device cpu --steps 2 --rag``
    runs in a subprocess and exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--steps", "2", "--rag"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "decoded 4×2 tokens" in out.stdout
    assert "RAG: retrieved 5 docs/request" in out.stdout


def _probe_coverage(x, queries, gt, centroids, nprobe: int):
    """Share of the exact top-10 (all of it, and its first row) in the
    ``nprobe`` lists nearest each query: what an exact rerank of every
    probed candidate (baseline mode) can reach."""
    x, queries, gt, c = (np.asarray(a) for a in (x, queries, gt, centroids))
    sq = (c * c).sum(1)
    lists = (sq - 2 * x @ c.T).argmin(1)[gt[:, :10]]
    probed = np.argsort(sq - 2 * queries @ c.T, 1)[:, :nprobe]
    hit = (lists[..., None] == probed[:, None, :]).any(-1)
    return float(hit.mean()), float(hit[:, 0].mean())


def test_wide_synthetic_rows_as_diffuse_as_jax():
    """At the LM's width (d = 2048) ``make_dataset``'s rows are diffuse:
    a query's true neighbours after the first lie in many IVF lists.  The
    chip's RAG index holds fatrq to baseline's recall for that reason, so
    JAX's generator must be as diffuse as the port's: at 20,000 rows,
    64 lists and 1 probed (the chip's 16 of 1024), the probed lists hold
    a share of the exact top-10 under 0.5 and within 0.05 of each other
    in the two packages (which draw different bits), and 95 % of the
    queries' first neighbours (a guard against gross failure only: each
    query is a noisy copy of a row)."""
    n, d, nq, nlist = 20_000, 2048, 128, 64
    jds = jmake_dataset(jax.random.PRNGKey(0), n=n, d=d, n_queries=nq,
                        k_gt=10)
    jcov = _probe_coverage(jds.x, jds.queries, jds.gt, jivf.build(
        jax.random.PRNGKey(1), jds.x, nlist).centroids, 1)
    gen = torch.Generator().manual_seed(0)
    pds = make_dataset(n=n, d=d, n_queries=nq, k_gt=10, generator=gen)
    pcov = _probe_coverage(pds.x, pds.queries, pds.gt, pivf.build(
        pds.x, nlist, init_idx=random_init(n, nlist, gen)).centroids, 1)
    assert jcov[0] < 0.5 and pcov[0] < 0.5
    print(f"probed-list share of the exact top-10 (and of the first): "
          f"JAX {jcov}, port {pcov}")
    assert abs(jcov[0] - pcov[0]) < 0.05, (jcov, pcov)
    assert jcov[1] >= 0.95 and pcov[1] >= 0.95

