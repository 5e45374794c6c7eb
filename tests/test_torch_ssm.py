"""The port's SSM families (``repro_torch.models.mamba2``, ``xlstm``,
``ssm_lm``) against the JAX package's, on the reduced zamba2 and xlstm
configurations.

JAX's weights come from its jitted ``api.init(PRNGKey(0))`` with every
norm scale and gate (``ln``, ``out_norm``, ``gate_norm``, ``A_log``,
``dt_bias``, ``D``, ...) drawn from a numpy seed, so that a swapped or
dropped leaf shows, and reach the port through
``interop.params_from_numpy``; inputs are numpy-seeded.  Logits, block
outputs and every cache entry must agree within rtol = atol = 1e-4; the
port's decode must match its own forward within the JAX package's bound
for that check (5e-3, ``tests/test_models.py``).  The blocks run with a
``chunk`` smaller than T, so that the chunks' carry is exercised.  Each
family's JAX work is done once, in the module-scoped ``family``
fixture."""

import dataclasses
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
from repro.anns.pipeline import FaTRQIndex as JIndex  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core.calibration import (  # noqa: E402
    CalibrationModel as JCalibrationModel)
from repro.core.decomposition import (  # noqa: E402
    RecordScalars as JRecordScalars)
from repro.core.trq import TRQCodes as JTRQCodes  # noqa: E402
from repro.core.trq import TRQLevel as JTRQLevel  # noqa: E402
from repro.index.ivf import IVFIndex as JIVFIndex  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import ssm_lm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.quant.pq import PQCodebook as JPQCodebook  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import rag_answer as jrag_answer  # noqa: E402
from repro_torch.anns import PipelineConfig, build  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import ModelApi, build_model  # noqa: E402
from repro_torch.models import mamba2, ssm_lm, whisper, xlstm  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serving import Engine, rag_answer  # noqa: E402
from test_torch_rag import _same_tokens  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
SSM_DECODE_TOL = 5e-3          # decode ≡ forward, tests/test_models.py's
B, S, MAX_LEN = 2, 16, 32
CHUNKS = (4, 8, 16)            # 4, 2 and 1 chunks of the 16 positions
SSMS = ("zamba2-1.2b", "xlstm-1.3b")

# leaves drawn around 1 (scales) or 0 (biases) in place of the init's
# constants
_SCALES = {"ln", "ln1", "ln2", "lnx", "final_norm", "enc_norm", "gate_norm",
           "out_norm", "D", "A_log"}
_BIASES = {"dt_bias"}


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def drawn(tree: dict, seed: int) -> dict:
    """``tree`` with its norm scales and gates drawn from ``seed``
    (centre ± 0.2): the init makes them constants, under which a swapped
    leaf would pass unseen."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for name, v in sorted(t.items()):
            if isinstance(v, dict):
                out[name] = walk(v)
            elif name in _SCALES or name in _BIASES:
                centre = 1.0 if name in _SCALES else 0.0
                out[name] = (centre + 0.2 * rng.standard_normal(v.shape)) \
                    .astype(v.dtype)
            else:
                out[name] = v
        return out
    return walk(tree)


def jax_pair(name: str):
    """(JAX api, JAX params, numpy tree, port cfg, port api, port model)
    of the reduced ``name``, one drawn tree in both packages."""
    japi = jbuild_model(JARCHS[name].reduced())
    tree = drawn(jax.tree.map(np.asarray,
                              jax.jit(japi.init)(jax.random.PRNGKey(0))), 2)
    cfg = ARCHS[name].reduced()
    return (japi, jax.tree.map(jnp.asarray, tree), tree, cfg,
            build_model(cfg), params_from_numpy(cfg, tree, device="cpu"))


def tokens(cfg, seed: int, shape=(B, S)) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def to_numpy(cache):
    """A cache (JAX's or the port's) as numpy, ``len`` as an int."""
    if isinstance(cache, dict):
        return {k: to_numpy(v) for k, v in cache.items()}
    if isinstance(cache, int):
        return cache
    return np.array(cache)


def close_cache(got: dict, want: dict, path: str = "") -> None:
    """Every entry of the port's cache against JAX's: the same keys,
    ``len`` equal, the tensors within tolerance."""
    assert sorted(got) == sorted(want), path
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            close_cache(g, w, f"{path}{key}.")
        elif key == "len":
            assert int(g) == int(w), path + key
        else:
            assert np.shape(g) == np.shape(w), path + key
            close(g, w, err_msg=path + key, **TOL)


def jax_greedy(japi, jparams, seed: np.ndarray, steps: int, *,
               prefill: dict | None = None):
    """JAX's greedy tokens from ``seed`` (B, 1) and each step's top-2
    logit margin."""
    cache = japi.init_cache(jparams, seed.shape[0], MAX_LEN)
    if prefill is not None:
        cache = japi.prefill(jparams, prefill, cache)
    cur, toks, margins = jnp.asarray(seed), [], []
    for _ in range(steps):
        logits, cache = japi.decode_step(jparams, cur, cache)
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(cur[:, 0]))
    return np.stack(toks, 1), np.stack(margins, 1)


# the RAG index: small, since the retrieval's inputs are given vectors
RAG_CFG = dict(dim=32, pq_m=8, pq_k=16, nlist=8, nprobe=4, final_k=5,
               refine_budget=20)


def jax_index(idx):
    """The JAX package's ``FaTRQIndex`` holding the port's index's arrays
    (the reverse of ``interop.index_from_numpy``; a JAX build would spend
    most of this file's time compiling)."""
    a = lambda t: jnp.asarray(t.cpu().numpy())  # noqa: E731
    trq = idx.trq
    return JIndex(
        config=JConfig(**{k: v for k, v in dataclasses.asdict(
            idx.config).items() if k != "backend"}),
        codebook=JPQCodebook(a(idx.codebook.codebooks)),
        pq_codes=a(idx.pq_codes),
        ivf=JIVFIndex(a(idx.ivf.centroids), a(idx.ivf.lists),
                      a(idx.ivf.list_len)),
        trq=JTRQCodes(
            dim=trq.dim,
            levels=tuple(JTRQLevel(a(lv.packed), a(lv.proj), a(lv.norm),
                                   a(lv.rho)) for lv in trq.levels),
            scalars=JRecordScalars(*(a(getattr(trq.scalars, f)) for f in (
                "delta_sq", "cross", "rho", "norm"))),
            model=JCalibrationModel(*(a(getattr(trq.model, f))
                                      for f in ("w", "bias", "resid_std")))),
        x=a(idx.x))


def rag_index(n_req: int):
    """One index in both packages (built by the port, its arrays given to
    JAX) and ``n_req`` unit query vectors near its rows."""
    ds = make_dataset(n=1000, d=RAG_CFG["dim"], n_queries=2,
                      generator=torch.Generator().manual_seed(1))
    pidx = build(ds.x, PipelineConfig(**RAG_CFG), device="cpu",
                 generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(5)
    x = ds.x.numpy()
    vecs = x[rng.integers(0, x.shape[0], n_req)] \
        + 0.05 * rng.standard_normal((n_req, x.shape[1]))
    return jax_index(pidx), pidx, (
        vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(np.float32)


def rag_against_jax(p, *, prefill=None, steps: int = 6, k: int = 5):
    """``rag_answer`` in both packages over one index (after ``prefill``
    where given): ids, ledger and stats equal, tokens JAX's up to a near
    tie."""
    jidx, pidx, vecs = rag_index(B)
    prompts = tokens(p["cfg"], 7, (B, 8))
    eng = Engine(p["api"], p["model"], batch=B, max_len=MAX_LEN)
    jeng = JEngine(p["japi"], p["jparams"], batch=B, max_len=MAX_LEN)
    if prefill is not None:
        eng.prefill({k_: torch.from_numpy(v) for k_, v in prefill.items()})
        jeng.prefill({k_: jnp.asarray(v) for k_, v in prefill.items()})
    res = rag_answer(eng, pidx, lambda t: torch.from_numpy(vecs),
                     torch.from_numpy(prompts), k=k, decode_steps=steps)
    jres = jrag_answer(jeng, jidx, lambda t: jnp.asarray(vecs),
                       jnp.asarray(prompts), k=k, decode_steps=steps)
    np.testing.assert_array_equal(np.asarray(res.ids), np.asarray(jres.ids))
    assert {n: (t.accesses, t.bytes) for n, t in res.cost.ledger.items()} \
        == {n: (t.accesses, t.bytes) for n, t in jres.cost.ledger.items()}
    assert vars(eng.stats) == vars(jeng.stats)
    jtoks, margins = jax_greedy(
        p["japi"], p["jparams"], prompts[:, -1:], steps,
        prefill=None if prefill is None else
        {k_: jnp.asarray(v) for k_, v in prefill.items()})
    np.testing.assert_array_equal(np.asarray(jres.tokens), jtoks)
    _same_tokens(res.tokens.numpy(), jtoks, margins)
    assert res.tokens.shape == (B, steps)


@pytest.fixture(scope="module")
def family():
    """name → dict of the pair (``jax_pair``), teacher-forced tokens
    (B, S), JAX's forward logits and, after each of S decode steps on
    those tokens, JAX's logits and cache; built on first use."""
    done = {}

    def get(name):
        if name not in done:
            japi, jparams, tree, cfg, api, model = jax_pair(name)
            toks = tokens(cfg, 1)
            jlogits = np.asarray(japi.forward(
                jparams, {"tokens": jnp.asarray(toks)})[0])
            jcache = japi.init_cache(jparams, B, MAX_LEN)
            steps = []
            for t in range(S):
                lg, jcache = japi.decode_step(
                    jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
                steps.append((np.asarray(lg), to_numpy(jcache)))
            done[name] = dict(japi=japi, jparams=jparams, tree=tree,
                              cfg=cfg, api=api, model=model, toks=toks,
                              jlogits=jlogits, jsteps=steps)
        return done[name]
    return get


def _inputs(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _zamba_block(p):
    """Layer (0, 0)'s Mamba block in both packages."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[0, 0]),
                      p["tree"]["groups"]["mamba"])
    return jp, p["model"].groups[0][0].mamba


def _xlstm_blocks(p):
    jm = jax.tree.map(lambda a: jnp.asarray(a[0, 0]),
                      p["tree"]["mlstm_blocks"]["mlstm"])
    js = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      p["tree"]["slstm_blocks"]["slstm"])
    return (jm, p["model"].mlstm_blocks[0][0].mlstm,
            js, p["model"].slstm_blocks[0].slstm)


# ----------------------------------------------------------------- blocks


def test_softplus_and_log_sigmoid_match_jax():
    """``F.softplus`` (linear above 20) and ``F.logsigmoid`` against
    ``jax.nn.softplus`` (``logaddexp(x, 0)``) and ``log_sigmoid`` over
    [-40, 40] in float32."""
    x = np.linspace(-40, 40, 4001, dtype=np.float32)
    t = torch.from_numpy(x)
    close(torch.nn.functional.softplus(t), jax.nn.softplus(jnp.asarray(x)),
          rtol=1e-6, atol=2e-9)
    close(torch.nn.functional.logsigmoid(t),
          jax.nn.log_sigmoid(jnp.asarray(x)), rtol=1e-6, atol=1e-7)


def test_causal_conv_matches_jax(family):
    p = family("zamba2-1.2b")
    jp, blk = _zamba_block(p)
    u = np.random.default_rng(3).standard_normal(
        (B, S, blk.conv.shape[1])).astype(np.float32)
    with torch.no_grad():
        got = mamba2._causal_conv(torch.from_numpy(u), blk.conv)
    close(got, jmamba._causal_conv(jnp.asarray(u), jp["conv"]))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mamba_forward_matches_jax(family, chunk):
    p = family("zamba2-1.2b")
    jp, blk = _zamba_block(p)
    x = _inputs(p["cfg"], 4)
    with torch.no_grad():
        got = mamba2.mamba_forward(torch.from_numpy(x), blk, p["cfg"],
                                   chunk=chunk)
    close(got, jmamba.mamba_forward(jnp.asarray(x), jp, p["cfg"],
                                    chunk=chunk))


def test_mamba_chunk_must_divide(family):
    p = family("zamba2-1.2b")
    with pytest.raises(ValueError, match="divide"):
        mamba2.mamba_forward(torch.zeros((1, 12, p["cfg"].d_model)),
                             _zamba_block(p)[1], p["cfg"], chunk=8)


def test_mamba_steps_match_jax(family):
    """8 steps; the output and both states after each."""
    p = family("zamba2-1.2b")
    jp, blk = _zamba_block(p)
    cfg, x = p["cfg"], _inputs(p["cfg"], 5)
    jst = jmamba.mamba_init_state(cfg, B)
    st = mamba2.mamba_init_state(cfg, B)
    for t in range(8):
        jy, jst = jmamba.mamba_step(jnp.asarray(x[:, t:t + 1]), jst, jp, cfg)
        with torch.no_grad():
            y, st = mamba2.mamba_step(torch.from_numpy(x[:, t:t + 1]), st,
                                      blk, cfg)
        close(y, jy)
        close_cache(to_numpy(st), to_numpy(jst))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mlstm_forward_matches_jax(family, chunk):
    p = family("xlstm-1.3b")
    jm, blk = _xlstm_blocks(p)[:2]
    x = _inputs(p["cfg"], 6)
    with torch.no_grad():
        got = xlstm.mlstm_forward(torch.from_numpy(x), blk, p["cfg"],
                                  chunk=chunk)
    close(got, jxlstm.mlstm_forward(jnp.asarray(x), jm, p["cfg"],
                                    chunk=chunk))


def test_mlstm_steps_match_jax(family):
    p = family("xlstm-1.3b")
    jm, blk = _xlstm_blocks(p)[:2]
    cfg, x = p["cfg"], _inputs(p["cfg"], 7)
    jst = jxlstm.mlstm_init_state(cfg, B)
    st = xlstm.mlstm_init_state(cfg, B)
    for t in range(8):
        jy, jst = jxlstm.mlstm_step(jnp.asarray(x[:, t:t + 1]), jst, jm, cfg)
        with torch.no_grad():
            y, st = xlstm.mlstm_step(torch.from_numpy(x[:, t:t + 1]), st,
                                     blk, cfg)
        close(y, jy)
        close_cache(to_numpy(st), to_numpy(jst))


def test_slstm_forward_matches_jax(family):
    p = family("xlstm-1.3b")
    js, blk = _xlstm_blocks(p)[2:]
    x = _inputs(p["cfg"], 8)
    with torch.no_grad():
        got = xlstm.slstm_forward(torch.from_numpy(x), blk, p["cfg"])
    close(got, jxlstm.slstm_forward(jnp.asarray(x), js, p["cfg"]))


def test_slstm_steps_match_jax(family):
    p = family("xlstm-1.3b")
    js, blk = _xlstm_blocks(p)[2:]
    cfg, x = p["cfg"], _inputs(p["cfg"], 9)
    jst = jxlstm.slstm_init_state(cfg, B)
    st = xlstm.slstm_init_state(cfg, B)
    for t in range(8):
        jy, jst = jxlstm.slstm_step(jnp.asarray(x[:, t:t + 1]), jst, js, cfg)
        with torch.no_grad():
            y, st = xlstm.slstm_step(torch.from_numpy(x[:, t:t + 1]), st,
                                     blk, cfg)
        close(y, jy)
        close_cache(to_numpy(st), to_numpy(jst))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_block_forward_equals_its_steps(family, kind):
    """The port's chunked (or looped) forward of one block against its
    own recurrent steps, at 4 chunks."""
    p = family("zamba2-1.2b" if kind == "mamba" else "xlstm-1.3b")
    cfg, x = p["cfg"], torch.from_numpy(_inputs(p["cfg"], 10))
    if kind == "mamba":
        blk = _zamba_block(p)[1]
        fwd = lambda: mamba2.mamba_forward(x, blk, cfg, chunk=4)  # noqa
        st, step = mamba2.mamba_init_state(cfg, B), mamba2.mamba_step
    elif kind == "mlstm":
        blk = _xlstm_blocks(p)[1]
        fwd = lambda: xlstm.mlstm_forward(x, blk, cfg, chunk=4)  # noqa
        st, step = xlstm.mlstm_init_state(cfg, B), xlstm.mlstm_step
    else:
        blk = _xlstm_blocks(p)[3]
        fwd = lambda: xlstm.slstm_forward(x, blk, cfg)  # noqa
        st, step = xlstm.slstm_init_state(cfg, B), xlstm.slstm_step
    with torch.no_grad():
        full = fwd()
        outs = [step(x[:, t:t + 1], st, blk, cfg)[0] for t in range(S)]
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("name", SSMS)
def test_groups_match_jax(name):
    for cfg, jcfg in ((ARCHS[name], JARCHS[name]),
                      (ARCHS[name].reduced(), JARCHS[name].reduced())):
        if cfg.family == "ssm":
            assert ssm_lm.xlstm_groups(cfg) == jssm.xlstm_groups(jcfg)
        else:
            assert ssm_lm.zamba_groups(cfg) == jssm.zamba_groups(jcfg)
    assert ssm_lm.zamba_groups(ARCHS["zamba2-1.2b"]) == (6, 6, 2)
    assert ssm_lm.xlstm_groups(ARCHS["xlstm-1.3b"]) == (6, 7)


@pytest.mark.parametrize("name", SSMS)
@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(family, name, last_only):
    p = family(name)
    with torch.no_grad():
        logits, aux = p["api"].forward(
            p["model"], {"tokens": torch.from_numpy(p["toks"])},
            last_only=last_only, remat=False)
    want = p["jlogits"][:, -1:] if last_only else p["jlogits"]
    assert logits.shape == want.shape
    close(logits, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", SSMS)
def test_decode_steps_match_jax(family, name):
    """S teacher-forced decode steps: the logits and every cache entry
    after each step."""
    p = family(name)
    cache = p["api"].init_cache(p["model"], B, MAX_LEN)
    assert p["api"].prefill is None
    for t, (jlogits, jcache) in enumerate(p["jsteps"]):
        logits, cache = p["api"].decode_step(
            p["model"], torch.from_numpy(p["toks"][:, t:t + 1]), cache)
        close(logits, jlogits)
        close_cache(to_numpy(cache), jcache)
        assert cache["len"] == t + 1


@pytest.mark.parametrize("name", SSMS)
def test_decode_matches_forward(family, name):
    """The port's recurrent decode equals its own chunked forward within
    the reference's 5e-3."""
    p = family(name)
    toks = torch.from_numpy(p["toks"])
    with torch.no_grad():
        full, _ = p["api"].forward(p["model"], {"tokens": toks})
    cache = p["api"].init_cache(p["model"], B, MAX_LEN)
    outs = []
    for t in range(S):
        lg, cache = p["api"].decode_step(p["model"], toks[:, t:t + 1], cache)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full,
                               rtol=SSM_DECODE_TOL, atol=SSM_DECODE_TOL)


def test_zamba_decode_step_raises_on_a_full_cache(family):
    p = family("zamba2-1.2b")
    cache = p["api"].init_cache(p["model"], 1, 2)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for _ in range(2):
        _, cache = p["api"].decode_step(p["model"], tok, cache)
    with pytest.raises(ValueError, match="full"):
        p["api"].decode_step(p["model"], tok, cache)


def test_params_from_numpy_rejects_bad_trees(family):
    """A shape mismatch, a leaf without a parameter and a parameter
    without a leaf."""
    p = family("xlstm-1.3b")
    tree, cfg = p["tree"], p["cfg"]
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="weight for a"):
        params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="has no 'extra'"):
        params_from_numpy(cfg, dict(tree, extra=tree["final_norm"]),
                          device="cpu")
    with pytest.raises(ValueError, match="no value for"):
        params_from_numpy(cfg, {k: v for k, v in tree.items()
                                if k != "lm_head"}, device="cpu")


# --------------------------------------------------- full-width parameters


def chip_constants() -> dict:
    """``chip_smoke.py``'s parameter counts of the families at full
    width."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.FAMILY_PARAMS


def full_width_counts(name: str) -> tuple[int, int]:
    """(the port's parameters, built on the meta device; JAX's, from
    ``jax.eval_shape`` of its init) at the published config."""
    cfg = ARCHS[name]
    cls = whisper.Whisper if cfg.enc_dec else \
        ssm_lm.XLSTM if cfg.family == "ssm" else ssm_lm.Zamba
    model = cls(cfg, device="meta")
    shapes = jax.eval_shape(jbuild_model(JARCHS[name]).init,
                            jax.random.PRNGKey(0))
    return (sum(p.numel() for p in model.parameters()),
            sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)))


@pytest.mark.parametrize("name", SSMS)
def test_full_width_parameters_match_jax(name):
    """The constants ``chip_smoke.py`` holds the card's models to."""
    ours, theirs = full_width_counts(name)
    assert ours == theirs == chip_constants()[name]


# ------------------------------------------------------- zoo and serving


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_build_model_every_arch(name):
    """Every configuration builds a ``ModelApi`` whose reduced model
    decodes two steps (after the encoder prefill for whisper) with finite
    logits, the reference's ``prefill`` presence and its model class."""
    cfg = ARCHS[name].reduced()
    api = build_model(cfg)
    assert isinstance(api, ModelApi) and api.cfg is cfg
    assert (api.prefill is None) == (cfg.family in ("ssm", "hybrid"))
    model = api.init(torch.Generator().manual_seed(0))
    want = whisper.Whisper if cfg.enc_dec else {
        "ssm": ssm_lm.XLSTM, "hybrid": ssm_lm.Zamba}.get(cfg.family,
                                                         Transformer)
    assert type(model) is want
    cache = api.init_cache(model, 2, 8)
    if cfg.enc_dec:
        frames = torch.randn((2, cfg.enc_frames, cfg.d_model),
                             generator=torch.Generator().manual_seed(1))
        cache = api.prefill(model, {"frames": frames}, cache)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for step in range(2):
        logits, cache = api.decode_step(model, tok, cache)
        assert logits.shape == (2, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
    assert cache["len"] == 2
    assert model.embed_tokens(tok).shape == (2, 1, cfg.d_model)


@pytest.mark.parametrize("name", SSMS)
def test_init_distributions(name):
    """The reference's distributions, repeatable from one seed."""
    cfg = ARCHS[name].reduced()
    api = build_model(cfg)
    m = api.init(torch.Generator().manual_seed(0)).requires_grad_(False)
    again = api.init(torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(m.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
    assert abs(float(m.embed.std()) - 0.02) < 0.002
    assert torch.equal(m.final_norm, torch.ones_like(m.final_norm))
    if cfg.family == "hybrid":
        blk = m.groups[0][0].mamba
        assert abs(float(blk.conv.std()) - 0.5) < 0.05
        assert abs(float(blk.in_proj.weight.std())
                   - cfg.d_model ** -0.5) < 0.01
        assert torch.allclose(blk.A_log, torch.ones_like(blk.A_log))
        assert not bool(blk.dt_bias.any())
        assert torch.equal(blk.D, torch.ones_like(blk.D))
        assert len(m.tail) == 1
    else:
        blk = m.slstm_blocks[0].slstm
        assert abs(float(blk.r_gates.std()) - 0.1) < 0.01
        mb = m.mlstm_blocks[0][0].mlstm
        assert abs(float(mb.w_if.weight.std()) - 0.01) < 0.001
        assert torch.equal(mb.out_norm, torch.ones_like(mb.out_norm))


@pytest.mark.parametrize("name", SSMS)
def test_engine_matches_jax(family, name):
    """The ``Engine`` over the family's cache (no ``"k"`` entry): its
    greedy tokens are JAX's ``Engine``'s up to a near tie, on the model's
    device, the cache advanced."""
    p = family(name)
    seed = tokens(p["cfg"], 11, (B, 1))
    eng = Engine(p["api"], p["model"], batch=B, max_len=MAX_LEN)
    assert eng.device == p["model"].embed.device
    out = eng.decode(torch.from_numpy(seed), 6)
    assert out.shape == (B, 6) and out.dtype == torch.int32
    assert eng.cache["len"] == 6 and eng.stats.tokens == 6 * B
    jeng = JEngine(p["japi"], p["jparams"], batch=B, max_len=MAX_LEN)
    jout = np.asarray(jeng.decode(jnp.asarray(seed), 6))
    jtoks, margins = jax_greedy(p["japi"], p["jparams"], seed, 6)
    np.testing.assert_array_equal(jout, jtoks)
    _same_tokens(out.numpy(), jtoks, margins)


def test_rag_answer_xlstm_matches_jax(family):
    rag_against_jax(family("xlstm-1.3b"))


def test_launch_serve_cpu_zamba2():
    """``python -m repro_torch.launch.serve --device cpu --arch
    zamba2-1.2b --steps 2 --rag`` in a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "zamba2-1.2b", "--steps", "2", "--rag"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "decoded 4×2 tokens" in out.stdout
    assert "RAG: retrieved 5 docs/request" in out.stdout
