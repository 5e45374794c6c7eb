"""The port's LM side (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package's, on the reduced configurations of the seven
transformer architectures.

JAX weights come from ``api.init(PRNGKey(0))``, with the norm scales and
QKV biases drawn from a numpy seed, and reach the port through
``interop.params_from_numpy``; inputs are numpy-seeded.  Logits, the MoE
aux loss and the KV cache must agree within rtol = atol = 1e-4 (float32
products summed in other orders); the port's decode must match its own
forward within the JAX package's bound for that check (2e-3,
``tests/test_models.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, shape_applicable  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
TRANSFORMERS = ("qwen2-vl-2b", "qwen2-72b", "qwen2.5-3b", "qwen1.5-4b",
                "gemma3-4b", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b")
B, S = 2, 16


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _drawn_affine(tree: dict, seed: int) -> dict:
    """``tree`` with its norm scales and QKV biases drawn from ``seed``:
    the reference's init makes them ones and zeros, under which a swapped
    or dropped leaf would pass unseen."""
    rng = np.random.default_rng(seed)

    def draw(a, centre: float):
        return (centre + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)

    blocks = dict(tree["blocks"], ln1=draw(tree["blocks"]["ln1"], 1.0),
                  ln2=draw(tree["blocks"]["ln2"], 1.0))
    blocks["attn"] = {name: draw(v, 0.0) if name in ("bq", "bk", "bv")
                      else v for name, v in blocks["attn"].items()}
    return dict(tree, blocks=blocks, final_norm=draw(tree["final_norm"], 1.0))


@pytest.fixture(scope="module")
def models():
    """name → (reduced cfg, JAX api, JAX params, port api, port model);
    built on first use.  Both packages carry one tree: JAX's init with
    its norms and biases drawn (``_drawn_affine``, seed 2; seed 1 puts a
    mixtral router's 2nd and 3rd probabilities 5.2e-7 apart on one
    token, a tie that float32 rounding decides either way)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = JARCHS[name].reduced()
            japi = jbuild_model(cfg)
            tree = _drawn_affine(jax.tree.map(
                np.asarray, japi.init(jax.random.PRNGKey(0))), 2)
            jparams = jax.tree.map(jnp.asarray, tree)
            pcfg = ARCHS[name].reduced()
            model = params_from_numpy(pcfg, tree, device="cpu")
            cache[name] = (pcfg, japi, jparams, build_model(pcfg), model)
        return cache[name]
    return get


def _tokens(cfg, seed: int, shape=(B, S)) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_config_equals_jax(name):
    """Every field, the derived properties, the reduced config and the
    parameter counts of all ten architectures."""
    j, p = JARCHS[name], ARCHS[name]
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for c, jc in ((p, j), (p.reduced(), j.reduced())):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert (c.hd, c.is_moe, c.subquadratic, c.has_decoder) == \
            (jc.hd, jc.is_moe, jc.subquadratic, jc.has_decoder)
        assert c.params_count() == jc.params_count()
        assert c.active_params_count() == jc.active_params_count()
    assert sorted(ARCHS) == sorted(JARCHS)
    for shape in SHAPES:
        assert dataclasses.asdict(SHAPES[shape]) == \
            dataclasses.asdict(JSHAPES[shape])
        assert shape_applicable(p, SHAPES[shape]) == \
            jshape_applicable(j, JSHAPES[shape])


def test_qwen2_5_3b_full_width_count():
    """The chip run's model: 3,085,697,024 parameters."""
    assert ARCHS["qwen2.5-3b"].params_count() == 3_085_697_024


def test_layer_is_local_gemma3():
    cfg, jcfg = ARCHS["gemma3-4b"], JARCHS["gemma3-4b"]
    got = [T.layer_is_local(cfg, i) for i in range(cfg.n_layers)]
    assert got == [JT.layer_is_local(jcfg, i) for i in range(cfg.n_layers)]
    assert got[:12] == [True] * 5 + [False] + [True] * 5 + [False]
    assert T.layer_windows(cfg) == np.asarray(JT.layer_windows(jcfg)).tolist()


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mixtral-8x22b"])
def test_layer_windows_without_pattern(name):
    cfg = ARCHS[name].reduced()
    assert T.layer_windows(cfg) == np.asarray(
        JT.layer_windows(JARCHS[name].reduced())).tolist()


# ------------------------------------------------------------------- RoPE


@pytest.mark.parametrize("head_dim,theta", [(32, 1e4), (64, 1e6), (128, 1e6)])
def test_rope_angles_match_jax(head_dim, theta):
    pos = np.arange(40, dtype=np.int32)
    sin, cos = L.rope_angles(torch.from_numpy(pos), head_dim, theta)
    jsin, jcos = JL.rope_angles(jnp.asarray(pos), head_dim, theta)
    _close(sin, jsin, rtol=1e-5, atol=1e-5)
    _close(cos, jcos, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head_dim", [32, 36, 128])
def test_mrope_angles_match_jax(head_dim):
    """Distinct (t, h, w) coordinates; hd/2 not divisible by 4 at 36 (the
    remainder goes to the last section)."""
    pos = np.random.default_rng(0).integers(0, 50, (2, 3, 12)) \
        .astype(np.int32)
    sin, cos = L.mrope_angles(torch.from_numpy(pos), head_dim, 1e6)
    jsin, jcos = JL.mrope_angles(jnp.asarray(pos), head_dim, 1e6)
    _close(sin, jsin, rtol=1e-5, atol=1e-5)
    _close(cos, jcos, rtol=1e-5, atol=1e-5)
    # text: three equal coordinates give standard RoPE
    same = np.repeat(pos[:, :1], 3, axis=1)
    msin, _ = L.mrope_angles(torch.from_numpy(same), head_dim, 1e6)
    rsin, _ = L.rope_angles(torch.from_numpy(same[:, 0]), head_dim, 1e6)
    torch.testing.assert_close(msin, rsin)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("name", TRANSFORMERS)
@pytest.mark.parametrize("variant", ["full", "q_block", "last_only"])
def test_forward_matches_jax(models, name, variant):
    cfg, japi, jparams, api, model = models(name)
    toks = _tokens(cfg, 1)
    kw = {"full": {}, "q_block": {"q_block": 8},
          "last_only": {"last_only": True}}[variant]
    jlogits, jaux = japi.forward(jparams, {"tokens": jnp.asarray(toks)}, **kw)
    with torch.no_grad():
        logits, aux = api.forward(model, {"tokens": torch.from_numpy(toks)},
                                  **kw)
    assert logits.shape == jlogits.shape
    _close(logits, jlogits)
    _close(aux, jaux)
    if cfg.is_moe:
        assert float(aux) > 0


def test_forward_embeds_and_positions_match_jax(models):
    """qwen2-vl with stubbed patch embeddings and distinct M-RoPE
    coordinates."""
    cfg, japi, jparams, api, model = models("qwen2-vl-2b")
    rng = np.random.default_rng(2)
    embeds = (0.02 * rng.standard_normal((B, S, cfg.d_model))) \
        .astype(np.float32)
    pos = rng.integers(0, 64, (B, 3, S)).astype(np.int32)
    jlogits, _ = japi.forward(jparams, {"tokens": None,
                                        "embeds": jnp.asarray(embeds),
                                        "positions": jnp.asarray(pos)})
    with torch.no_grad():
        logits, _ = api.forward(model, {"embeds": torch.from_numpy(embeds),
                                        "positions": torch.from_numpy(pos)})
    _close(logits, jlogits)


# ----------------------------------------------------------------- decode

PROMPT, MAX_LEN = 4, 32


@pytest.mark.parametrize("name", TRANSFORMERS)
def test_prefill_matches_jax(models, name):
    cfg, japi, jparams, api, model = models(name)
    toks = _tokens(cfg, 3, (B, PROMPT))
    jcache = japi.init_cache(jparams, B, MAX_LEN)
    jlogits, jcache = JT.prefill(jparams, jnp.asarray(toks), cfg, jcache)
    cache = api.init_cache(model, B, MAX_LEN)
    logits, cache = T.prefill(model, torch.from_numpy(toks), cfg, cache)
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    assert cache["len"] == int(jcache["len"]) == PROMPT


@pytest.mark.parametrize("name", TRANSFORMERS)
def test_decode_steps_match_jax(models, name):
    """A 4-token prefill, then teacher-forced decode steps on the same
    tokens in both packages (20 for gemma3: past its window of 16)."""
    cfg, japi, jparams, api, model = models(name)
    steps = 20 if cfg.sliding_window else 8
    toks = _tokens(cfg, 4, (B, PROMPT + steps))
    jcache = japi.init_cache(jparams, B, MAX_LEN)
    jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                          jcache)
    cache = api.prefill(model, {"tokens": torch.from_numpy(
        toks[:, :PROMPT])}, api.init_cache(model, B, MAX_LEN))
    for t in range(PROMPT, PROMPT + steps):
        step = toks[:, t:t + 1]
        jlogits, jcache = japi.decode_step(jparams, jnp.asarray(step), jcache)
        logits, cache = api.decode_step(model, torch.from_numpy(step), cache)
        _close(logits, jlogits)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])
        assert cache["len"] == int(jcache["len"]) == t + 1


@pytest.mark.parametrize("name", TRANSFORMERS)
def test_decode_matches_forward(models, name):
    """The port's teacher-forced decode equals its own forward (gemma3:
    20 tokens, past the window).  A MoE forward routes all tokens in one
    group, where a decode step routes one token alone, so capacity drops
    would differ: the MoE configurations run with a capacity factor at
    which no expert overflows (C ≥ Tg)."""
    cfg, _, _, api, model = models(name)
    if cfg.is_moe:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        api = build_model(cfg)
    n = 20 if cfg.sliding_window else 8
    toks = torch.from_numpy(_tokens(cfg, 5, (1, n)))
    with torch.no_grad():
        full, _ = api.forward(model, {"tokens": toks})
    cache = api.init_cache(model, 1, MAX_LEN)
    outs = []
    for t in range(n):
        lg, cache = api.decode_step(model, toks[:, t:t + 1], cache)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3,
                               atol=2e-3)


def test_decode_step_raises_on_a_full_cache(models):
    cfg, _, _, api, model = models("qwen2.5-3b")
    cache = api.init_cache(model, 1, 2)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for _ in range(2):
        _, cache = api.decode_step(model, tok, cache)
    with pytest.raises(ValueError, match="full"):
        api.decode_step(model, tok, cache)


# -------------------------------------------------------------------- MoE


def _sequential_keep(expert_ids: np.ndarray, e: int, cap: int) -> np.ndarray:
    """The capacity rule, one (token, choice) at a time in order: kept
    while its expert has had fewer than ``cap`` before it in the group."""
    g, tg, k = expert_ids.shape
    keep = np.zeros((g, tg, k), bool)
    for gi in range(g):
        used = np.zeros(e, int)
        for t in range(tg):
            for c in range(k):
                ex = expert_ids[gi, t, c]
                keep[gi, t, c] = used[ex] < cap
                used[ex] += 1
    return keep


@pytest.mark.parametrize("name", ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("cf,group_size", [(1.25, 512), (0.5, 512), (0.5, 8)])
def test_moe_ffn_matches_jax(models, name, cf, group_size):
    """Outputs and aux within tolerance and the same dropped (token,
    choice) pairs, on batches that overflow capacity (cf = 0.5)."""
    cfg, _, jparams, _, model = models(name)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    x = np.random.default_rng(6).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, cfg, group_size=group_size)
    moe = model.blocks[0].moe
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, aux = pmoe.moe_ffn(xt, moe, cfg, group_size=group_size)
        routing = pmoe.route(xt, moe, cfg, group_size=group_size)
    ids, keep, cap = routing.expert_ids, routing.keep, routing.cap
    _close(out, jout)
    _close(aux, jaux)
    g = B * S // min(group_size, B * S)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(g, -1, cfg.d_model)
                            @ jp["router"], axis=-1)
    jids = np.asarray(jax.lax.top_k(jprobs, cfg.moe_top_k)[1])
    np.testing.assert_array_equal(ids.numpy(), jids)
    want_keep = _sequential_keep(jids, cfg.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf < 1:
        assert not want_keep.all()      # the batch overflows


def test_top_k_stable_lower_index_first():
    x = torch.tensor([[0.2, 0.5, 0.5, 0.1, 0.5]])
    vals, idx = pmoe.top_k_stable(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# --------------------------------------------------------- zoo and init


def test_init_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = build_model(ARCHS["qwen2.5-3b"].reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init()


@pytest.mark.parametrize("name", ["qwen2.5-3b", "qwen2-72b",
                                  "mixtral-8x22b"])
def test_init_distributions(name):
    """The reference's distributions (normal · fan_in^-0.5, embeddings
    0.02, ones, zero biases), repeatable from one seed."""
    cfg = ARCHS[name].reduced()
    api = build_model(cfg)
    m = api.init(torch.Generator().manual_seed(0)).requires_grad_(False)
    again = api.init(torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(m.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
    assert abs(float(m.embed.std()) - 0.02) < 0.002
    blk = m.blocks[0]
    assert abs(float(blk.attn.wq.weight.std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(blk.attn.wo.weight.std())
               - (cfg.n_heads * cfg.hd) ** -0.5) < 0.01
    assert torch.equal(blk.ln1, torch.ones_like(blk.ln1))
    assert torch.equal(m.final_norm, torch.ones_like(m.final_norm))
    if cfg.qkv_bias:
        assert not bool(blk.attn.wq.bias.any())
    if cfg.is_moe:
        assert abs(float(blk.moe.wg.std()) - cfg.n_experts ** -0.5) < 0.02
    else:
        assert abs(float(blk.ffn.wd.weight.std()) - cfg.d_ff ** -0.5) < 0.01
    assert (m.lm_head is None) == cfg.tie_embeddings
    # ``params_count`` counts the projections and embeddings: every
    # matrix but the MoE router; norms and biases come on top
    matrices = sum(p.numel() for n, p in m.named_parameters()
                   if p.dim() >= 2 and "router" not in n)
    assert matrices == cfg.params_count()
    vectors = (2 * cfg.n_layers + 1) * cfg.d_model + (
        cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
        if cfg.qkv_bias else 0)
    routers = cfg.n_layers * cfg.d_model * cfg.n_experts
    assert sum(p.numel() for p in m.parameters()) == \
        cfg.params_count() + vectors + routers
