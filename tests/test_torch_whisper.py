"""The port's encoder-decoder (``repro_torch.models.whisper``) against the
JAX package's, on the reduced whisper-medium configuration.

JAX's weights come from its jitted ``api.init(PRNGKey(0))`` with every
norm scale drawn from a numpy seed, carried by
``interop.params_from_numpy``; frames and tokens are numpy-seeded.  The
encoder output, the cross-attention K/V of ``prefill_encoder``, logits
and every cache entry must agree within rtol = atol = 1e-4; the port's
decode must match its own forward within the JAX package's 2e-3.  The
JAX work is done once, in the module-scoped ``pair`` fixture.  Also here:
the rule that the port and ``chip_smoke.py`` import neither ``jax`` nor
the JAX package."""

import ast
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

from repro.models import whisper as jwhisper  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from test_torch_rag import _same_tokens  # noqa: E402
from test_torch_ssm import (B, MAX_LEN, S, chip_constants,  # noqa: E402
                            close, close_cache, full_width_counts, jax_greedy,
                            jax_pair, rag_against_jax, to_numpy, tokens)

ROOT = Path(__file__).resolve().parents[1]
NAME = "whisper-medium"
DECODE_TOL = 2e-3              # decode ≡ forward, tests/test_models.py's


@pytest.fixture(scope="module")
def pair():
    """The reduced whisper in both packages, frames (B, enc_frames, D),
    teacher-forced tokens (B, S), and JAX's encoder output, forward
    logits, prefilled cache and the logits and cache after each of S
    decode steps."""
    japi, jparams, tree, cfg, api, model = jax_pair(NAME)
    frames = np.random.default_rng(3).standard_normal(
        (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    toks = tokens(cfg, 1)
    jf = jnp.asarray(frames)
    jenc = np.asarray(jwhisper.encode(jparams, jf, cfg, remat=False))
    jlogits = np.asarray(japi.forward(
        jparams, {"frames": jf, "tokens": jnp.asarray(toks)})[0])
    jcache = japi.prefill(jparams, {"frames": jf},
                          japi.init_cache(jparams, B, MAX_LEN))
    prefilled = to_numpy(jcache)
    steps = []
    for t in range(S):
        lg, jcache = japi.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]),
                                      jcache)
        steps.append((np.asarray(lg), to_numpy(jcache)))
    return dict(japi=japi, jparams=jparams, tree=tree, cfg=cfg, api=api,
                model=model, frames=frames, toks=toks, jenc=jenc,
                jlogits=jlogits, prefilled=prefilled, jsteps=steps)


def _prefilled(p) -> dict:
    return p["api"].prefill(p["model"],
                            {"frames": torch.from_numpy(p["frames"])},
                            p["api"].init_cache(p["model"], B, MAX_LEN))


def test_gelu_is_jax_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation: the port's
    ``F.gelu(approximate="tanh")`` matches it, the erf form does not
    within the parity bound."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    t = torch.from_numpy(x)
    want = jax.nn.gelu(jnp.asarray(x))
    close(torch.nn.functional.gelu(t, approximate="tanh"), want,
          rtol=1e-6, atol=1e-6)
    assert float(np.abs(torch.nn.functional.gelu(t).numpy()
                        - np.asarray(want)).max()) > 1e-4


def test_encode_matches_jax(pair):
    with torch.no_grad():
        enc = whisper.encode(pair["model"], torch.from_numpy(pair["frames"]),
                             pair["cfg"])
    close(enc, pair["jenc"])


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(pair, last_only):
    p = pair
    with torch.no_grad():
        logits, aux = p["api"].forward(
            p["model"], {"frames": torch.from_numpy(p["frames"]),
                         "tokens": torch.from_numpy(p["toks"])},
            last_only=last_only, remat=False)
    want = p["jlogits"][:, -1:] if last_only else p["jlogits"]
    assert logits.shape == want.shape
    close(logits, want)
    assert float(aux) == 0.0


def test_prefill_encoder_matches_jax(pair):
    """The cross K/V of every decoder layer; the self-attention cache
    still zero and ``len`` 0."""
    cache = _prefilled(pair)
    close_cache(to_numpy(cache), pair["prefilled"])
    assert cache["len"] == 0 and not bool(cache["k"].any())


def test_prefill_encoder_rejects_other_frames(pair):
    p = pair
    frames = torch.zeros((B, p["cfg"].enc_frames - 1, p["cfg"].d_model))
    with pytest.raises(ValueError, match="frames"):
        p["api"].prefill(p["model"], {"frames": frames},
                         p["api"].init_cache(p["model"], B, MAX_LEN))


def test_decode_steps_match_jax(pair):
    """S teacher-forced steps after the encoder prefill: logits and every
    cache entry after each."""
    p = pair
    cache = _prefilled(p)
    for t, (jlogits, jcache) in enumerate(p["jsteps"]):
        logits, cache = p["api"].decode_step(
            p["model"], torch.from_numpy(p["toks"][:, t:t + 1]), cache)
        close(logits, jlogits)
        close_cache(to_numpy(cache), jcache)


def test_decode_matches_forward(pair):
    p = pair
    toks = torch.from_numpy(p["toks"])
    with torch.no_grad():
        full, _ = p["api"].forward(
            p["model"], {"frames": torch.from_numpy(p["frames"]),
                         "tokens": toks})
    cache = _prefilled(p)
    outs = []
    for t in range(S):
        lg, cache = p["api"].decode_step(p["model"], toks[:, t:t + 1], cache)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_decode_step_raises_on_a_full_cache(pair):
    p = pair
    cache = p["api"].init_cache(p["model"], 1, 2)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for _ in range(2):
        _, cache = p["api"].decode_step(p["model"], tok, cache)
    with pytest.raises(ValueError, match="full"):
        p["api"].decode_step(p["model"], tok, cache)


def test_full_width_parameters_match_jax():
    """846,077,952 at the published config, the constant
    ``chip_smoke.py`` holds the card's model to."""
    ours, theirs = full_width_counts(NAME)
    assert ours == theirs == chip_constants()[NAME]


def test_init_distributions():
    cfg = ARCHS[NAME].reduced()
    m = whisper.init(cfg, generator=torch.Generator().manual_seed(0)) \
        .requires_grad_(False)
    again = whisper.init(cfg, generator=torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(m.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
    assert m.dec_pos.shape == (whisper.max_dec(cfg), cfg.d_model) == \
        (128, cfg.d_model)
    assert whisper.max_dec(ARCHS[NAME]) == 32768
    for pos in (m.enc_pos, m.dec_pos, m.embed):
        assert abs(float(pos.std()) - 0.02) < 0.003
    blk = m.dec_blocks[0]
    assert abs(float(blk.mlp.wo.weight.std()) - cfg.d_ff ** -0.5) < 0.01
    assert torch.equal(blk.lnx, torch.ones_like(blk.lnx))
    assert torch.equal(m.enc_norm, torch.ones_like(m.enc_norm))


def test_engine_prefill_then_decode_matches_jax(pair):
    """The ``Engine`` encodes the frames, then decodes greedily: JAX's
    ``Engine``'s tokens up to a near tie."""
    p = pair
    seed = tokens(p["cfg"], 11, (B, 1))
    eng = Engine(p["api"], p["model"], batch=B, max_len=MAX_LEN)
    eng.prefill({"frames": torch.from_numpy(p["frames"])})
    out = eng.decode(torch.from_numpy(seed), 6)
    assert out.shape == (B, 6) and eng.cache["len"] == 6
    jeng = JEngine(p["japi"], p["jparams"], batch=B, max_len=MAX_LEN)
    jeng.prefill({"frames": jnp.asarray(p["frames"])})
    jout = np.asarray(jeng.decode(jnp.asarray(seed), 6))
    jtoks, margins = jax_greedy(p["japi"], p["jparams"], seed, 6,
                                prefill={"frames": jnp.asarray(p["frames"])})
    np.testing.assert_array_equal(jout, jtoks)
    _same_tokens(out.numpy(), jtoks, margins)


def test_rag_answer_whisper_matches_jax(pair):
    """The round trip after the encoder prefill, in both packages."""
    rag_against_jax(pair, prefill={"frames": pair["frames"]})


def test_launch_serve_cpu_whisper():
    """``python -m repro_torch.launch.serve --device cpu --arch
    whisper-medium --steps 2 --rag``: the encoder prefill, then the
    decode and the round trip."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", NAME, "--steps", "2", "--rag"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "decoded 4×2 tokens" in out.stdout
    assert "RAG: retrieved 5 docs/request" in out.stdout


def test_port_imports_no_jax():
    """No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or the JAX package ``repro``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
