"""The port's ``loss_fn`` and its gradients against
``jax.value_and_grad(repro.models.loss_fn)``, on the reduced
configuration of one architecture of each ``build_model`` branch: dense
(qwen2.5-3b), MoE with its aux loss (phi3.5-moe), xlstm, zamba2 and the
encoder-decoder (whisper, with ``frames``).

Both packages start from JAX's init of seed 0 (through
``interop.params_from_numpy``) and take one numpy-seeded batch.  The loss
must agree within rtol 1e-5, each gradient within 1e-4 · max|JAX leaf| +
1e-6 (float32 backward passes summed in other orders); JAX's gradient
tree reaches the port's parameter names through the same name walk.
``remat=True`` must give ``remat=False``'s loss and gradients within
rtol 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import build_model, loss_fn  # noqa: E402

FAMILIES = ("qwen2.5-3b", "phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
            "zamba2-1.2b", "whisper-medium")
B, S = 2, 16


def _batch(cfg, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(api, model, batch, **kw):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(api, model, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(port cfg, port api, port model, batch, JAX loss, JAX grads by the
    port's parameter names)."""
    name = request.param
    japi = jbuild_model(JARCHS[name].reduced())
    tree = jax.tree.map(np.asarray,
                        jax.jit(japi.init)(jax.random.PRNGKey(0)))
    cfg = ARCHS[name].reduced()
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(japi, p, jbatch)))(
        jax.tree.map(jnp.asarray, tree))
    shadow = params_from_numpy(cfg, jax.tree.map(np.asarray, grads),
                               device="cpu")
    return (cfg, build_model(cfg), params_from_numpy(cfg, tree,
                                                     device="cpu"),
            batch, float(loss),
            {n: p.detach() for n, p in shadow.named_parameters()})


def test_loss_and_grads_match_jax(family):
    cfg, api, model, batch, jloss, jgrads = family
    loss, grads = _port_grads(api, model, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert list(grads) == list(jgrads)
    worst = {}
    for name, g in grads.items():
        want = jgrads[name]
        err = float((g - want).abs().max())
        limit = 1e-4 * float(want.abs().max()) + 1e-6
        if err > limit:
            worst[name] = (err, limit)
    assert not worst, worst
    if cfg.is_moe:
        # the router is trained through the gates and the aux loss
        router = [n for n in grads if n.endswith("router.weight")]
        assert router and all(float(grads[n].abs().max()) > 0
                              for n in router)


def test_remat_changes_nothing(family):
    cfg, api, model, batch, _, _ = family
    loss_r, grads_r = _port_grads(api, model, batch, remat=True)
    loss_n, grads_n = _port_grads(api, model, batch, remat=False)
    np.testing.assert_allclose(loss_r, loss_n, rtol=1e-6)
    for name, g in grads_r.items():
        scale = float(grads_n[name].abs().max())
        np.testing.assert_allclose(g.numpy(), grads_n[name].numpy(),
                                   rtol=1e-6, atol=1e-6 * scale + 1e-12,
                                   err_msg=name)


def test_remat_recomputes_only_under_grad(monkeypatch):
    """``remat`` checkpoints each block while autograd records and leaves
    an inference forward alone."""
    from repro_torch.models import layers as L
    calls = []
    real = L.checkpoint

    def spy(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(L, "checkpoint", spy)
    cfg = ARCHS["qwen2.5-3b"].reduced()
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        api.forward(model, batch)
    assert calls == []
    loss_fn(api, model, batch).backward()
    assert len(calls) == cfg.n_layers
