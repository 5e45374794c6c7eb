"""The port's training path (``repro_torch.train``, ``make_token_batch``,
``launch.train``) against the JAX package's, on the CPU.

Inputs are numpy-seeded or JAX's own draws.  The optimizer's update on
identical inputs is held to rtol 1e-6, atol 1e-7 (float32 products in
another order); training losses from JAX's weights on JAX's batches to
rtol 1e-4 (float32 forwards summed in another order, three steps);
compression's int8 codes exactly and its scale within 1 ulp."""

import multiprocessing
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data import make_token_batch as jmake_token_batch  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import make_token_batch, split_tokens  # noqa: E402
from repro_torch.interop import adamw_from_numpy, \
    params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_RTOL = 1e-4
ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def qwen():
    """(port api, JAX api, JAX's init of seed 0 as numpy)."""
    japi = jbuild_model(JARCHS[ARCH].reduced())
    tree = jax.tree.map(np.asarray, jax.jit(japi.init)(
        jax.random.PRNGKey(0)))
    return build_model(ARCHS[ARCH].reduced()), japi, tree


def _jax_batches(cfg, tc, steps):
    """The batches JAX's ``train`` draws at steps 0..steps-1, as numpy."""
    return [jax.tree.map(np.array, jmake_token_batch(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed + 1), s), tc.batch,
        tc.seq_len, cfg.vocab)) for s in range(steps)]


def _feeder(batches, start=0):
    """An ``extra_batch`` replacing each step's batch by the next of
    ``batches`` from index ``start``."""
    it = iter(batches[start:])
    return lambda gen: {k: torch.from_numpy(v) for k, v in next(it).items()}


# ------------------------------------------------------------------ data


def test_token_batch_split_matches_jax():
    key = jax.random.PRNGKey(7)
    want = jmake_token_batch(key, 3, 12, 97)
    draw = jax.random.randint(key, (3, 13), 0, 97, dtype=jnp.int32)
    got = split_tokens(torch.from_numpy(np.array(draw)))
    for name in ("tokens", "labels"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    a = make_token_batch(torch.Generator().manual_seed(3), 3, 12, 97,
                         device="cpu")
    b = make_token_batch(torch.Generator().manual_seed(3), 3, 12, 97,
                         device="cpu")
    assert a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert torch.equal(a["tokens"], b["tokens"])


# ------------------------------------------------------------- optimizer


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_update_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jstate = jopt.init(params)
    jparams = dict(params)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = optimizer.AdamWState(
        step=0, mu={k: torch.zeros(s) for k, s in shapes.items()},
        nu={k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            jparams, lr=1e-2)
        _, tstate = optimizer.update(
            {k: torch.from_numpy(v.copy()) for k, v in grads.items()},
            tstate, tparams, lr=1e-2)
        assert tstate.step == int(jstate.step)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), **OPT_TOL)
            np.testing.assert_allclose(tstate.mu[k].numpy(),
                                       np.asarray(jstate.mu[k]), **OPT_TOL)
            np.testing.assert_allclose(tstate.nu[k].numpy(),
                                       np.asarray(jstate.nu[k]), **OPT_TOL)


def test_grad_clip():
    """JAX's ``test_grad_clip`` on the port."""
    params = {"w": torch.ones(4)}
    state = optimizer.AdamWState(0, {"w": torch.zeros(4)},
                                 {"w": torch.zeros(4)})
    optimizer.update({"w": torch.full((4,), 1e6)}, state, params, lr=0.1,
                     grad_clip=1.0, weight_decay=0.0)
    assert float((params["w"] - 1.0).abs().max()) < 0.2


def test_loss_decreases(qwen, tmp_path):
    """JAX's ``test_loss_decreases`` on the port: one fixed batch."""
    api = qwen[0]
    tc = TrainConfig(steps=30, batch=4, seq_len=32, lr=1e-3, ckpt_every=0,
                     ckpt_dir=str(tmp_path))
    fixed = make_token_batch(torch.Generator().manual_seed(42), 4, 32,
                             api.cfg.vocab, device="cpu")
    state = train(api, tc, resume=False, extra_batch=lambda g: fixed,
                  device="cpu")
    assert np.mean(state.losses[-5:]) < np.mean(state.losses[:5])


# ------------------------------------------------------------------ loop


def test_loop_matches_jax(qwen, tmp_path):
    """Three steps from JAX's weights on JAX's batches."""
    api, japi, tree = qwen
    tc = TrainConfig(steps=3, batch=2, seq_len=16, ckpt_every=0,
                     ckpt_dir=str(tmp_path / "port"))
    jtc = jloop.TrainConfig(steps=3, batch=2, seq_len=16, ckpt_every=0,
                            ckpt_dir=str(tmp_path / "jax"))
    want = jloop.train(japi, jtc, resume=False).losses
    got = train(api, tc, model=params_from_numpy(api.cfg, tree,
                                                 device="cpu"),
                resume=False,
                extra_batch=_feeder(_jax_batches(api.cfg, tc, 3))).losses
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_step_fn_matches_jax(qwen):
    """``make_step_fn``: three whole steps from JAX's weights on JAX's
    batches give JAX's losses, and the state counts them."""
    api, japi, tree = qwen
    tc = TrainConfig(batch=2, seq_len=16)
    batches = _jax_batches(api.cfg, tc, 3)
    jstep = jloop.make_step_fn(japi, jloop.TrainConfig())
    params = jax.tree.map(jnp.asarray, tree)
    opt = jopt.init(params)
    step = loop.make_step_fn(api, tc)
    model = params_from_numpy(api.cfg, tree, device="cpu")
    state = optimizer.init(model)
    for b in batches:
        jloss, params, opt = jstep(params, opt, b)
        loss, model, state = step(model, state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        assert loss.dim() == 0 and not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
    assert state.step == 3 == int(opt.step)
    assert all(p.grad is None for p in model.parameters())


def test_resume_from_jax_optimizer_state(qwen, tmp_path):
    """Two JAX steps, then the port resumes from JAX's parameters and
    AdamW state (through a port checkpoint) for steps 2 and 3."""
    api, japi, tree = qwen
    jtc = jloop.TrainConfig(steps=4, batch=2, seq_len=16)
    batches = _jax_batches(api.cfg, jtc, 4)
    step_fn = jloop.make_step_fn(japi, jtc)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jopt.init(params)
    losses = []
    for b in batches:
        if len(losses) == 2:
            params2, opt2 = params, opt
        loss, params, opt = step_fn(params, opt, b)
        losses.append(float(loss))
    model = params_from_numpy(api.cfg, jax.tree.map(np.asarray, params2),
                              device="cpu")
    state = adamw_from_numpy(api.cfg, model,
                             jax.tree.map(np.asarray, opt2))
    assert state.step == 2
    ckpt.save(str(tmp_path), 2, {"params": dict(model.named_parameters()),
                                 "opt": state})
    tc = TrainConfig(steps=4, batch=2, seq_len=16, ckpt_every=0,
                     ckpt_dir=str(tmp_path))
    got = train(api, tc, model=params_from_numpy(api.cfg, tree,
                                                 device="cpu"),
                extra_batch=_feeder(batches, 2))
    assert got.step == 4 and got.opt.step == 4
    np.testing.assert_allclose(got.losses, losses[2:], rtol=LOSS_RTOL)


def test_straggler_and_spike_counts(qwen, tmp_path, monkeypatch):
    """A fake clock makes step 0 (left out of the EWMA) take 50× and
    step 5 10× the others; a loss scaled 1000× at step 3 and a NaN at
    step 6 are skipped."""
    api = qwen[0]
    durations = {0: 50.0, 5: 10.0}
    clock = SimpleNamespace(now=0.0, calls=0)

    def perf_counter():
        # two reads an iteration: its start, then after the loss is read
        step = clock.calls // 2
        if clock.calls % 2:
            clock.now += durations.get(step, 1.0)
        clock.calls += 1
        return clock.now

    real_loss = loop.loss_fn
    factors = {3: 1000.0, 6: float("nan")}
    seen = []

    def loss_fn(api, model, batch):
        seen.append(len(seen))
        return real_loss(api, model, batch) * factors.get(seen[-1], 1.0)

    monkeypatch.setattr(loop, "time", SimpleNamespace(
        perf_counter=perf_counter))
    monkeypatch.setattr(loop, "loss_fn", loss_fn)
    events = []
    tc = TrainConfig(steps=8, batch=2, seq_len=16, ckpt_every=0,
                     ckpt_dir=str(tmp_path), straggler_factor=2.0)
    state = train(api, tc, resume=False, device="cpu",
                  on_straggler=lambda step, dt: events.append((step, dt)))
    assert state.stragglers == 1 and events == [(5, 10.0)]
    assert state.skipped == 2 and len(state.losses) == 6
    assert state.opt.step == 6 and state.step == 8


def test_deterministic_replay_and_resume(qwen, tmp_path):
    api = qwen[0]

    def run(ckpt_dir, steps, seed=42, resume=False):
        return train(api, TrainConfig(steps=steps, batch=2, seq_len=16,
                                      ckpt_every=2, ckpt_dir=ckpt_dir,
                                      seed=seed),
                     resume=resume, device="cpu")

    a = run(str(tmp_path / "a"), 4)
    b = run(str(tmp_path / "b"), 4)
    assert a.losses == b.losses
    c = run(str(tmp_path / "c"), 2)
    assert ckpt.latest_step(str(tmp_path / "c")) == 2
    c2 = run(str(tmp_path / "c"), 4, resume=True)
    assert c2.step == 4 and c2.losses == a.losses[2:]
    done = run(str(tmp_path / "c"), 4, resume=True)
    assert done.step == 4 and done.losses == []


def test_train_needs_a_device(qwen, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(qwen[0], TrainConfig(steps=1), resume=False)


# ------------------------------------------------------------ checkpoint


def test_checkpoint_roundtrip(qwen, tmp_path):
    api = qwen[0]
    model = api.init(torch.Generator().manual_seed(0))
    opt = optimizer.init(model)
    with torch.no_grad():
        for name, m in opt.mu.items():
            m.normal_(generator=torch.Generator().manual_seed(len(name)))
    tree = {"params": dict(model.named_parameters()),
            "opt": opt._replace(step=7)}
    path = ckpt.save(str(tmp_path), 7, tree)
    assert Path(path).name == "step-00000007"
    assert ckpt.latest_step(str(tmp_path)) == 7
    manifest = (Path(path) / "manifest.json").read_text()
    assert '"opt/step"' in manifest and '"params/embed"' in manifest
    back = ckpt.restore(str(tmp_path), 7, tree)
    assert back["opt"].step == 7 and isinstance(back["opt"].step, int)
    for name, p in tree["params"].items():
        assert torch.equal(back["params"][name], p)
    for name, m in opt.mu.items():
        assert torch.equal(back["opt"].mu[name], m)
        assert back["opt"].mu[name].dtype == torch.float32
    meta = ckpt.restore(str(tmp_path), 7, tree, device="meta")
    assert meta["params"]["embed"].device.type == "meta"
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 7, {"params": {"embed": torch.zeros(3)},
                                        "opt": tree["opt"]})


def test_checkpoint_atomic_overwrite_and_latest(tmp_path):
    tree = {"x": torch.arange(4.0)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, {"x": torch.arange(4.0) * 2})
    ckpt.save(str(tmp_path), 2, {"x": torch.arange(4.0) * 3})
    # unfinished writes of any rank (one with its manifest written), and
    # a directory with no manifest
    (tmp_path / "step-00000009.tmp1").mkdir()
    (tmp_path / "step-00000009.tmp1" / "manifest.json").write_text("{}")
    (tmp_path / "step-00000008.tmp0").mkdir()
    (tmp_path / "step-00000005").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 2
    np.testing.assert_array_equal(
        ckpt.restore(str(tmp_path), 2, tree)["x"].numpy(),
        np.arange(4.0) * 3)
    assert not any(p.name.endswith(".tmp0") and "00000002" in p.name
                   for p in tmp_path.iterdir())
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


# ----------------------------------------------------------- compression


def test_quantize_and_compress_match_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((64, 33)).astype(np.float32),
         "b": (1e-3 * rng.standard_normal(100)).astype(np.float32)}
    err = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in g.items()}
    for k, v in g.items():
        jq, js = jcomp.quantize_int8(jnp.asarray(v))
        tq, ts = comp.quantize_int8(torch.from_numpy(v))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), 1)
        np.testing.assert_array_equal(
            comp.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))
        jsent, jerr = jcomp.compress_leaf(jnp.asarray(v),
                                          jnp.asarray(err[k]))
        tsent, terr = comp.compress_leaf(torch.from_numpy(v),
                                         torch.from_numpy(err[k]))
        np.testing.assert_allclose(tsent.numpy(), np.asarray(jsent),
                                   rtol=2e-7, atol=0)
        np.testing.assert_allclose(terr.numpy(), np.asarray(jerr),
                                   rtol=1e-6, atol=1e-7 * np.abs(v).max())
    jsent, jerr = jcomp.compress_grads({k: jnp.asarray(v)
                                        for k, v in g.items()}, None)
    tsent, terr = comp.compress_grads({k: torch.from_numpy(v)
                                       for k, v in g.items()}, None)
    assert set(tsent) == set(g) == set(terr)
    for k in g:
        np.testing.assert_allclose(tsent[k].numpy(), np.asarray(jsent[k]),
                                   rtol=2e-7, atol=0)
        np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]),
                                   rtol=1e-6, atol=1e-7 * np.abs(g[k]).max())
    for compressed in (True, False):
        assert comp.wire_bytes({k: torch.from_numpy(v) for k, v in
                                g.items()}, compressed=compressed) == \
            jcomp.wire_bytes(g, compressed=compressed)
    grads = {"a": torch.ones(64, 64), "b": torch.ones(128)}
    assert comp.wire_bytes(grads, compressed=True) * 3.9 < \
        comp.wire_bytes(grads, compressed=False)


def test_error_feedback_telescopes():
    """JAX's telescoping test on the port."""
    gen = torch.Generator().manual_seed(1)
    err = torch.zeros(256)
    sent_sum, true_sum = torch.zeros(256), torch.zeros(256)
    for _ in range(50):
        g = torch.randn(256, generator=gen)
        sent, err = comp.compress_leaf(g, err)
        sent_sum += sent
        true_sum += g
    one = float(comp.compress_leaf(torch.randn(256, generator=gen),
                                   torch.zeros(256))[0].abs().max())
    assert float((sent_sum - true_sum).abs().max()) < 0.2 * one * 50


def _rank_data(rank: int):
    rng = np.random.default_rng(10 + rank)
    return (rng.standard_normal(300).astype(np.float32) * (rank + 1),
            (0.01 * rng.standard_normal(300)).astype(np.float32))


def _all_reduce_worker(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        x, err = _rank_data(rank)
        total, new_err = comp.compressed_all_reduce(torch.from_numpy(x),
                                                    torch.from_numpy(err))
        np.savez(os.path.join(out, f"rank{rank}.npz"), total=total.numpy(),
                 err=new_err.numpy())
    finally:
        dist.destroy_process_group()


def test_compressed_all_reduce_two_processes(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_all_reduce_worker,
                         args=(r, 2, port, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive), "a gloo worker did not finish in 60 s"
    assert [p.exitcode for p in procs] == [0, 0]
    # JAX's compressed_psum, in numpy float32
    targets = [x + e for x, e in (_rank_data(r) for r in range(2))]
    scale = np.float32(max(np.abs(t).max() for t in targets)) \
        / np.float32(127.0) + np.float32(1e-30)
    qs = [np.clip(np.round(t / scale), -127, 127).astype(np.int32)
          for t in targets]
    total = (qs[0] + qs[1]).astype(np.float32) * scale
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["total"], total, rtol=2e-7, atol=0)
        np.testing.assert_allclose(
            got["err"], targets[r] - qs[r].astype(np.float32) * scale,
            rtol=1e-6, atol=1e-7 * float(np.abs(targets[r]).max()))


def test_compressed_all_reduce_one_rank():
    x, err = _rank_data(0)
    total, new_err = comp.compressed_all_reduce(torch.from_numpy(x),
                                                torch.from_numpy(err))
    sent, want_err = comp.compress_leaf(torch.from_numpy(x),
                                        torch.from_numpy(err))
    assert torch.equal(total, sent) and torch.equal(new_err, want_err)


# ---------------------------------------------------------------- launch


def test_launch_train_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(args, capture_output=True, text=True, env=env,
                         timeout=120, check=True).stdout
    assert "done: step=2" in out
    assert ckpt.latest_step(str(tmp_path)) == 2
    out = subprocess.run(args, capture_output=True, text=True, env=env,
                         timeout=120, check=True).stdout
    assert "resumed past --steps" in out


def test_launch_train_encoder_decoder(tmp_path, capsys):
    """The launcher feeds whisper seeded frames (the reference's
    launcher gives it tokens only, which its forward cannot take)."""
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", "whisper-medium", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "8",
                       "--ckpt-dir", str(tmp_path)])
    assert "done: step=1" in capsys.readouterr().out
