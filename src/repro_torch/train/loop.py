"""The fault-tolerant training loop (the port of ``repro.train.loop``).

Behaviours kept from the reference:
  * periodic checkpoints (atomic) and a deterministic resume from the
    latest manifest (``checkpoint``), laid out on the run's device;
  * straggler detection: each iteration's wall time feeds an EWMA (the
    first iteration of a run is left out of it); an iteration over
    ``straggler_factor`` × the EWMA is counted and reported to
    ``on_straggler(step, seconds)``;
  * a deterministic data stream: each step's batch is drawn from a CPU
    generator seeded from ``(seed + 1, step)``, so a resumed run replays
    the exact tokens;
  * loss-spike rejection: a NaN/Inf loss or one over ``spike_factor`` ×
    the loss EWMA skips the update.

The loss is read on the host once a step (``float(loss)``, the loop's one
synchronize), before the update, so a rejected step runs no update and
leaves ``opt.step`` where it was, as the reference's discarded update
does.  With the update queued after that read, each iteration's wall time
holds the previous step's update in steady state.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.data import make_token_batch
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import ModelApi, loss_fn
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    straggler_factor: float = 3.0
    spike_factor: float = 10.0
    seed: int = 0


@dataclass
class TrainState:
    model: nn.Module
    opt: optimizer.AdamWState
    step: int = 0
    losses: list = field(default_factory=list)
    stragglers: int = 0
    skipped: int = 0

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())


def make_step_fn(api: ModelApi, tc: TrainConfig):
    """One whole training step, as the reference's ``step_fn``:
    ``step_fn(model, opt, batch) → (loss, model, opt)``, the loss a 0-d
    device tensor, the model updated in place by AdamW at ``tc.lr``
    whatever the loss (``train`` instead reads the loss before the update,
    to reject spikes).  It reads no device value on the host."""
    def step_fn(model: nn.Module, opt: optimizer.AdamWState, batch: dict):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(api, model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        _, opt = optimizer.update(_grads(params), opt, params, lr=tc.lr)
        model.zero_grad(set_to_none=True)
        return loss.detach(), model, opt
    return step_fn


def _grads(params: dict) -> dict:
    """Each parameter's gradient, zeros where autograd left none."""
    return {name: p.grad if p.grad is not None else torch.zeros_like(p)
            for name, p in params.items()}


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s batch."""
    return torch.Generator().manual_seed((seed + 1) * 1_000_003 + step)


def train(api: ModelApi, tc: TrainConfig, *, model: nn.Module | None = None,
          resume: bool = True,
          on_straggler: Callable[[int, float], None] | None = None,
          extra_batch: Callable[[torch.Generator], dict] | None = None,
          device=None) -> TrainState:
    """Train ``model`` (by default ``api.init`` drawn from ``tc.seed`` on
    ``device``, the GPU unless given) for ``tc.steps`` steps of AdamW at
    ``tc.lr``, resuming from the latest checkpoint in ``tc.ckpt_dir``
    when ``resume``.  ``extra_batch(generator)`` returns entries that
    replace or join the step's batch (a fixed batch, whisper's
    ``frames``).  The model is trained in place and returned in the
    state."""
    if model is None:
        dev = resolve_device(device)
        model = api.init(torch.Generator(device=dev).manual_seed(tc.seed))
    dev = model.embed.device
    state = TrainState(model=model, opt=optimizer.init(model))
    params = state.params

    if resume:
        latest = ckpt.latest_step(tc.ckpt_dir)
        if latest is not None:
            restored = ckpt.restore(tc.ckpt_dir, latest,
                                    {"params": params, "opt": state.opt})
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(restored["params"][name])
            state.opt = restored["opt"]
            state.step = latest
            del restored

    ewma_t, ewma_loss = None, None
    first_step = state.step       # the first iteration warms up: no EWMA
    while state.step < tc.steps:
        t0 = time.perf_counter()  # the whole iteration: data and step
        gen = _step_generator(tc.seed, state.step)
        batch = make_token_batch(gen, tc.batch, tc.seq_len, api.cfg.vocab,
                                 device=dev)
        if extra_batch is not None:
            batch.update(extra_batch(gen))
        model.zero_grad(set_to_none=True)
        loss = loss_fn(api, model, batch)
        loss.backward()
        loss = float(loss.detach())
        dt = time.perf_counter() - t0

        if ewma_t is not None and dt > tc.straggler_factor * ewma_t:
            state.stragglers += 1
            if on_straggler:
                on_straggler(state.step, dt)
        elif state.step > first_step:
            ewma_t = dt if ewma_t is None else 0.9 * ewma_t + 0.1 * dt

        spike = not math.isfinite(loss) or (
            ewma_loss is not None and loss > tc.spike_factor *
            max(ewma_loss, 1e-6))
        if spike:
            state.skipped += 1          # reject the update, keep going
        else:
            _, state.opt = optimizer.update(_grads(params), state.opt,
                                            params, lr=tc.lr)
            ewma_loss = loss if ewma_loss is None else \
                0.9 * ewma_loss + 0.1 * loss
            state.losses.append(loss)
        model.zero_grad(set_to_none=True)
        state.step += 1

        if tc.ckpt_every and state.step % tc.ckpt_every == 0:
            ckpt.save(tc.ckpt_dir, state.step,
                      {"params": params, "opt": state.opt})
    return state
