"""Training launcher: the reduced configuration of ``--arch`` unless
``--full``, trained with AdamW, checkpointed every quarter of the run and
resumed from ``--ckpt-dir``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 100 --batch 8 --seq 128 [--full] [--device cpu]

Runs on the GPU unless ``--device`` names another device; with no GPU and
no ``--device`` it fails.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train.loop import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--full", action="store_true",
                    help="full (production) config instead of reduced")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, or fail)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch] if args.full else ARCHS[args.arch].reduced()
    api = build_model(cfg)
    print(f"training {cfg.name} ({'full' if args.full else 'reduced'}) "
          f"≈{cfg.params_count() / 1e6:.0f}M params on {dev}")
    tc = TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                     lr=args.lr, ckpt_every=max(args.steps // 4, 1),
                     ckpt_dir=args.ckpt_dir)
    extra = None
    if cfg.enc_dec:
        def extra(gen):
            """Seeded audio frames for the encoder (the frontend stub)."""
            return {"frames": torch.randn(
                (args.batch, cfg.enc_frames, cfg.d_model),
                generator=gen).to(dev)}
    state = train(api, tc, resume=True, extra_batch=extra, device=dev)
    if state.losses:
        print(f"done: step={state.step} loss {state.losses[0]:.3f} → "
              f"{state.losses[-1]:.3f} (stragglers={state.stragglers}, "
              f"skipped={state.skipped})")
    else:
        print(f"done: step={state.step} (resumed past --steps; no new "
              f"steps run)")


if __name__ == "__main__":
    main()
