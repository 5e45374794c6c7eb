"""Train a ~100M-param LM for a few hundred steps with the fault-tolerant
loop (checkpoint/resume + straggler accounting), on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \\
        [--device cpu]

The counterpart of ``examples/train_lm.py``: the same configuration, steps
and printed lines, through ``repro_torch``.  It runs on the GPU unless
``--device`` names another device, and fails with no GPU.  The weights
and batches come from ``torch.Generator``s where the JAX example uses
``jax.random`` keys, so the losses printed differ from the JAX example's.
``--layers``, ``--batch`` and ``--seq`` cut the model and the batch for a
run on the host; their defaults are the JAX example's.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, or fail)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M config: scale the reduced family up
    cfg = dataclasses.replace(
        ARCHS[args.arch].reduced(), n_layers=args.layers, d_model=512,
        n_heads=8, n_kv_heads=4, head_dim=64, d_ff=2048, vocab=8192)
    api = build_model(cfg)
    print(f"arch={cfg.name} params≈{cfg.params_count() / 1e6:.0f}M")

    tc = TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                     lr=3e-4, ckpt_every=100, ckpt_dir=args.ckpt_dir)
    state = train(api, tc, resume=True, device=dev)
    if state.losses:
        print(f"step={state.step} loss: first={state.losses[0]:.3f} "
              f"last={state.losses[-1]:.3f} stragglers={state.stragglers} "
              f"skipped={state.skipped}")
    else:
        print(f"step={state.step} (resumed past --steps; no new steps run)")
    return state


if __name__ == "__main__":
    main()
