"""Serving launcher: batched decode with optional FaTRQ-RAG retrieval, on
the reduced configuration of ``--arch`` (any of the ten; an
encoder-decoder first encodes seeded random frames into its cache).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --batch 4 --steps 16 [--rag] [--device cpu]

Runs on the GPU unless ``--device`` names another device; with no GPU and
no ``--device`` it fails.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Engine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, or fail)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    api = build_model(cfg)
    model = api.init(torch.Generator(device=dev).manual_seed(0))
    engine = Engine(api, model, batch=args.batch, max_len=args.max_len)
    if cfg.enc_dec:
        frames = torch.randn((args.batch, cfg.enc_frames, cfg.d_model),
                             generator=torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
        engine.prefill({"frames": frames})

    seed = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    engine.decode(seed, args.steps)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"decoded {args.batch}×{args.steps} tokens on {dev} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")

    if args.rag:
        from repro_torch.anns import PipelineConfig, build
        from repro_torch.data import make_dataset
        from repro_torch.serving import rag_answer
        ds = make_dataset(n=8_000, d=cfg.d_model, n_queries=4,
                          generator=torch.Generator(device=dev)
                          .manual_seed(2))
        index = build(ds.x, PipelineConfig(dim=cfg.d_model, pq_m=16,
                                           pq_k=64, nlist=32, nprobe=8,
                                           final_k=5, refine_budget=20),
                      device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))

        def embed_fn(tokens):
            e = model.embed_tokens(tokens).mean(dim=1)
            return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

        prompts = torch.randint(0, cfg.vocab, (args.batch, 8),
                                generator=torch.Generator(device=dev)
                                .manual_seed(4), device=dev)
        with torch.no_grad():
            res = rag_answer(engine, index, embed_fn, prompts)
        print(f"RAG: retrieved {res.ids.shape[1]} docs/request; "
              f"retrieval {res.cost.total_seconds() / args.batch * 1e6:.0f}"
              f"us/query (modeled); degraded={res.degraded}")


if __name__ == "__main__":
    main()
