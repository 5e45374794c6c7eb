"""End-to-end RAG serving (paper Fig. 1) on the PyTorch/CUDA port: a
small LM answers batched requests with FaTRQ retrieval in the loop,
through the unified ``Database`` API — the caller's ``QueryPlan``
(backend, shards, budget) threads all the way into the retriever.

    PYTHONPATH=src python examples/rag_serving_torch.py [--device cpu]

The counterpart of ``examples/rag_serving.py``: the same configuration,
steps and printed lines, through ``repro_torch``.  It runs on the GPU unless
``--device`` names another device, and fails with no GPU.  Each
``jax.random.PRNGKey(s)`` of the JAX example is a ``torch.Generator``
seeded ``s`` on the run's device here, so the weights, the data, and the
ids and tokens printed differ from the JAX example's.
"""

import argparse

import torch

from repro_torch.anns import Database, PipelineConfig, QueryPlan
from repro_torch.configs import ARCHS
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.obs import trace
from repro_torch.serving import Engine, Retriever, rag_answer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, or fail)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    # --- LM: reduced qwen2.5 backbone, batched decode
    cfg = ARCHS["qwen2.5-3b"].reduced()
    api = build_model(cfg)
    model = api.init(gen(0))
    engine = Engine(api, model, batch=4, max_len=64)

    # --- retriever: FaTRQ database over the document embedding store;
    # embedding dim = the backbone's hidden size
    d = cfg.d_model
    ds = make_dataset(n=8_000, d=d, n_queries=4, generator=gen(1))
    pcfg = PipelineConfig(dim=d, pq_m=16, pq_k=64, nlist=32, nprobe=8,
                          final_k=5, refine_budget=20)
    db = Database.build(ds.x, pcfg, device=dev, generator=gen(2))

    # the serving plan: validated once against the capability registry,
    # compiled once into a cached executor, reused every request
    plan = QueryPlan(front="ivf", backend="reference", micro_batch=4)
    retriever = Retriever(index=db, plan=plan)

    # embed_fn stub: mean-pool the LM's token embeddings, project to store
    def embed_fn(tokens):
        e = model.embed_tokens(tokens).mean(dim=1)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    prompts = torch.randint(0, cfg.vocab, (4, 8), generator=gen(3),
                            device=dev)
    print("serving 4 batched RAG requests...")
    tracer = trace.Tracer()
    with trace.use(tracer), torch.no_grad():
        res = rag_answer(engine, db.index, embed_fn, prompts,
                         k=5, decode_steps=8, retriever=retriever)
    print(f"  resolved plan: {retriever.default_plan().resolve(db.index)}")
    print(f"  retrieved ids (per request): {res.ids.tolist()}")
    print(f"  generated tokens: {res.tokens.tolist()}")
    print(f"  degraded by QoS: {res.degraded}")
    print(f"  retrieval cost breakdown: "
          f"{ {k: f'{v * 1e6:.1f}us' for k, v in res.cost.breakdown().items()} }")
    print(f"  running ledger (capacity view): "
          f"{ {k: t.accesses for k, t in retriever.total_cost.ledger.items()} }")
    print(f"  engine stats: {engine.stats}")

    # --- per-stage latency breakdown from the trace the retrieval just
    # produced: wall time (this host, measured) next to the QueryCost
    # Table-I modeled time, and their ratio.
    print("per-stage latency breakdown (traced):")
    for stage in ("front", "refine", "rerank"):
        spans = tracer.by_name(stage)
        if not spans:
            continue
        wall_ms = sum(s.wall_end_s - s.wall_start_s for s in spans) * 1e3
        modeled = [s.attrs["model_s"] for s in spans if "model_s" in s.attrs]
        model_ms = sum(modeled) * 1e3 if modeled else float("nan")
        drift = wall_ms / model_ms if model_ms else float("nan")
        print(f"  {stage:>7}: wall {wall_ms:8.3f} ms | "
              f"modeled {model_ms:8.3f} ms | wall/model {drift:8.1f}x "
              f"({len(spans)} span(s))")
    return {"db": db, "embed_fn": embed_fn, "prompts": prompts,
            "plan": plan, "result": res}


if __name__ == "__main__":
    main()
