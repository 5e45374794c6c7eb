"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-*; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab=262144, head_dim=256, rope_theta=1e6, tie_embeddings=True,
    sliding_window=1024, local_global_ratio=5,
)
