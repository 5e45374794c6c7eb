"""mixtral-8x22b [moe] — 8 experts top-2.  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, rope_theta=1e6, n_experts=8, moe_top_k=2,
)
