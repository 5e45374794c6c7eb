"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, ssm_state=64, ssm_head_dim=64, attn_every=6,
)
