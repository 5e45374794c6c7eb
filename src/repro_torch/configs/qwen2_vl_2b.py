"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (backbone only; patch
embeddings stubbed via input_specs).  [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, qkv_bias=True, rope_style="mrope", rope_theta=1e6,
    tie_embeddings=True, frontend_stub=True,
)
