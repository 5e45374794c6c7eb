"""whisper-medium [audio] — enc-dec, conv frontend stubbed (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, rope_style="none", enc_dec=True, n_enc_layers=24,
    enc_frames=1500, frontend_stub=True,
)
