"""xlstm-1.3b [ssm] — mLSTM blocks with periodic sLSTM (xLSTM[7:1]).
d_ff=0: blocks carry their own up/down projections.  [arXiv:2405.04517]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, rope_style="none", slstm_every=8, ssm_state=1,
)
