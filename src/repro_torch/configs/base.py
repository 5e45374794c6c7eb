"""Architecture config schema for the 10 architectures the repo runs
(the port's own copy of the JAX package's schema).

Every field is plain data (frozen and hashable).  ``reduced()`` returns
the smoke-test configuration of the same family (few layers, narrow
width, few experts, small vocab).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    rope_style: str = "rope"       # rope | mrope | none
    # sliding-window / local-global attention (gemma3, mixtral)
    sliding_window: int = 0        # 0 → full attention
    local_global_ratio: int = 0    # gemma3: 5 local per 1 global
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_every: int = 0            # zamba2: shared attn block period
    slstm_every: int = 0           # xlstm: sLSTM block period (else mLSTM)
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # modality frontend stub (vlm / audio): inputs may be embeddings
    frontend_stub: bool = False
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (no full-attention layer over the full seq)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs have an autoregressive decoder

    def reduced(self) -> "ArchConfig":
        """Smoke-test config: same family/topology, tiny dims."""
        return replace(
            self,
            n_layers=5 if self.attn_every else 4,   # zamba: 2 groups + tail
            slstm_every=2 if self.slstm_every else 0,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            head_dim=32,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window
            else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            enc_frames=32 if self.enc_dec else self.enc_frames,
        )

    def params_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        h, kv = self.n_heads, self.n_kv_heads
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * f
        elif f:
            ffn = 3 * d * f
        else:
            ffn = 0
        if self.ssm_state:
            d_inner = 2 * d
            ssm = d * (2 * d_inner + 2 * self.ssm_state) + d_inner * d
            if self.family == "ssm":
                # xlstm: blocks have their own up/down projections
                ssm = 6 * d * d
            core = ssm
            total_core = self.n_layers * core + (attn + 3 * d * (2 * d)) * (
                1 if self.attn_every else 0)
        else:
            total_core = self.n_layers * (attn + ffn)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        enc = self.n_enc_layers * (attn + ffn) if self.enc_dec else 0
        # decoder cross-attn
        if self.enc_dec:
            total_core += self.n_layers * attn
        return total_core + emb + enc

    def active_params_count(self) -> int:
        """N_active for MoE (top-k experts instead of all)."""
        if not self.is_moe:
            return self.params_count()
        d, f = self.d_model, self.d_ff
        full = self.params_count()
        return full - self.n_layers * (self.n_experts - self.moe_top_k) \
            * 3 * d * f


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable?, reason-if-not) per assignment rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (f"{cfg.name} has full-attention layers — quadratic at "
                       "524288; skipped per spec (sub-quadratic archs only)")
    return True, ""
