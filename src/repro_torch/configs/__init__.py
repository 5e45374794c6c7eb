"""Registry of the 10 architectures (`ARCHS`, by name) and the shape
cells (`SHAPES`)."""

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, \
    shape_applicable
from repro_torch.configs.gemma3_4b import CONFIG as gemma3_4b
from repro_torch.configs.mixtral_8x22b import CONFIG as mixtral_8x22b
from repro_torch.configs.phi3_5_moe import CONFIG as phi3_5_moe
from repro_torch.configs.qwen1_5_4b import CONFIG as qwen1_5_4b
from repro_torch.configs.qwen2_5_3b import CONFIG as qwen2_5_3b
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.qwen2_vl_2b import CONFIG as qwen2_vl_2b
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.xlstm_1_3b import CONFIG as xlstm_1_3b
from repro_torch.configs.zamba2_1_2b import CONFIG as zamba2_1_2b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    qwen2_vl_2b, qwen2_72b, qwen2_5_3b, qwen1_5_4b, gemma3_4b,
    mixtral_8x22b, phi3_5_moe, zamba2_1_2b, whisper_medium, xlstm_1_3b,
]}

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig",
           "shape_applicable"]
