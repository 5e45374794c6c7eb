from repro_torch.models.model_zoo import ModelApi, build_model

__all__ = ["ModelApi", "build_model"]
