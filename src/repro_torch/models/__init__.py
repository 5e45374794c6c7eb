from repro_torch.models.model_zoo import ModelApi, build_model, loss_fn

__all__ = ["ModelApi", "build_model", "loss_fn"]
