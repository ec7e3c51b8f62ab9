from repro_torch.models.model import ModelApi, build

__all__ = ["ModelApi", "build"]
