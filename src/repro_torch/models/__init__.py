from repro_torch.models.model import ModelApi, build, cross_entropy

__all__ = ["ModelApi", "build", "cross_entropy"]
