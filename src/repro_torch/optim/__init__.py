from repro_torch.optim import adafactor, adamw, schedules
from repro_torch.optim.adafactor import AdafactorConfig
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adafactor", "adamw", "schedules", "AdafactorConfig",
           "AdamWConfig"]
