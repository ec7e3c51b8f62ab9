from repro_torch.serve.decode_loop import PAD_TOKEN, SamplingConfig
from repro_torch.serve.engine import (DONE, FAILED, PENDING, EngineConfig,
                                      Request, ServeEngine)
from repro_torch.serve.expert_cache import (BASE, DeviceCache,
                                            ExpertRegistry, ExpertStore,
                                            SwapStats)

__all__ = ["PAD_TOKEN", "SamplingConfig", "DONE", "FAILED", "PENDING",
           "EngineConfig", "Request", "ServeEngine", "BASE", "DeviceCache",
           "ExpertRegistry", "ExpertStore", "SwapStats"]
