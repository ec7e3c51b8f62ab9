from repro_torch.configs.base import (AttnCfg, BlockCfg, FFNCfg, FrontendCfg,
                                      MambaCfg, ModelConfig, MoECfg, RWKVCfg,
                                      ShardingOverrides, reduce_for_smoke)
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config

__all__ = ["AttnCfg", "BlockCfg", "FFNCfg", "FrontendCfg", "MambaCfg",
           "ModelConfig", "MoECfg", "RWKVCfg", "ShardingOverrides",
           "reduce_for_smoke", "ARCHS", "get_config", "get_smoke_config"]
