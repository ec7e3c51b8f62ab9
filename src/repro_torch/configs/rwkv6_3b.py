"""rwkv6-3b "Finch" [ssm]: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536, data-dependent decay, matrix-valued per-head state.
[arXiv:2404.05892]

Time-mix state is per-64-dim head (40 heads; not TP-divisible) ->
head_tp=False: time-mix replicated over `model`, channel-mix TP.
"""

from repro_torch.configs.base import (BlockCfg, FFNCfg, ModelConfig, RWKVCfg,
                                      ShardingOverrides)


def config() -> ModelConfig:
    block = BlockCfg(
        kind="rwkv",
        rwkv=RWKVCfg(head_dim=64, decay_lora=64, mix_lora=32),
        ffn=FFNCfg(d_ff=8960, activation="relu2"),
    )
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        d_model=2560,
        vocab=65_536,
        pattern=(block,),
        n_units=32,
        sharding=ShardingOverrides(head_tp=False),
    )
