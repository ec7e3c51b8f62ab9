"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]

8 experts < 16 model shards -> expert-internal TP (shard each expert's
d_ff 16-way) instead of expert parallelism.
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, FFNCfg, ModelConfig,
                                MoECfg, ShardingOverrides)


def config() -> ModelConfig:
    block = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=32, n_kv=8, head_dim=128, window=4096,
                     rope_theta=1_000_000.0),
        ffn=FFNCfg(d_ff=14336, activation="swiglu",
                   moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=14336)),
    )
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        d_model=4096,
        vocab=32_000,
        pattern=(block,),
        n_units=32,
        sharding=ShardingOverrides(head_tp=True, expert_parallel=False),
    )
