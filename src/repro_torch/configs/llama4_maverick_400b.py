"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + shared expert, alternating
dense/MoE layers (Maverick interleave).  [hf:meta-llama/Llama-4; unverified]

40 q-heads do not divide the 16-way model axis -> head_tp=False (attention
replicated over `model`, weights FSDP over `data`; see DESIGN.md §4).
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, FFNCfg, ModelConfig,
                                MoECfg, ShardingOverrides)

D = 5120


def config() -> ModelConfig:
    attn = AttnCfg(n_q=40, n_kv=8, head_dim=128, rope_theta=500_000.0)
    dense = BlockCfg(kind="attn", attn=attn,
                     ffn=FFNCfg(d_ff=8192, activation="swiglu"))
    moe = BlockCfg(kind="attn", attn=attn,
                   ffn=FFNCfg(d_ff=8192, activation="swiglu",
                              moe=MoECfg(n_experts=128, top_k=1,
                                         d_ff_expert=8192,
                                         shared_expert_dff=8192)))
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        d_model=D,
        vocab=202_048,
        pattern=(dense, moe),   # alternating dense / MoE
        n_units=24,             # 48 layers
        sharding=ShardingOverrides(head_tp=False, expert_parallel=True),
    )
