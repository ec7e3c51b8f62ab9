"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, attn:mamba 1:7 interleave, MoE 16 experts top-2 every other
layer.  [arXiv:2403.19887]

Pattern unit = 8 blocks (1 attn + 7 mamba), FFNs alternate dense/MoE within
the unit; 72 layers = 9 units.
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, FFNCfg, MambaCfg,
                                      ModelConfig, MoECfg)


def config() -> ModelConfig:
    attn = AttnCfg(n_q=64, n_kv=8, head_dim=128)
    mamba = MambaCfg(d_state=16, d_conv=4, expand=2)
    dense_ffn = FFNCfg(d_ff=24576, activation="swiglu")
    moe_ffn = FFNCfg(d_ff=24576, activation="swiglu",
                     moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24576))

    pattern = []
    for i in range(8):
        ffn = moe_ffn if i % 2 == 1 else dense_ffn
        if i == 0:
            pattern.append(BlockCfg(kind="attn", attn=attn, ffn=ffn))
        else:
            pattern.append(BlockCfg(kind="mamba", mamba=mamba, ffn=ffn))
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        d_model=8192,
        vocab=65_536,
        pattern=tuple(pattern),
        n_units=9,  # 72 layers
    )
