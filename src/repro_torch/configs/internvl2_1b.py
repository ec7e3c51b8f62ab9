"""internvl2-1b [vlm]: InternViT frontend (STUB: precomputed patch
embeddings) + Qwen2-0.5B-like backbone: 24L d_model=896 14H (GQA kv=2)
d_ff=4864 vocab=151655.  [arXiv:2404.16821]

14 heads do not divide the 16-way model axis -> head_tp=False.
"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, FFNCfg, FrontendCfg,
                                      ModelConfig, ShardingOverrides)


def config() -> ModelConfig:
    block = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=14, n_kv=2, head_dim=64, qkv_bias=True,
                     rope_theta=1_000_000.0),
        ffn=FFNCfg(d_ff=4864, activation="swiglu"),
    )
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        d_model=896,
        vocab=151_655,
        pattern=(block,),
        n_units=24,
        tie_embeddings=True,
        frontend=FrontendCfg(kind="vision", n_tokens=256, embed_dim=1024),
        sharding=ShardingOverrides(head_tp=False),
    )
