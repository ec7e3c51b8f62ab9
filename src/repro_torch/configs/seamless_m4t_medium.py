"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096 vocab=256206.  The audio
frontend is a STUB: input_specs() supplies precomputed frame embeddings.
[arXiv:2308.11596]"""

from repro_torch.configs.base import (AttnCfg, BlockCfg, FFNCfg, FrontendCfg,
                                      ModelConfig)


def config() -> ModelConfig:
    dec = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=16, n_kv=16, head_dim=64, causal=True),
        ffn=FFNCfg(d_ff=4096, activation="swiglu"),
    )
    enc = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=16, n_kv=16, head_dim=64, causal=False),
        ffn=FFNCfg(d_ff=4096, activation="swiglu"),
    )
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        d_model=1024,
        vocab=256_206,
        pattern=(dec,),
        n_units=12,
        enc_pattern=(enc,),
        enc_n_units=12,
        cross_attn=True,
        frontend=FrontendCfg(kind="audio", n_tokens=1024, embed_dim=1024),
    )
