"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias, tied embeddings.  [hf:Qwen/Qwen2.5; hf]"""

from repro_torch.configs.base import AttnCfg, BlockCfg, FFNCfg, ModelConfig


def config() -> ModelConfig:
    block = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=16, n_kv=2, head_dim=128, qkv_bias=True,
                     rope_theta=1_000_000.0),
        ffn=FFNCfg(d_ff=11008, activation="swiglu"),
    )
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        d_model=2048,
        vocab=151_936,
        pattern=(block,),
        n_units=36,
        tie_embeddings=True,
    )
