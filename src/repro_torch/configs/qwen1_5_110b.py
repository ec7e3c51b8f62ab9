"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5; hf]"""

from repro_torch.configs.base import AttnCfg, BlockCfg, FFNCfg, ModelConfig


def config() -> ModelConfig:
    block = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=64, n_kv=8, head_dim=128, qkv_bias=True,
                     rope_theta=1_000_000.0),
        ffn=FFNCfg(d_ff=49152, activation="swiglu"),
    )
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        d_model=8192,
        vocab=152_064,
        pattern=(block,),
        n_units=80,
    )
