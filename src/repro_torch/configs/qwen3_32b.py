"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, per-head q/k RMSNorm, head_dim=128 (q-proj 8192 != d_model).
[hf:Qwen/Qwen3; hf]"""

from repro_torch.configs.base import AttnCfg, BlockCfg, FFNCfg, ModelConfig


def config() -> ModelConfig:
    block = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=64, n_kv=8, head_dim=128, qk_norm=True,
                     rope_theta=1_000_000.0),
        ffn=FFNCfg(d_ff=25600, activation="swiglu"),
    )
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        d_model=5120,
        vocab=151_936,
        pattern=(block,),
        n_units=64,
    )
