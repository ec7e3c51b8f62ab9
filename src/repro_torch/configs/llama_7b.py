"""llama-7b — the paper's own base-model family (QLoRA experiments, §3.1):
32L d_model=4096 32H MHA d_ff=11008 vocab=32000.  [arXiv:2302.13971]"""

from repro_torch.configs.base import AttnCfg, BlockCfg, FFNCfg, ModelConfig


def config() -> ModelConfig:
    block = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=32, n_kv=32, head_dim=128),
        ffn=FFNCfg(d_ff=11008, activation="swiglu"),
    )
    return ModelConfig(
        name="llama-7b",
        family="dense",
        d_model=4096,
        vocab=32_000,
        pattern=(block,),
        n_units=32,
    )
