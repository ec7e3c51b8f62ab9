"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, alternating local(SWA 4096)/global attention, attn softcap 50,
final-logit softcap 30, GeGLU, sandwich norms, head_dim=256, sqrt(d) embed
scaling.  [arXiv:2408.00118]"""

from repro_torch.configs.base import AttnCfg, BlockCfg, FFNCfg, ModelConfig


def config() -> ModelConfig:
    local = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=16, n_kv=8, head_dim=256, window=4096,
                     attn_softcap=50.0),
        ffn=FFNCfg(d_ff=14336, activation="geglu"),
        sandwich_norm=True,
    )
    glob = BlockCfg(
        kind="attn",
        attn=AttnCfg(n_q=16, n_kv=8, head_dim=256, attn_softcap=50.0),
        ffn=FFNCfg(d_ff=14336, activation="geglu"),
        sandwich_norm=True,
    )
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        d_model=3584,
        vocab=256_000,
        pattern=(local, glob),  # alternating SWA / global
        n_units=21,             # 42 layers
        tie_embeddings=True,
        logit_softcap=30.0,
        embed_scale=True,
    )
