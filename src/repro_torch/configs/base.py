"""Config dataclasses for the architecture zoo.

A model is a stack of ``n_units`` repetitions of a *pattern* — a short list of
heterogeneous blocks (attention / mamba / rwkv, each with a dense-or-MoE FFN).
``lax.scan`` runs over the unit axis, so HLO size is O(len(pattern)), not
O(n_layers) — essential for compiling 80-layer/400B configs in the dry-run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    shared_expert_dff: Optional[int] = None  # llama4 always-on shared expert


@dataclasses.dataclass(frozen=True)
class FFNCfg:
    d_ff: int
    activation: str = "swiglu"  # swiglu | geglu | relu2
    moe: Optional[MoECfg] = None


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_q: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None   # gemma2: 50.0
    window: Optional[int] = None           # sliding-window size; None = global
    rope_theta: float = 10_000.0
    causal: bool = True                    # False for encoder blocks


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64   # rank of the data-dependent decay adapter
    mix_lora: int = 32     # rank of the ddlerp token-shift adapters


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str                       # attn | mamba | rwkv
    ffn: Optional[FFNCfg] = None    # None => block has no FFN (rwkv has its own)
    attn: Optional[AttnCfg] = None
    mamba: Optional[MambaCfg] = None
    rwkv: Optional[RWKVCfg] = None
    sandwich_norm: bool = False     # gemma2 post-norms


@dataclasses.dataclass(frozen=True)
class FrontendCfg:
    """Modality frontend STUB: precomputed embeddings supplied by input_specs."""
    kind: str            # "vision" | "audio"
    n_tokens: int        # patches / frames per example
    embed_dim: int       # dimension of the precomputed embeddings


@dataclasses.dataclass(frozen=True)
class ShardingOverrides:
    """Per-arch deviations from the default logical->mesh rules."""
    head_tp: bool = True        # False: replicate attention over 'model' (llama4, internvl2)
    expert_parallel: bool = True  # False: TP inside experts instead (mixtral)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    vocab: int
    pattern: Sequence[BlockCfg]
    n_units: int
    # encoder (enc-dec archs only)
    enc_pattern: Sequence[BlockCfg] = ()
    enc_n_units: int = 0
    cross_attn: bool = False
    # embeddings / head
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None   # gemma2: 30.0
    embed_scale: bool = False               # gemma-style sqrt(d) embed scaling
    # modality stub
    frontend: Optional[FrontendCfg] = None
    # norms
    rms_eps: float = 1e-6
    # sharding
    sharding: ShardingOverrides = ShardingOverrides()
    # dtype
    dtype: str = "bfloat16"

    @property
    def n_layers(self) -> int:
        return self.n_units * len(self.pattern) + self.enc_n_units * len(self.enc_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS=6ND)."""
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)

        def block_params(b: BlockCfg) -> int:
            p = 2 * d  # pre-norms (attn/ffn)
            if b.sandwich_norm:
                p += 2 * d
            if b.kind == "attn":
                a = b.attn
                p += d * a.n_q * a.head_dim * 2          # wq, wo
                p += d * a.n_kv * a.head_dim * 2          # wk, wv
                if a.qkv_bias:
                    p += (a.n_q + 2 * a.n_kv) * a.head_dim
                if a.qk_norm:
                    p += 2 * a.head_dim
            elif b.kind == "mamba":
                m = b.mamba
                d_in = m.expand * d
                dt_rank = m.dt_rank or -(-d // 16)
                p += d * 2 * d_in                         # in_proj
                p += m.d_conv * d_in + d_in               # conv + bias
                p += d_in * (dt_rank + 2 * m.d_state)     # x_proj
                p += dt_rank * d_in + d_in                # dt_proj
                p += d_in * m.d_state + d_in              # A_log, D
                p += d_in * d                             # out_proj
            elif b.kind == "rwkv":
                r = b.rwkv
                p += 5 * d * d                            # r,k,v,g,o  (time mix)
                p += 2 * d * r.decay_lora                 # decay adapter
                p += 6 * (d * r.mix_lora * 2 + d)         # ddlerp adapters + mus
                p += d                                    # u bonus
                p += 2 * d                                # ln_x
            if b.ffn is not None:
                f = b.ffn
                if f.moe is not None:
                    mo = f.moe
                    p += d * mo.n_experts                     # router
                    p += mo.n_experts * 3 * d * mo.d_ff_expert
                    if mo.shared_expert_dff:
                        p += 3 * d * mo.shared_expert_dff
                else:
                    n_mats = 3 if f.activation in ("swiglu", "geglu") else 2
                    p += n_mats * d * f.d_ff
            if self.cross_attn and b.kind == "attn" and b.attn.causal:
                a = b.attn
                p += d  # cross pre-norm
                p += d * a.n_q * a.head_dim * 2 + d * a.n_kv * a.head_dim * 2
            return p

        for b in self.pattern:
            total += self.n_units * block_params(b)
        for b in self.enc_pattern:
            total += self.enc_n_units * block_params(b)
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        full = self.param_count()
        # subtract inactive expert mass
        inactive = 0
        for b in self.pattern:
            if b.ffn is not None and b.ffn.moe is not None:
                mo = b.ffn.moe
                per_expert = 3 * d * mo.d_ff_expert
                inactive += self.n_units * (mo.n_experts - mo.top_k) * per_expert
        return int(full - inactive)


def reduce_for_smoke(cfg: ModelConfig, d_model: int = 64, n_units: int = 2,
                     vocab: int = 512) -> ModelConfig:
    """Shrink any config to CPU-smoke-test size, preserving its *family
    structure* (same pattern kinds, MoE top-k, qk_norm, softcaps...)."""
    scale = d_model / cfg.d_model

    def shrink_block(b: BlockCfg) -> BlockCfg:
        attn = None
        if b.attn is not None:
            attn = dataclasses.replace(
                b.attn,
                n_q=max(2, min(4, b.attn.n_q)),
                n_kv=max(1, min(2, b.attn.n_kv)),
                head_dim=16,
                window=min(b.attn.window, 32) if b.attn.window else None,
            )
        ffn = None
        if b.ffn is not None:
            moe = None
            if b.ffn.moe is not None:
                moe = dataclasses.replace(
                    b.ffn.moe,
                    n_experts=min(4, b.ffn.moe.n_experts),
                    d_ff_expert=128,
                    shared_expert_dff=(128 if b.ffn.moe.shared_expert_dff else None),
                )
            ffn = dataclasses.replace(b.ffn, d_ff=128, moe=moe)
        mamba = dataclasses.replace(b.mamba, d_state=8, dt_rank=8) if b.mamba else None
        rwkv = dataclasses.replace(b.rwkv, head_dim=16, decay_lora=8,
                                   mix_lora=8) if b.rwkv else None
        return dataclasses.replace(b, attn=attn, ffn=ffn, mamba=mamba, rwkv=rwkv)

    frontend = None
    if cfg.frontend is not None:
        frontend = dataclasses.replace(cfg.frontend, n_tokens=8,
                                       embed_dim=d_model)
    return dataclasses.replace(
        cfg,
        d_model=d_model,
        vocab=vocab,
        pattern=tuple(shrink_block(b) for b in cfg.pattern),
        n_units=n_units,
        enc_pattern=tuple(shrink_block(b) for b in cfg.enc_pattern),
        enc_n_units=min(cfg.enc_n_units, n_units),
        frontend=frontend,
        dtype="float32",
    )
