"""Architecture registry of the PyTorch port: maps --arch ids to configs.

A copy of the JAX package's registry: the dense configs, served on the
zero-merge overlay; the MoE, recurrent (rwkv6, jamba's mamba), enc-dec
(seamless) and frontend (internvl2) configs, served by merge-on-swap.
The config modules themselves are copies too, so the port never imports
the JAX package.
"""

from __future__ import annotations

import importlib

ARCHS = ("llama4_maverick_400b", "mixtral_8x7b", "qwen2_5_3b", "qwen3_32b",
         "qwen1_5_110b", "gemma2_9b", "internvl2_1b",
         "jamba_1_5_large_398b", "rwkv6_3b", "seamless_m4t_medium",
         "llama_7b")

_ALIASES = {"llama4-maverick-400b-a17b": "llama4_maverick_400b",
            "mixtral-8x7b": "mixtral_8x7b", "qwen2.5-3b": "qwen2_5_3b",
            "qwen3-32b": "qwen3_32b", "qwen1.5-110b": "qwen1_5_110b",
            "gemma2-9b": "gemma2_9b", "internvl2-1b": "internvl2_1b",
            "jamba-1.5-large-398b": "jamba_1_5_large_398b",
            "rwkv6-3b": "rwkv6_3b",
            "seamless-m4t-medium": "seamless_m4t_medium",
            "llama-7b": "llama_7b"}


def normalize(arch: str) -> str:
    a = arch.replace("-", "_").replace(".", "_")
    return _ALIASES.get(arch, a if a in ARCHS else _ALIASES.get(a, a))


def get_config(arch: str):
    name = normalize(arch)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.config()


def get_smoke_config(arch: str, **kw):
    from repro_torch.configs.base import reduce_for_smoke
    return reduce_for_smoke(get_config(arch), **kw)
