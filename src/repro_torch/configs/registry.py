"""Architecture registry of the PyTorch port: maps --arch ids to configs.

A copy of the JAX package's registry, cut to the architectures the port
serves so far.  The config modules themselves are copies too, so the port
never imports the JAX package.
"""

from __future__ import annotations

import importlib

ARCHS = ("qwen2_5_3b", "gemma2_9b", "llama_7b")

_ALIASES = {"qwen2.5-3b": "qwen2_5_3b", "gemma2-9b": "gemma2_9b",
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
