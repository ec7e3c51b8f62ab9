"""The inputs both sides get: base weights and fine-tunes from the seed.

The benchmark makes them itself, on the card, one generator call a leaf,
in the type they are served in, laid out as the program's parameter tree
(paths and shapes from the configuration's sizes).  The reference
regenerates any leaf alone (:func:`base_leaf`, :func:`finetune_leaf`), so
it never reads what the program holds.  Only ``torch`` and ``numpy`` are
imported here.
"""

from __future__ import annotations

import numpy as np
import torch

FT_SCALE = 0.01          # a fine-tune's noise, added to every leaf


def leaf_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for one leaf of one tree."""
    words = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags]) \
        .generate_state(2, np.uint32)
    return int((int(words[0]) << 31) ^ int(words[1])) & (2 ** 63 - 1)


def _gen(dev, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(leaf_seed(seed, *tags))


def layout(cfg: dict) -> list:
    """[(path, shape, dtype name, kind, fan-in)] of the parameter tree, in
    a fixed order (the leaf index is the position here).  ``kind``:
    "embed", "matrix", "norm" or "bias"."""
    d, V, U = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    dt = cfg["torch_dtype"]
    out = [("embed", (V, d), dt, "embed", d),
           ("final_norm", (d,), dt, "norm", d)]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, V), dt, "matrix", d))
    b = "blocks/block0"
    out += [(f"{b}/pre_norm", (U, d), dt, "norm", d),
            (f"{b}/attn/wq", (U, d, nq, hd), dt, "matrix", d),
            (f"{b}/attn/wk", (U, d, nkv, hd), dt, "matrix", d),
            (f"{b}/attn/wv", (U, d, nkv, hd), dt, "matrix", d),
            (f"{b}/attn/wo", (U, nq, hd, d), dt, "matrix", nq * hd)]
    if cfg.get("qkv_bias"):
        out += [(f"{b}/attn/bq", (U, nq, hd), dt, "bias", 0),
                (f"{b}/attn/bk", (U, nkv, hd), dt, "bias", 0),
                (f"{b}/attn/bv", (U, nkv, hd), dt, "bias", 0)]
    out.append((f"{b}/ffn_norm", (U, d), dt, "norm", d))
    E = cfg.get("num_local_experts", 0)
    if E:
        f = cfg["intermediate_size"]
        out += [(f"{b}/ffn/router", (U, d, E), "float32", "matrix", d),
                (f"{b}/ffn/wg_e", (U, E, d, f), dt, "matrix", d),
                (f"{b}/ffn/wu_e", (U, E, d, f), dt, "matrix", d),
                (f"{b}/ffn/wo_e", (U, E, f, d), dt, "matrix", f)]
    else:
        f = cfg["intermediate_size"]
        out += [(f"{b}/ffn/wg", (U, d, f), dt, "matrix", d),
                (f"{b}/ffn/wu", (U, d, f), dt, "matrix", d),
                (f"{b}/ffn/wo", (U, f, d), dt, "matrix", f)]
    return out


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def base_leaf(cfg: dict, seed: int, i: int, dev) -> torch.Tensor:
    """Leaf ``i`` of the base: matrices N(0, 1/fan-in), the embedding
    N(0, 0.02^2), norm scales 1 + N(0, 0.05^2), biases N(0, 0.05^2)."""
    _, shape, dt, kind, fan_in = layout(cfg)[i]
    t = torch.randn(shape, generator=_gen(dev, seed, 0, i), device=dev)
    if kind == "matrix":
        t.mul_(1.0 / np.sqrt(fan_in))
    elif kind == "embed":
        t.mul_(0.02)
    elif kind == "norm":
        t.mul_(0.05).add_(1.0)
    else:
        t.mul_(0.05)
    return t.to(_dtype(dt))


def finetune_leaf(base: torch.Tensor, seed: int, expert: int,
                  i: int) -> torch.Tensor:
    """Leaf ``i`` of fine-tune ``expert``: base + FT_SCALE * N(0, 1),
    rounded to the leaf's type."""
    t = torch.randn(base.shape, generator=_gen(base.device, seed, 1 + expert,
                                               i), device=base.device)
    return t.mul_(FT_SCALE).add_(base).to(base.dtype)


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def base_tree(cfg: dict, seed: int, dev) -> dict:
    return unflatten({p: base_leaf(cfg, seed, i, dev)
                      for i, (p, *_) in enumerate(layout(cfg))})


def finetune_tree(cfg: dict, base_flat: dict, seed: int, expert: int) -> dict:
    return unflatten({p: finetune_leaf(base_flat[p], seed, expert, i)
                      for i, (p, *_) in enumerate(layout(cfg))})


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, p))
        else:
            out[p] = v
    return out
