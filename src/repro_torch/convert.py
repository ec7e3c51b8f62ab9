"""Carry weights and packed experts across from the JAX package.

The port's ``init_params`` draws from a torch generator and cannot
reproduce JAX's threefry draws, so anything that compares the two packages
converts the reference's arrays instead.  Inputs are duck-typed (numpy
arrays, or anything ``np.asarray`` accepts, in nested dicts), so this
module imports neither JAX nor the JAX package.  Like every entry point of
the port, the converters place their tensors on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy (or array-like) -> torch tensor with the same dtype and bits.

    bf16 arrive as ``ml_dtypes.bfloat16``, which torch cannot read; they
    go through their 16-bit patterns.  uint32 words (bit planes) become
    int32 with the same bits.
    """
    device = resolve_device(device)
    a = np.asarray(a)
    shape = a.shape               # ascontiguousarray makes a 0-d array 1-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).reshape(shape).to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).reshape(
        shape).to(device)


def params_from_jax(tree, device="cuda"):
    """Nested dict of arrays (a JAX param tree) -> nested dict of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def torch_dtype_of(dtype) -> torch.dtype:
    name = np.dtype(dtype).name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def packed_from_jax(tree, device="cuda"):
    """A tree of the JAX package's ``PackedTernary`` (anything with
    ``pos``/``neg``/``scale``/``shape``/``orig_dtype``) -> the port's."""
    from repro_torch.core.packing import PackedTernary
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: packed_from_jax(v, device) for k, v in tree.items()}
    return PackedTernary(
        pos=tensor_from_numpy(tree.pos, device),
        neg=tensor_from_numpy(tree.neg, device),
        scale=tensor_from_numpy(np.asarray(tree.scale, np.float32), device),
        shape=tuple(tree.shape), orig_dtype=torch_dtype_of(tree.orig_dtype))
