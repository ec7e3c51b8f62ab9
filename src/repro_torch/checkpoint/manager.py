"""Checkpointing: exact full checkpoints, and the deprecated expert-delta
shims.

Port of ``repro/checkpoint/manager.py``, writing the same files, so either
package reads the other's checkpoints.  A checkpoint is a directory
``step_XXXXXXXX`` holding ``arrays.npz`` and ``manifest.json``.  Leaves are
stored in :func:`repro_torch.tree.flatten_with_paths` order (JAX's dict
order), each under the key ``a{i}_{sanitised path}``; the manifest records
each leaf's ``path``, ``key``, ``dtype`` and ``shape``, plus ``extra``.
Arrays are logical and on the host, so a checkpoint restores onto any
device.  npz has no bfloat16: bf16 leaves are stored as their ``uint16``
bits with the dtype ``"bfloat16"``, and read back as ``torch.bfloat16``
without ml_dtypes.

The expert-delta shims write Golomb-coded ComPEFT artifacts through
:class:`~repro_torch.expert.Expert`; an ``out_path`` ending in ``.cpft``
writes the checksummed wire blob instead of the npz.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device

_SAN = re.compile(r"[^A-Za-z0-9_]")


def _san(path: str) -> str:
    return _SAN.sub("__", path)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor; bf16 from its ``uint16`` bits."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.asarray(arr, order="C").view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


def save(state: Any, ckpt_dir: str, step: int,
         extra_meta: Optional[dict] = None) -> str:
    """Write an exact checkpoint of the tree ``state``, atomically: into
    ``step_XXXXXXXX.tmp``, then ``os.rename``.  Keeps the last 3 steps.
    Returns the committed directory.

    ``extra_meta`` (JSON-serialisable) rides inside ``manifest.json``,
    under the same rename as the arrays, so a reader never sees one
    without the other (serve snapshots keep their row composition and
    free list there).
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    if extra_meta is not None:
        manifest["extra"] = extra_meta
    arrays = {}
    for i, (ps, leaf) in enumerate(tree_util.flatten_with_paths(state)):
        arr, dt = _to_numpy(leaf)
        key = f"a{i}_{_san(ps)[:80]}"
        arrays[key] = arr
        manifest["leaves"].append({"path": ps, "key": key, "dtype": dt,
                                   "shape": list(arr.shape)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _gc(ckpt_dir, keep=3)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _open(ckpt_dir: str, step: Optional[int]):
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.load(os.path.join(path, "arrays.npz"))


def restore(like: Any, ckpt_dir: str, step: Optional[int] = None,
            device="cuda") -> Any:
    """Restore into the structure of ``like`` (latest step by default),
    each leaf a tensor of its stored dtype placed on ``device``."""
    dev = resolve_device(device)
    manifest, data = _open(ckpt_dir, step)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    with data:
        flat = {}
        for ps, _ in tree_util.flatten_with_paths(like):
            meta = by_path[ps]
            flat[ps] = _to_tensor(data[meta["key"]], meta["dtype"]).to(dev)
    return tree_util.unflatten_paths(flat)


def load_raw(ckpt_dir: str, step: Optional[int] = None
             ) -> tuple[dict, dict]:
    """-> (manifest, {leaf path: CPU tensor}) without a ``like`` tree, for
    readers that rebuild the structure from the manifest (serve
    snapshots).  Every leaf comes back as a CPU torch tensor of its
    stored dtype; bf16 leaves as ``torch.bfloat16`` (the reference hands
    back ``ml_dtypes`` arrays, which this package does not need)."""
    manifest, data = _open(ckpt_dir, step)
    with data:
        out = {leaf["path"]: _to_tensor(data[leaf["key"]], leaf["dtype"])
               for leaf in manifest["leaves"]}
    return manifest, out


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted([d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                    and not d.endswith(".tmp")])
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


# ---------------------------------------------------------------------------
# ComPEFT expert-delta export (Golomb cold-storage format)
# ---------------------------------------------------------------------------


def export_expert(theta_init: dict, theta_ft: dict, out_path: str,
                  density: float = 0.05, alpha: float = 1.0) -> dict:
    """DEPRECATED: use ``repro_torch.api.compress(init, ft).save(path)``.

    Shim over :meth:`repro_torch.expert.Expert.save`: the Golomb npz
    artifact (a ``.cpft`` ``out_path`` writes the wire blob), and its
    size accounting as the return value.  Compression runs on the device
    the leaves lie on.
    """
    import warnings

    from repro_torch.expert import Expert
    warnings.warn("checkpoint.export_expert is deprecated; use "
                  "repro_torch.api.compress(theta_init, theta_ft).save(path)",
                  DeprecationWarning, stacklevel=2)
    ex = Expert.from_finetune(theta_init, theta_ft,
                              name=os.path.splitext(
                                  os.path.basename(out_path))[0],
                              density=density, alpha=alpha)
    return ex.save(out_path)


def import_expert(path: str, device="cuda") -> tuple[dict, dict]:
    """DEPRECATED: use ``repro_torch.api.load(path)`` (an Expert).

    -> ({param path: dense tau leaf, f32 on the host}, manifest), the
    legacy contract, through :meth:`repro_torch.expert.Expert.load`
    (planes decoded on ``device``)."""
    import warnings

    from repro_torch.expert import DENSE, Expert
    warnings.warn("checkpoint.import_expert is deprecated; use "
                  "repro_torch.api.load(path)", DeprecationWarning,
                  stacklevel=2)
    ex = Expert.load(path, device=device)
    out = {p: l.to(torch.float32).reshape(ex._leaf_meta[p]["shape"])
           .cpu().numpy()
           for p, l in ex.as_path_dict(DENSE).items()}
    return out, ex._manifest
