"""repro_torch.api — the front door of the port (mirrors ``repro.api``).

    from repro_torch import api
    from repro_torch.models import build

    ex = api.compress(theta_init, theta_ft, name="math", density=0.1)
    ex.save("math.cpft")                   # Golomb wire artifact
    ex = api.load("math.cpft")             # planes decoded onto the card
    merged_tau = api.merge([ex_a, ex_b], method="ties", lam=0.7)
    reg = api.registry(experts=[ex])       # cold_golomb=True: keep streams
    engine = api.serve(model, base_params, reg,
                       max_batch=4, cache_len=128, decode_chunk=8)
    engine.run(requests)

``serve(..., scheduling="grouped")`` serves by merge-on-swap instead of
mixed waves: each expert is merged into a copy of the base once (the
``unpack_add_many`` kernel) and its requests are batched on the merged
params; ``engine.merged_ensemble_params(names, weights)`` merges several
weighted experts the same way.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
the card is absent; pass ``device="cpu"`` for the plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device
from repro_torch.expert import (DENSE, GOLOMB, PACKED, REPRESENTATIONS,
                                TERNARY, Expert)

__all__ = ["Expert", "DENSE", "TERNARY", "PACKED", "GOLOMB",
           "REPRESENTATIONS", "compress", "merge", "registry", "serve",
           "load", "save"]


def compress(tau_or_init: dict, theta_ft: Optional[dict] = None, *,
             name: str = "expert", kind: str = "full", density: float = 0.05,
             alpha: float = 1.0, per_tensor: bool = True,
             method: str = "streaming", meta: Optional[dict] = None,
             device="cuda") -> Expert:
    """Algorithm 1 as an artifact.  Call with a task vector or with a
    fine-tune pair (``tau = theta_ft - theta_init``).  The leaves are
    placed on ``device``; compression runs there on first ``as_``.
    ``method="streaming"`` is the histogram-threshold pipeline,
    ``method="exact"`` the sort-based per-leaf quantile."""
    dev = resolve_device(device)
    place = lambda t: tree_util.tree_map(lambda l: l.to(dev), t)  # noqa: E731
    kw = dict(name=name, kind=kind, density=density, alpha=alpha,
              per_tensor=per_tensor, method=method, meta=meta)
    if theta_ft is not None:
        return Expert.from_finetune(place(tau_or_init), place(theta_ft), **kw)
    return Expert.from_task_vector(place(tau_or_init), **kw)


def merge(experts: Sequence, method: str = "auto", lam: float = 1.0,
          density: float = 0.2, *, name: Optional[str] = None,
          as_expert: bool = False, **compress_kw):
    """Merge experts (Task Arithmetic / TIES / packed-plane TA), dispatched
    by representation (:func:`repro_torch.core.merging.merge_experts`).
    Returns the merged dense task-vector tree, on the experts' device, or
    with ``as_expert=True`` an Expert of it named ``name`` (``compress_kw``
    go to :func:`compress`)."""
    from repro_torch.core.merging import merge_experts
    tau = merge_experts(experts, method=method, lam=lam, density=density)
    if not as_expert:
        return tau
    compress_kw.setdefault("density", density)
    return compress(tau, name=name or "merged", **compress_kw)


def registry(store=None, *, cold_golomb: bool = False,
             device_cache_bytes: Optional[int] = None,
             device="cuda", experts: Sequence[Expert] = ()):
    """A fresh :class:`~repro_torch.serve.expert_cache.ExpertRegistry`
    whose device tier lives on ``device``.  ``cold_golomb=True`` keeps only
    Golomb streams in the cold tier and decodes them on promotion."""
    from repro_torch.serve.expert_cache import (DEFAULT_DEVICE_BYTES,
                                                ExpertRegistry)
    reg = ExpertRegistry(store, cold_golomb=cold_golomb, device=device,
                         device_cache_bytes=(device_cache_bytes
                                             or DEFAULT_DEVICE_BYTES))
    for e in experts:
        reg.add(e)
    return reg


def serve(model, base_params: dict, reg, cfg=None, **engine_kw):
    """A :class:`~repro_torch.serve.engine.ServeEngine` over a registry,
    on the registry's device.  Pass an ``EngineConfig`` or its fields
    (``max_batch``, ``cache_len``, ``decode_chunk``, ``scheduling`` =
    ``"mixed"`` or ``"grouped"`` for merge-on-swap, ``scheduler`` =
    ``"fifo"``, ``"priority"`` or ``"affinity"``, ``kv_layout`` =
    ``"dense"`` or ``"paged"`` with ``kv_block_size`` and ``kv_blocks``,
    ...); ``temperature``, ``top_k`` and ``seed`` build its
    ``SamplingConfig``."""
    from repro_torch.serve.decode_loop import SamplingConfig
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    samp = {k: engine_kw.pop(k) for k in ("temperature", "top_k", "seed")
            if k in engine_kw}
    if samp:
        base = cfg.sampling if cfg is not None else SamplingConfig()
        engine_kw["sampling"] = dataclasses.replace(base, **samp)
    if cfg is None:
        cfg = EngineConfig(**engine_kw)
    elif engine_kw:
        cfg = dataclasses.replace(cfg, **engine_kw)
    return ServeEngine(model, base_params, reg, cfg)


def load(path: str, name: Optional[str] = None, device="cuda") -> Expert:
    """Read an expert file (npz, legacy ``export_expert`` npz, or
    ``.cpft``); its planes are decoded onto ``device`` on first use."""
    return Expert.load(path, name=name, device=device)


def save(expert: Expert, path: str) -> dict:
    """Write ``expert`` as the Golomb artifact; returns size stats."""
    return expert.save(path)
