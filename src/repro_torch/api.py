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

    # another host: publish over a transport, serve from a remote registry
    from repro_torch.transport import LocalTransport
    tr = LocalTransport("/shared/experts")
    api.publish(ex, tr, rep=PACKED)        # or a list of transports
    remote = api.registry(transport=tr)    # remote -> cold -> card tiers
    api.serve(model, base_params, remote).run(requests)
    ex = api.fetch(tr, "math")             # planes decoded onto the card

``serve(..., scheduling="grouped")`` serves by merge-on-swap instead of
mixed waves: each expert is merged into a copy of the base once (the
``unpack_add_many`` kernel) and its requests are batched on the merged
params; ``engine.merged_ensemble_params(names, weights)`` merges several
weighted experts the same way.

A remote registry serves a request whose expert cannot be fetched (a
dead replica, a quarantine) as ``failed`` and the others as usual
(``degrade="request"``, the default).

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
           "load", "save", "publish", "fetch"]


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
             transport=None, cold_budget_bytes: Optional[int] = None,
             retry=None, quarantine_after: Optional[int] = None,
             quarantine_probe_s: Optional[float] = None,
             replicas=None, replication_factor: Optional[int] = None,
             hedge_ms: Optional[float] = None, device="cuda",
             experts: Sequence[Expert] = ()):
    """A fresh :class:`~repro_torch.serve.expert_cache.ExpertRegistry`
    whose device tier lives on ``device``.  ``cold_golomb=True`` keeps only
    Golomb streams in the cold tier and decodes them on promotion.

    ``transport=`` (a :class:`~repro_torch.transport.ExpertTransport`)
    builds it over a **remote** store: experts are fetched as checksummed
    wire blobs on first use, decoded on the host, and ``reg.prefetch``
    overlaps the transfers with serving.  ``replicas=[t0, t1, ...]``
    fronts a fleet with a :class:`~repro_torch.transport.
    ReplicatedTransport` (``replication_factor`` owners per name, default
    2; hedged reads after ``hedge_ms``).  ``retry=`` replaces the
    transport's :class:`~repro_torch.transport.RetryPolicy`;
    ``quarantine_after`` consecutive failed fetch cycles put an expert in
    quarantine for ``quarantine_probe_s``; ``cold_budget_bytes`` bounds
    the cold cache of fetched blobs.  A fetch that still fails raises
    :class:`~repro_torch.serve.ExpertUnavailable`, which the engine turns
    into a ``failed`` request."""
    from repro_torch.serve.expert_cache import (DEFAULT_DEVICE_BYTES,
                                                DEFAULT_QUARANTINE_AFTER,
                                                DEFAULT_QUARANTINE_PROBE_S,
                                                ExpertRegistry)
    reg = ExpertRegistry(
        store, cold_golomb=cold_golomb, device=device,
        device_cache_bytes=device_cache_bytes or DEFAULT_DEVICE_BYTES,
        transport=transport, cold_budget_bytes=cold_budget_bytes,
        retry=retry, replicas=replicas,
        replication_factor=replication_factor, hedge_ms=hedge_ms,
        quarantine_after=(DEFAULT_QUARANTINE_AFTER if quarantine_after is None
                          else quarantine_after),
        quarantine_probe_s=(DEFAULT_QUARANTINE_PROBE_S
                            if quarantine_probe_s is None
                            else quarantine_probe_s))
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
    ``SamplingConfig`` (pass them or ``sampling=``, not both).

    ``snapshot_dir=`` arms crash consistency: every ``run()`` writes a
    CRC-framed journal there (admissions, scheduler decisions, each
    chunk's tokens, flushed at every chunk boundary), and
    ``snapshot_every_chunks=N`` commits an atomic snapshot of the wave
    (KV, pending tokens, allocator state) every N chunks.
    ``resume=True`` rebuilds a killed run instead of returning an idle
    engine: it replays the journal, restores the latest snapshot into the
    engine's kept buffers, fetches the experts through the registry, and
    serves every unfinished request to the tokens of the uninterrupted
    run; they land in ``engine.resumed_requests``, the timing and the
    ``RecoveryPlan`` in ``engine.recovery_stats``."""
    from repro_torch.serve.decode_loop import SamplingConfig
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    do_resume = engine_kw.pop("resume", False)
    samp = {k: engine_kw.pop(k) for k in ("temperature", "top_k", "seed")
            if k in engine_kw}
    if samp:
        if "sampling" in engine_kw:
            raise ValueError("pass either sampling= or flat "
                             "temperature/top_k/seed, not both")
        base = cfg.sampling if cfg is not None else SamplingConfig()
        engine_kw["sampling"] = dataclasses.replace(base, **samp)
    if cfg is None:
        cfg = EngineConfig(**engine_kw)
    elif engine_kw:
        cfg = dataclasses.replace(cfg, **engine_kw)
    eng = ServeEngine(model, base_params, reg, cfg)
    if do_resume:
        eng.resume()
    return eng


def load(path: str, name: Optional[str] = None, device="cuda") -> Expert:
    """Read an expert file (npz, legacy ``export_expert`` npz, or
    ``.cpft``); its planes are decoded onto ``device`` on first use."""
    return Expert.load(path, name=name, device=device)


def save(expert: Expert, path: str) -> dict:
    """Write ``expert`` as the Golomb artifact; returns size stats."""
    return expert.save(path)


def publish(expert: Expert, transport, rep: str = GOLOMB,
            replication_factor: Optional[int] = None) -> dict:
    """Upload ``expert`` through a transport as one wire blob (manifest
    and per-leaf CRCs; :mod:`repro_torch.transport.wire`), byte for byte
    the reference's.  ``rep``: :data:`GOLOMB` (the default, smallest),
    :data:`PACKED` (2 bits a parameter, no decode on arrival) or
    :data:`DENSE` (bf16).  Returns ``{name, rep, nbytes}``.

    ``transport`` may be a **list** of transports: the blob then goes to
    the ``replication_factor`` (default 2) ring owners of the name, and
    the result names them under ``replicas``; a
    :class:`~repro_torch.transport.ReplicatedTransport` over the same list
    computes the same owners."""
    if isinstance(transport, (list, tuple)):
        from repro_torch.transport.replication import ReplicatedTransport
        transport = ReplicatedTransport(
            list(transport),
            replication_factor=(replication_factor
                                if replication_factor is not None else 2))
    elif replication_factor is not None:
        if not hasattr(transport, "replication_factor"):
            raise ValueError("replication_factor= needs a replica list or "
                             "a ReplicatedTransport")
        transport.replication_factor = min(replication_factor,
                                           len(transport.replicas))
    return transport.publish(expert, rep=rep)


def fetch(transport, name: str, retry=None, device="cuda") -> Expert:
    """Fetch, verify and decode one published expert; its planes are
    placed on ``device`` (the wire decode runs on the host).  Transient
    failures (5xx, timeouts, checksum mismatches) are retried under the
    transport's :class:`~repro_torch.transport.RetryPolicy`, or
    ``retry``."""
    dev = resolve_device(device)
    ex = transport.fetch_expert(name, retry=retry)[0]
    if dev.type == "cpu":
        return ex
    planes = {p: dataclasses.replace(pt, pos=pt.pos.to(dev),
                                     neg=pt.neg.to(dev),
                                     scale=pt.scale.to(dev))
              for p, pt in ex.packed.items()}
    return Expert.from_packed(ex.name, ex.kind,
                              tree_util.unflatten_paths(planes),
                              density=ex.density, alpha=ex.alpha,
                              meta=ex.meta)
