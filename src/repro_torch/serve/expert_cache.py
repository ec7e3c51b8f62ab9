"""Expert storage tiers of the port: the remote store, the local store
and the device cache.

Port of ``repro/serve/expert_cache.py``:

  RemoteExpertStore (remote tier) wire-format blobs behind a transport
                                 (:mod:`repro_torch.transport`), fetched
                                 and checksum-verified on first use, then
                                 kept in the cold tier below; per-expert
                                 health with a timed quarantine
  ExpertStore    (cold tier)     name -> :class:`~repro_torch.expert.Expert`,
                                 or only its Golomb-Rice streams
                                 (``cold_golomb=True``), decoded to
                                 planes on promotion; fetched blobs under
                                 an optional byte budget (LRU)
  DeviceCache    (device tier)   packed bitplane trees on the card under one
                                 byte budget (LRU)
  ExpertRegistry                 the front door over the tiers, and the
                                 fused merge of named experts into the
                                 base (merge-on-swap, merged ensembles)

Promotion is pipelined: :meth:`DeviceCache.prefetch` stages fetch,
Golomb decode and plane build on worker threads, so a remote transfer
for one expert overlaps the decode of another and the engine's decode
steps.  The workers stay on the host: they make no CUDA call at all,
since the engine's thread may be capturing a CUDA graph meanwhile
(captures run in the global error mode, where another thread's CUDA
call invalidates them).  A staged tree is held on the CPU, and only
:meth:`DeviceCache.fetch`, on the caller's thread, moves it to the card.

Experts stay in the 2-bit bitplane form end to end.  A mixed wave reads
its experts through the serving engine's expert slots
(:class:`~repro_torch.models.delta.SlotOverlay`), filled by copy from the
trees here; the slots are the engine's and outside this budget, so the
reference's stacked buffers and their LRU have no counterpart here.

On a serving mesh (``mesh=``) the budget is per shard.  The packed trees
are the staging tier of every rank, so each shard pays them in full; the
expert-parallel buffers are the engine's slots, cut along "expert", and
:meth:`DeviceCache.shard_summary` reads their layout (the engine attaches
them as ``slots``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
import warnings
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core.packing import tree_packed_bytes
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.expert import GOLOMB, PACKED, Expert, as_expert
from repro_torch.kernels.ops import apply_ternary_delta_many_flat
from repro_torch.transport.retry import ExpertNotFound
from repro_torch.transport.wire import TransportError, WireFormatError

BASE = "__base__"   # pseudo-expert: serve the unmodified base weights

_UNSET = object()   # device(mesh=) default: the tier's, else the registry's

DEFAULT_DEVICE_BYTES = 1 << 28

DEFAULT_QUARANTINE_AFTER = 3     # consecutive fetch failures -> quarantine
DEFAULT_QUARANTINE_PROBE_S = 30.0


class ExpertUnavailable(TransportError):
    """One expert cannot be promoted right now: the typed, per-request
    failure the engine degrades on (the affected requests end ``failed``;
    the rest of the wave proceeds).

    ``terminal=True`` means retrying cannot help (never published, bad
    wire blob); ``quarantined=True`` means the expert's health account
    tripped and fetches are suppressed until the timed re-probe.
    """

    def __init__(self, name: str, reason: str, *, terminal: bool = False,
                 quarantined: bool = False):
        super().__init__(f"expert {name!r} unavailable: {reason}")
        self.name = name
        self.reason = reason
        self.terminal = terminal
        self.quarantined = quarantined


@dataclasses.dataclass
class SwapStats:
    store_to_host_bytes: int = 0
    host_to_device_bytes: int = 0
    promotions: int = 0
    evictions: int = 0
    hits: int = 0
    misses: int = 0
    seconds: float = 0.0
    stack_builds: int = 0          # expert slots filled by copy
    stack_hits: int = 0            # experts found already in their slot
    stack_bytes: int = 0           # the reference's stacked buffers: none
    stack_evictions: int = 0       # here (the slots are the engine's)
    golomb_decode_seconds: float = 0.0
    prefetch_issued: int = 0
    prefetch_hits: int = 0          # fetch() served from a staged future
    prefetch_seconds: float = 0.0   # off-thread fetch+decode time (overlapped)
    remote_fetches: int = 0
    remote_bytes: int = 0
    remote_seconds: float = 0.0
    cold_evictions: int = 0         # refetchable blobs dropped by the
                                    # cold tier's byte-budget LRU
    prefetch_errors: int = 0        # staged promotions that failed (counted,
                                    # never silently dropped)
    retries: int = 0                # transport-level retry attempts (mirror
                                    # of the transport's ledger)
    quarantines: int = 0            # expert health trips (consecutive
                                    # failures -> timed quarantine)
    transport_bytes_wasted: int = 0  # bytes fetched but never served (mirror
                                     # of the transport's ledger)
    straggler_flags: int = 0        # promotions flagged slow vs the EWMA
    straggler_recommendation: str = "healthy"   # StragglerMonitor verdict
    n_expert_shards: int = 1        # the serving mesh's "expert" axis

    def as_dict(self):
        return dataclasses.asdict(self)


class ExpertStore:
    """Cold tier: name -> Expert (its packed planes wherever they were
    compressed).

    ``cold_golomb=True`` keeps only each expert's Golomb-Rice streams (the
    storage-optimal form) and the leaf geometry; :meth:`get` then builds a
    fresh Expert from them and pays one host decode over all its leaves,
    with the planes on the host, for the device tier to move.

    ``budget_bytes`` bounds the **refetchable** entries (the wire blobs a
    :class:`RemoteExpertStore` keeps after a fetch, registered by
    :meth:`_account`) with an LRU: past the budget, least-recently-used
    entries are dropped and fetched again from upstream on next use.
    Experts ``put`` directly are the tier's source of truth and are never
    evicted.
    """

    def __init__(self, cold_golomb: bool = False,
                 budget_bytes: Optional[int] = None):
        self.cold_golomb = cold_golomb
        self.budget_bytes = budget_bytes
        self.cold_evictions = 0
        self._lru: OrderedDict[str, int] = OrderedDict()
        self._store: dict[str, Expert] = {}
        self._blobs: dict[str, dict] = {}
        self._meta: dict[str, dict] = {}

    # ---- cold byte-budget LRU (refetchable entries only) ---------------
    def _account(self, name: str, nbytes: int) -> None:
        """Register ``name`` as a refetchable cached blob of ``nbytes``
        and evict LRU refetchable entries past the budget (the entry just
        touched is always kept: it is the one in use)."""
        if self.budget_bytes is None:
            return
        self._lru[name] = nbytes
        self._lru.move_to_end(name)
        while (sum(self._lru.values()) > self.budget_bytes
               and len(self._lru) > 1):
            victim, _ = self._lru.popitem(last=False)
            self._evict_cold(victim)
            self.cold_evictions += 1

    def _touch(self, name: str) -> None:
        if name in self._lru:
            self._lru.move_to_end(name)

    def _evict_cold(self, name: str) -> None:
        self._store.pop(name, None)
        self._blobs.pop(name, None)
        self._meta.pop(name, None)

    def cold_resident_bytes(self) -> int:
        """Bytes held by the budget-bounded (refetchable) entries."""
        return sum(self._lru.values())

    def put(self, art) -> Expert:
        ex = as_expert(art)
        if not self.cold_golomb:
            self._store[ex.name] = ex
            return ex
        self._blobs[ex.name] = dict(ex.as_(GOLOMB))
        self._meta[ex.name] = {
            "leaf": {p: dict(m) for p, m in ex._leaf_meta.items()},
            "kind": ex.kind, "density": ex.density, "alpha": ex.alpha}
        return ex

    def get(self, name: str) -> Expert:
        ex, decode = self._get_cached(name)
        if decode:
            ex.as_(PACKED)     # one decode now, so promotion timing is the
        return ex              # store tier's

    def _get_cached(self, name: str) -> tuple[Expert, bool]:
        """Dict reads only (LRU touch, entry lookup): a caller that must be
        safe against a concurrent LRU eviction holds its lock around THIS
        and runs the (slow) Golomb decode outside it.  Returns (expert,
        needs_decode); a cold-Golomb entry comes back as a fresh Expert on
        the host."""
        self._touch(name)
        if not self.cold_golomb:
            return self._store[name], False
        m = self._meta[name]
        ex = Expert(name, m["kind"], density=m["density"], alpha=m["alpha"])
        ex._leaf_meta = {p: dict(v) for p, v in m["leaf"].items()}
        ex._reps[GOLOMB] = self._blobs[name]
        return ex, True

    def __contains__(self, name: str) -> bool:
        return name in (self._blobs if self.cold_golomb else self._store)

    def names(self) -> list[str]:
        return list(self._blobs if self.cold_golomb else self._store)

    def nbytes(self, name: str) -> int:
        if self.cold_golomb:
            return sum(len(b) for b in self._blobs[name].values())
        return self._store[name].nbytes(PACKED)


def _resolve_transport(transport, replicas, replication_factor, hedge_ms):
    """Normalize the ``transport=`` / ``replicas=`` spelling shared by
    :class:`RemoteExpertStore`, :class:`ExpertRegistry` and
    ``repro_torch.api.registry``: a replica fleet builds a
    :class:`~repro_torch.transport.replication.ReplicatedTransport`."""
    if replicas is not None:
        if transport is not None:
            raise ValueError("pass either transport= or replicas=, not both")
        from repro_torch.transport.replication import ReplicatedTransport
        return ReplicatedTransport(
            list(replicas),
            replication_factor=(replication_factor
                                if replication_factor is not None else 2),
            hedge_ms=hedge_ms)
    if replication_factor is not None or hedge_ms is not None:
        if transport is None or not hasattr(transport, "replication_factor"):
            raise ValueError("replication_factor=/hedge_ms= need replicas= "
                             "(or an existing ReplicatedTransport)")
        if replication_factor is not None:
            transport.replication_factor = min(
                replication_factor, len(transport.replicas))
        transport.hedge_ms = hedge_ms
    if transport is None:
        raise ValueError("a remote store needs transport= or replicas=")
    return transport


class RemoteExpertStore(ExpertStore):
    """Remote tier: wire-format experts behind an
    :class:`~repro_torch.transport.ExpertTransport`.

    ``get`` fetches the blob over the transport on first use (checksum
    verified, decoded to the host), then keeps the Expert in the inherited
    cold tier so repeated promotions never refetch.  Experts :meth:`put`
    directly act as a local overlay (they shadow same-named remote
    artifacts); :meth:`publish` also uploads through the transport.

    Thread-safe for concurrent ``get`` of distinct names: the
    :class:`DeviceCache` prefetch workers call it.  ``budget_bytes`` bounds
    the cold cache of fetched blobs (``cold_evictions`` counts the drops,
    which are fetched again on next use).

    **Health accounting**: every name carries a consecutive-failure count.
    ``quarantine_after`` retry-exhausted fetch cycles in a row trip a
    timed quarantine: for ``quarantine_probe_s`` the store raises
    :class:`ExpertUnavailable` *without* touching the transport, then the
    next ``get`` is a re-probe (success clears the account, failure
    re-arms the timer).  Terminal failures (:class:`ExpertNotFound`, the
    expert was never published, and non-checksum wire-format errors)
    surface at once as a terminal :class:`ExpertUnavailable` and do not
    count against health: absence is not flakiness.
    """

    def __init__(self, transport=None, cold_golomb: bool = False,
                 budget_bytes: Optional[int] = None,
                 quarantine_after: int = DEFAULT_QUARANTINE_AFTER,
                 quarantine_probe_s: float = DEFAULT_QUARANTINE_PROBE_S,
                 replicas=None, replication_factor: Optional[int] = None,
                 hedge_ms: Optional[float] = None):
        super().__init__(cold_golomb=cold_golomb, budget_bytes=budget_bytes)
        self.transport = _resolve_transport(
            transport, replicas, replication_factor, hedge_ms)
        self.quarantine_after = quarantine_after
        self.quarantine_probe_s = quarantine_probe_s
        self.quarantines = 0
        self._lock = threading.Lock()
        self._wire_bytes: dict[str, int] = {}
        self._failures: dict[str, int] = {}       # consecutive, per name
        self._quarantined: dict[str, float] = {}  # name -> re-probe time
        self._fetches = 0
        self._fetch_bytes = 0
        self._fetch_seconds = 0.0

    def _local(self, name: str) -> bool:
        return ExpertStore.__contains__(self, name)

    def _check_quarantine(self, name: str) -> None:
        """Raise inside an active quarantine window; past it, let ONE
        fetch through as the re-probe (the entry stays armed until the
        probe's outcome settles it)."""
        until = self._quarantined.get(name)
        if until is not None and time.monotonic() < until:
            raise ExpertUnavailable(
                name, f"quarantined after {self._failures.get(name, 0)} "
                f"consecutive fetch failures; re-probe in "
                f"{until - time.monotonic():.2f}s", quarantined=True)

    def _record_failure(self, name: str) -> None:
        with self._lock:
            fails = self._failures.get(name, 0) + 1
            self._failures[name] = fails
            # a failed re-probe re-arms the timer without counting a
            # second quarantine
            if fails >= self.quarantine_after:
                if name not in self._quarantined:
                    self.quarantines += 1
                self._quarantined[name] = (time.monotonic()
                                           + self.quarantine_probe_s)

    def _record_success(self, name: str) -> None:
        with self._lock:
            self._failures.pop(name, None)
            self._quarantined.pop(name, None)

    def get(self, name: str) -> Expert:
        # every read of the cold dicts happens under the lock (the budget
        # LRU may evict from another thread's _account); the Golomb decode
        # runs outside it, on the snapshot's own blob references
        with self._lock:
            ex, decode = (self._get_cached(name) if self._local(name)
                          else (None, False))
            if ex is None:
                self._check_quarantine(name)
        if ex is None:
            t0 = time.monotonic()
            try:
                # the transport's RetryPolicy spans decode: a corrupt
                # blob (ChecksumError) is fetched again, not surfaced
                fetched, nbytes = self.transport.fetch_expert(name)
            except ExpertNotFound as e:
                raise ExpertUnavailable(name, str(e), terminal=True) from e
            except WireFormatError as e:
                # not a checksum error: those are retryable and escape
                # only inside RetriesExhausted
                raise ExpertUnavailable(name, str(e), terminal=True) from e
            except TransportError as e:
                self._record_failure(name)
                raise ExpertUnavailable(name, str(e)) from e
            dt = time.monotonic() - t0
            self._record_success(name)
            with self._lock:
                if not self._local(name):   # lost a race: keep first copy
                    super().put(fetched)
                    self._wire_bytes[name] = nbytes
                    self._fetches += 1
                    self._fetch_bytes += nbytes
                    self._fetch_seconds += dt
                    self._account(name, nbytes)
                ex, decode = self._get_cached(name)
        if decode:
            ex.as_(PACKED)      # host decode, outside the lock
        return ex

    def health(self) -> dict:
        """Per-expert health: consecutive failures, active quarantines
        (seconds left), trip count; a replicated transport adds its
        ``replicas`` section."""
        now = time.monotonic()
        with self._lock:
            out = {"failures": dict(self._failures),
                   "quarantined": {n: max(0.0, t - now)
                                   for n, t in self._quarantined.items()},
                   "quarantines": self.quarantines}
        transport_health = getattr(self.transport, "health", None)
        if transport_health is not None:
            out["replicas"] = transport_health()
        return out

    def _evict_cold(self, name: str) -> None:
        super()._evict_cold(name)
        self._wire_bytes.pop(name, None)

    def publish(self, expert, rep: Optional[str] = None) -> dict:
        """Upload through the transport AND keep a cold-local copy."""
        out = self.transport.publish(expert, rep=rep)
        self.put(expert)
        return out

    def remote_totals(self) -> dict:
        with self._lock:
            return {"fetches": self._fetches, "bytes": self._fetch_bytes,
                    "seconds": self._fetch_seconds}

    def __contains__(self, name: str) -> bool:
        return self._local(name) or name in self.transport

    def names(self) -> list[str]:
        local = set(super().names())
        try:
            remote = set(self.transport.names())
        except Exception:       # e.g. HTTP backends cannot enumerate
            remote = set()
        return sorted(local | remote)

    def nbytes(self, name: str) -> int:
        """Store-to-host transfer cost: bytes on the wire for fetched
        experts."""
        wire = self._wire_bytes.get(name)
        return wire if wire is not None else super().nbytes(name)


def _on_host(packed: dict) -> bool:
    return all(t.device.type == "cpu" for pt in packed.values()
               for t in (pt.pos, pt.neg, pt.scale))


class DeviceCache:
    """LRU cache of packed bitplane trees on one device under a byte
    budget, with the prefetch pipeline in front of it.

    With ``mesh=`` (a serving mesh from :func:`repro_torch.launch.mesh.
    make_serve_mesh`) ``capacity_bytes`` is a **per-shard** budget: every
    rank stages the packed trees in full, so a shard pays
    :meth:`resident_bytes` and eviction starts when it is over its budget.
    The stacked buffers are the engine's slots (``slots``, attached by the
    engine), outside the budget as on one device, so the shard count
    changes no eviction; ``mesh=None`` keeps the single-device accounting
    (shard count 1)."""

    PREFETCH_WORKERS = 4  # concurrent fetch -> decode stages (pipeline depth)

    def __init__(self, store: ExpertStore, capacity_bytes: int, device,
                 mesh=None):
        self.store = store
        self.capacity = capacity_bytes
        self.dev = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.launch.mesh import mesh_axes
            self.n_shards = mesh_axes(mesh).get("expert", 1)
        else:
            self.n_shards = 1
        self.slots = None      # the engine's SlotOverlay, once it has one
        self._cache: OrderedDict[str, dict] = OrderedDict()
        self._sizes: dict[str, int] = {}
        self._pending: dict[str, Future] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self.stats = SwapStats(n_expert_shards=self.n_shards)
        # promotion-latency health: every fetch/decode stage (worker or
        # synchronous) feeds the EWMA; the monitor's recommendation
        # surfaces in SwapStats and registry.health()
        self.straggler = StragglerMonitor()
        self._straggler_lock = threading.Lock()
        self._straggler_obs = 0
        # serving gauges the engine publishes after each run(), surfaced
        # through ExpertRegistry.health()
        self.gauges: dict = {}

    def _observe_promotion(self, seconds: float) -> None:
        with self._straggler_lock:
            self._straggler_obs += 1
            self.straggler.observe(self._straggler_obs, seconds)

    def resident_bytes(self) -> int:
        return sum(self._sizes.values())

    def shard_resident_bytes(self) -> int:
        """Bytes under ONE shard's budget, the reference's name for them:
        :meth:`resident_bytes`, since the stacked slots, of which a shard
        holds ``1/n``, are the engine's and lie outside the budget."""
        return self.resident_bytes()

    def shard_summary(self) -> list[dict]:
        """Per-shard gauges: the experts each shard's block of the
        engine's slots holds, the slot bytes a shard holds, the packed
        tree bytes and the shard's budget."""
        held = (self.slots.shard_names() if self.slots is not None
                else [[] for _ in range(self.n_shards)])
        stack = self.slots.nbytes() if self.slots is not None else 0
        return [{"shard": k, "resident_experts": len(held[k]),
                 "stack_bytes": stack,
                 "tree_bytes": self.resident_bytes(),
                 "capacity_bytes": self.capacity}
                for k in range(self.n_shards)]

    def resident(self) -> list[str]:
        """Names of the trees on the device, least recently used first."""
        return list(self._cache)

    def _drop_tree(self, name: str) -> None:
        self._cache.pop(name)
        self._sizes.pop(name)
        self.stats.evictions += 1

    def _enforce_budget(self) -> None:
        """Evict least-recently-used trees until every shard is within
        its budget."""
        while self._cache and self.resident_bytes() > self.capacity:
            self._drop_tree(next(iter(self._cache)))

    def prefetch(self, names) -> int:
        """Stage fetch -> decode -> plane build for ``names`` on worker
        threads.  Advisory: nothing here blocks on the store or the
        network (membership probes and fetch errors live on the worker),
        and a failed stage falls back to the synchronous path on the
        eventual :meth:`fetch`, where unknown names still fail loudly.
        Returns the number of stages issued."""
        issued = 0
        for name in names:
            if name == BASE or name in self._cache or name in self._pending:
                continue
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.PREFETCH_WORKERS,
                    thread_name_prefix="expert-prefetch")
            self._pending[name] = self._pool.submit(self._stage, name)
            self.stats.prefetch_issued += 1
            issued += 1
        return issued

    def _stage(self, name: str):
        """Worker-thread half of a promotion: everything up to the device
        transfer, on the host.  An expert whose planes live (or would be
        made) on the card is left to :meth:`fetch`: a worker makes no CUDA
        call.  Returns (host planes or None, seconds)."""
        t0 = time.monotonic()
        art = self.store.get(name)      # remote fetch / cold Golomb decode
        if art.device.type != "cpu":
            return None, 0.0
        packed_host = art.packed        # plane build (host)
        dt = time.monotonic() - t0
        self._observe_promotion(dt)
        return packed_host, dt

    def invalidate_pending(self, name: str) -> None:
        """Drop a staged promotion whose cold-tier source changed (a local
        overlay now shadows the remote artifact): the next fetch promotes
        from the store instead of consuming stale planes."""
        self._pending.pop(name, None)

    def close(self) -> None:
        """Drop staged-but-unconsumed promotions and stop the prefetch
        workers.  Safe to call on caches that never prefetched."""
        self._pending.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def fetch(self, name: str) -> dict:
        """-> {path: PackedTernary} resident on the cache's device."""
        if name in self._cache:
            self._cache.move_to_end(name)
            self.stats.hits += 1
            return self._cache[name]
        self.stats.misses += 1
        t0 = time.monotonic()
        host_packed = None
        fut = self._pending.pop(name, None)
        if fut is not None:
            try:
                host_packed, stage_s = fut.result()
            except ExpertUnavailable:
                # the store already ran the whole retry and health path on
                # the worker; repeating it here would double the damage
                self.stats.prefetch_errors += 1
                self._sync_remote_stats()
                raise
            except Exception:
                # a transient stage failure (not a store verdict): count
                # it and take the synchronous path
                self.stats.prefetch_errors += 1
            else:
                if host_packed is not None:
                    if not _on_host(host_packed):
                        raise RuntimeError(
                            f"the prefetch stage of {name!r} left planes on "
                            "the card: a worker thread made a CUDA call")
                    self.stats.prefetch_hits += 1
                    self.stats.prefetch_seconds += stage_s
                    if self.store.cold_golomb:
                        # the decode ran on a worker; it is still the
                        # decode's time (the synchronous path's measure)
                        self.stats.golomb_decode_seconds += stage_s
        if host_packed is None:
            try:
                art = self.store.get(name)
            except ExpertUnavailable:
                self._sync_remote_stats()    # failures still hit the ledger
                raise
            if self.store.cold_golomb:
                self.stats.golomb_decode_seconds += time.monotonic() - t0
            host_packed = art.packed
            self._observe_promotion(time.monotonic() - t0)
        self._sync_remote_stats()
        self.stats.store_to_host_bytes += self.store.nbytes(name)
        packed = {p: dataclasses.replace(pt, pos=pt.pos.to(self.dev),
                                         neg=pt.neg.to(self.dev),
                                         scale=pt.scale.to(self.dev))
                  for p, pt in host_packed.items()}
        size = tree_packed_bytes(packed)
        while (self._cache
               and self.resident_bytes() + size > self.capacity):
            self._drop_tree(next(iter(self._cache)))
        self._cache[name] = packed
        self._sizes[name] = size
        self.stats.host_to_device_bytes += size
        self.stats.promotions += 1
        self.stats.seconds += time.monotonic() - t0
        return packed

    def _sync_remote_stats(self) -> None:
        """Mirror the remote store's transfer ledger into SwapStats (totals,
        not deltas: safe against concurrent staging threads)."""
        totals = getattr(self.store, "remote_totals", None)
        if totals is not None:
            t = totals()
            self.stats.remote_fetches = t["fetches"]
            self.stats.remote_bytes = t["bytes"]
            self.stats.remote_seconds = t["seconds"]
        self.stats.cold_evictions = self.store.cold_evictions
        self.stats.quarantines = getattr(self.store, "quarantines", 0)
        transport = getattr(self.store, "transport", None)
        if transport is not None:
            self.stats.retries = transport.stats.retries
            self.stats.transport_bytes_wasted = transport.stats.bytes_wasted
        with self._straggler_lock:
            self.stats.straggler_flags = self.straggler.flags
            self.stats.straggler_recommendation = \
                self.straggler.recommendation()


class ExpertRegistry:
    """One expert library over the storage tiers.

    Pass ``transport=`` (an :class:`~repro_torch.transport.ExpertTransport`)
    or ``replicas=`` (a list of them) to build the registry over a
    **remote** store: the cold tier becomes a :class:`RemoteExpertStore`,
    experts are fetched over the wire on first use, and :meth:`prefetch`
    overlaps those transfers with serving.  ``retry=`` replaces the
    transport's :class:`~repro_torch.transport.RetryPolicy`;
    ``quarantine_after`` / ``quarantine_probe_s`` set the per-expert
    health account; ``cold_budget_bytes`` bounds the cold cache of fetched
    blobs.  ``mesh=`` (a serving mesh) makes the device tier's budget a
    per-shard one (:class:`DeviceCache`).
    """

    def __init__(self, store: Optional[ExpertStore] = None, *,
                 cold_golomb: bool = False,
                 device_cache_bytes: int = DEFAULT_DEVICE_BYTES,
                 transport=None, cold_budget_bytes: Optional[int] = None,
                 retry=None,
                 quarantine_after: int = DEFAULT_QUARANTINE_AFTER,
                 quarantine_probe_s: float = DEFAULT_QUARANTINE_PROBE_S,
                 replicas=None, replication_factor: Optional[int] = None,
                 hedge_ms: Optional[float] = None, device="cuda",
                 mesh=None):
        if store is not None and (transport is not None
                                  or replicas is not None):
            raise ValueError("pass either store= or transport=/replicas=, "
                             "not both")
        if (transport is not None or replicas is not None
                or replication_factor is not None or hedge_ms is not None):
            transport = _resolve_transport(transport, replicas,
                                           replication_factor, hedge_ms)
        if retry is not None:
            if transport is None:
                raise ValueError("retry= needs a transport-backed registry")
            transport.retry = retry
        if store is None:
            store = (RemoteExpertStore(transport, cold_golomb=cold_golomb,
                                       budget_bytes=cold_budget_bytes,
                                       quarantine_after=quarantine_after,
                                       quarantine_probe_s=quarantine_probe_s)
                     if transport is not None
                     else ExpertStore(cold_golomb=cold_golomb,
                                      budget_bytes=cold_budget_bytes))
        elif cold_budget_bytes is not None:
            store.budget_bytes = cold_budget_bytes
        self.store = store
        self.device_cache_bytes = device_cache_bytes
        self.dev = resolve_device(device)
        self.mesh = mesh
        self._device: Optional[DeviceCache] = None

    # ---- library management -------------------------------------------
    def add(self, expert, *experts) -> Expert:
        """Register one or more experts; returns the first, normalized.  A
        staged prefetch of the same name is invalidated, so a local overlay
        is never shadowed by an in-flight remote fetch."""
        out = []
        for e in (expert,) + experts:
            ex = self.store.put(e)
            if self._device is not None:
                self._device.invalidate_pending(ex.name)
            out.append(ex)
        return out[0]

    put = add   # ExpertStore-compatible spelling

    def get(self, name: str) -> Expert:
        return self.store.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.store

    def __len__(self) -> int:
        return len(self.store.names())

    def names(self) -> list[str]:
        return self.store.names()

    def nbytes(self, name: str) -> int:
        return self.store.nbytes(name)

    # ---- device tier ---------------------------------------------------
    def device(self, capacity_bytes: Optional[int] = None,
               mesh=_UNSET) -> DeviceCache:
        """The device tier (created on first call); an explicit
        ``capacity_bytes`` sets or retargets its budget.  Without
        ``mesh=`` the tier is returned as it is, or made on the registry's
        mesh; an explicit ``mesh=`` other than the tier's rebuilds it (its
        budget is per shard of that mesh).  So an engine that builds the
        tier on its own mesh stays its owner: the engine's later fetches
        go through the same tier."""
        if mesh is _UNSET:
            mesh = (self._device.mesh if self._device is not None
                    else self.mesh)
        if self._device is not None and mesh is not self._device.mesh:
            self._device.close()
            self._device = None
        if self._device is None:
            self._device = DeviceCache(
                self.store, capacity_bytes or self.device_cache_bytes,
                self.dev, mesh=mesh)
        elif (capacity_bytes is not None
              and capacity_bytes != self._device.capacity):
            self._device.capacity = capacity_bytes
            self._device._enforce_budget()
        return self._device

    def fetch_packed(self, name: str) -> dict:
        """Device-resident ``{path: PackedTernary}`` of one expert
        (``{}`` for ``BASE``)."""
        return {} if name == BASE else self.device().fetch(name)

    def prefetch(self, names) -> int:
        """Stage promotions for ``names`` in the background
        (:meth:`DeviceCache.prefetch`); ``BASE`` is skipped.  Returns the
        number of stages issued."""
        if isinstance(names, str):
            names = [names]
        names = [n for n in names if n != BASE]
        if not names:
            return 0
        return self.device().prefetch(names)

    def close(self) -> None:
        """Release the device tier's prefetch workers and staged
        promotions (the registry stays usable; a later fetch promotes
        again)."""
        if self._device is not None:
            self._device.close()

    def health(self) -> dict:
        """Per-expert failure and quarantine accounts (remote registries),
        per-replica health (``replicas``, replicated transports), the
        device tier's promotion-latency verdict (``straggler``) and, once
        an engine has run, its serving gauges (``serving``)."""
        h = getattr(self.store, "health", None)
        out = (h() if h is not None
               else {"failures": {}, "quarantined": {}, "quarantines": 0})
        if self._device is not None:
            with self._device._straggler_lock:
                out["straggler"] = {
                    "recommendation":
                        self._device.straggler.recommendation(),
                    "flags": self._device.straggler.flags,
                    "ewma_s": self._device.straggler.ewma}
            if self._device.gauges:
                out["serving"] = dict(self._device.gauges)
        return out

    def publish(self, expert, rep: Optional[str] = None) -> dict:
        """Upload an expert through the registry's transport (remote
        registries only) and keep a cold-local copy."""
        if not isinstance(self.store, RemoteExpertStore):
            raise TypeError("publish() needs a transport-backed registry; "
                            "construct with ExpertRegistry(transport=...) "
                            "or repro_torch.api.registry(transport=...)")
        return self.store.publish(expert, rep=rep)

    def merged_params(self, base: dict, names, weights=None,
                      out: Optional[dict] = None, cut=None) -> dict:
        """``W_base + sum_e w_e * Delta_e`` with ONE fused sweep per leaf.

        Each leaf that any named expert carries goes through
        ``unpack_add_many`` once, over the experts that carry it, bitwise
        equal to applying the weight-scaled experts one at a time; a leaf
        no expert carries is returned as it is (not copied).  With one
        name this is the merge-on-swap promotion.  ``out`` (a tree shaped
        like ``base``) takes every merged leaf, and every other leaf of the
        base, by copy, and is returned: a caller whose CUDA graphs read
        the parameters by address keeps them at one place across swaps.
        ``cut(path, leaf)`` maps each merged logical leaf to what ``out``
        holds of it (a rank's shard on a serving mesh)."""
        names = [names] if isinstance(names, str) else list(names)
        w = list(weights) if weights is not None else [1.0] * len(names)
        if len(w) != len(names):
            raise ValueError(f"{len(w)} weights for {len(names)} experts")
        packs = [self.fetch_packed(n) for n in names]
        dst = dict(tree_util.flatten_with_paths(out)) if out is not None \
            else None
        flat = {}
        for path, leaf in tree_util.flatten_with_paths(base):
            pts = [(pk[path], wi) for pk, wi in zip(packs, w) if path in pk]
            flat[path] = leaf if not pts else apply_ternary_delta_many_flat(
                leaf, [pt for pt, _ in pts], [wi for _, wi in pts])
            if cut is not None:
                flat[path] = cut(path, flat[path])
            if dst is not None:
                dst[path].copy_(flat.pop(path))
        return out if out is not None else tree_util.unflatten_paths(flat)


def as_registry(obj, device="cuda") -> ExpertRegistry:
    """Normalize an ExpertStore (legacy engine wiring) to a registry whose
    device tier lives on ``device``."""
    if isinstance(obj, ExpertRegistry):
        return obj
    if isinstance(obj, ExpertStore):
        warnings.warn(
            "passing an ExpertStore to ServeEngine is deprecated; wrap it "
            "in repro_torch.api.registry() / ExpertRegistry(store)",
            DeprecationWarning, stacklevel=3)
        return ExpertRegistry(store=obj, device=device)
    raise TypeError(f"expected ExpertRegistry or ExpertStore, "
                    f"got {type(obj).__name__}")


def uncompressed_baseline_bytes(art) -> int:
    """What the same swap would cost without ComPEFT (bf16 dense): an
    :class:`~repro_torch.expert.Expert` or a tree of packed leaves."""
    packed = art.packed if not isinstance(art, dict) else art
    leaves = tree_util.leaves(packed, is_leaf=lambda x: hasattr(x, "pos"))
    return sum(math.prod(p.shape) * 2 for p in leaves)
