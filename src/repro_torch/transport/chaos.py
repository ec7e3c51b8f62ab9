"""ChaosTransport — deterministic failure injection for the fetch path:
port of ``repro/transport/chaos.py``, the same seeded schedule and the
same bounded fault log.

On real networks failures arrive as timeouts, torn reads and dead
origins; here they are *injected* at configured points so every recovery
path is testable and every test is reproducible.  The wrapper sits in front of
any :class:`~repro_torch.transport.backends.ExpertTransport` and
perturbs raw ``_get`` attempts:

* ``timeout``  — the attempt raises :class:`FetchTimeout` (retryable).
* ``partial``  — the blob is truncated; ``decode_expert`` rejects it
  with a :class:`ChecksumError` and the retry loop refetches.
* ``bitflip``  — one payload bit is flipped (seeded position); CRC
  verification rejects it and the retry loop refetches.
* ``blackout`` — the replica is unreachable
  (:class:`ReplicaUnreachable`).  As a scheduled fault it fires once;
  names in ``blackout`` (or hit by a scheduled ``blackout`` fault with
  ``persistent=True``, the default) stay dark until
  :meth:`restore` — the scenario that must degrade to a request-level
  ``FAILED``, not a crashed engine.

Faults are addressed by **(expert name, per-name fetch index)** — not a
global counter — so schedules are deterministic even when the prefetch
pool interleaves fetches of different experts across threads.  Each
scheduled fault fires exactly once; ``log`` records what fired and when.

**Replica-addressed faults** (:class:`ReplicaFault`) model the whole
replica — not one name — failing: blackout, flapping up/down, or a
slow-start after restart.  They are evaluated against the same per-name
op index (every ``_get`` or ranged ``_get_range`` on a name advances that
name's counter), so "the replica died after serving 2 chunks" hits every
in-flight fetch at the same logical point regardless of thread
interleaving — which is what makes the replicated CDN's mid-stream
failover tests deterministic.  :meth:`restore_replica` heals them all.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict, deque
from typing import Iterable, Optional

import numpy as np

from repro_torch.transport.backends import ExpertTransport
from repro_torch.transport.retry import (FetchTimeout, ReplicaUnreachable,
                                         RetryPolicy)
from repro_torch.transport.wire import _HEADER

FAULT_KINDS = ("timeout", "partial", "bitflip", "blackout")
REPLICA_FAULT_KINDS = ("blackout", "flap", "slow_start")


@dataclasses.dataclass(frozen=True)
class ChaosFault:
    """One scheduled fault: the ``at``-th fetch (0-based, per-name) of
    ``name`` fails with ``kind``.  A ``blackout`` with ``persistent=True``
    additionally takes the name dark for every later fetch."""

    name: str
    at: int
    kind: str
    persistent: bool = True      # blackout only: stay dark after firing

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class ReplicaFault:
    """A whole-replica fault, addressed by per-name op index (``at``).

    * ``blackout``   — every op with index >= ``at`` raises
      :class:`ReplicaUnreachable` until :meth:`ChaosTransport.
      restore_replica`.  ``at > 0`` kills a streamed fetch *mid-blob*
      (the first ``at`` chunks of every name arrive, the rest never do)
      — the scenario leaf-resumable failover exists for.
    * ``flap``       — alternates dark/up in phases of ``period`` ops,
      starting dark at ``at``.
    * ``slow_start`` — ops ``at .. at+warmup-1`` pay an extra ``slow_s``
      of latency (a cold replica warming its caches); EWMA selection
      should learn to deprioritise it.

    Indexing by per-name op count (not wall time or a global counter)
    keeps chaos schedules deterministic under concurrent prefetch.
    """

    kind: str
    at: int = 0
    period: int = 1              # flap: ops per dark/up phase
    slow_s: float = 0.05         # slow_start: extra delay per op
    warmup: int = 4              # slow_start: number of slowed ops

    def __post_init__(self):
        if self.kind not in REPLICA_FAULT_KINDS:
            raise ValueError(f"unknown replica fault kind {self.kind!r}; "
                             f"choose from {REPLICA_FAULT_KINDS}")


class ChaosTransport(ExpertTransport):
    """Failure-injecting wrapper around ``inner`` (seeded, deterministic).

    The retry policy applies at THIS layer (the wrapped transport's own
    fetch entry points are bypassed), so an injected fault exercises
    exactly one retry loop.  ``stats.retries`` therefore counts the
    recoveries the schedule forced.
    """

    def __init__(self, inner: ExpertTransport,
                 faults: Iterable[ChaosFault] = (),
                 replica_faults: Iterable[ReplicaFault] = (),
                 blackout: Iterable[str] = (), seed: int = 0,
                 retry: Optional[RetryPolicy] = None):
        super().__init__(retry=retry)
        self.inner = inner
        self._faults: dict[tuple[str, int], ChaosFault] = {}
        for f in faults:
            key = (f.name, f.at)
            if key in self._faults:
                raise ValueError(f"duplicate fault for {key}")
            self._faults[key] = f
        self.replica_faults = tuple(replica_faults)
        self._replica_restored = False
        self._dark: set[str] = set(blackout)
        self._counts: defaultdict[str, int] = defaultdict(int)
        self._rng = np.random.default_rng(seed)
        self._chaos_lock = threading.Lock()
        # bounded ring: a chaos schedule under a week-long soak must not
        # grow host memory without bound; ``log_dropped`` counts evictions
        self.log: deque = deque(maxlen=1024)
        self.log_dropped = 0
        self._saw_replica_blackout = False

    # ---- fault scheduling ----------------------------------------------
    def _replica_kind(self, idx: int) -> tuple[Optional[str], float]:
        """Replica-fault verdict for op index ``idx`` (pure function of
        the index + the restored flag, so deterministic under any thread
        interleaving).  Returns ``(kind, extra_delay_s)``."""
        if self._replica_restored:
            return None, 0.0
        for f in self.replica_faults:
            if idx < f.at:
                continue
            if f.kind == "blackout":
                return "replica_blackout", 0.0
            if f.kind == "flap":
                if ((idx - f.at) // max(f.period, 1)) % 2 == 0:
                    return "replica_flap", 0.0
            elif f.kind == "slow_start" and idx < f.at + f.warmup:
                return "replica_slow_start", f.slow_s
        return None, 0.0

    def _next_fault(self, name: str) -> tuple[Optional[str], float]:
        """Consume (at most) the fault scheduled for this op; returns
        ``(kind, extra_delay_s)``.  Name-addressed faults take precedence
        over replica-addressed ones.  Thread-safe and
        order-deterministic because the index is per-name."""
        with self._chaos_lock:
            idx = self._counts[name]
            self._counts[name] += 1
            fault = self._faults.pop((name, idx), None)
            kind = fault.kind if fault is not None else None
            if kind is None and name in self._dark:
                kind = "blackout"
            elif kind == "blackout" and fault.persistent:
                self._dark.add(name)
            delay = 0.0
            if kind is None:
                kind, delay = self._replica_kind(idx)
            if kind is not None:
                if kind == "replica_blackout":
                    # sticky flag: _replica_dark must keep answering True
                    # even after the ring evicts the triggering event
                    self._saw_replica_blackout = True
                if len(self.log) == self.log.maxlen:
                    self.log_dropped += 1
                self.log.append({"name": name, "fetch": idx, "kind": kind})
            return kind, delay

    def restore(self, name: str) -> None:
        """Bring a blacked-out replica back (quarantine re-probes then
        succeed)."""
        with self._chaos_lock:
            self._dark.discard(name)

    def restore_replica(self) -> None:
        """End every replica-addressed fault (the host came back).  The
        revalidation sweep's re-probe then succeeds and the replica
        rejoins the rotation."""
        with self._chaos_lock:
            self._replica_restored = True

    def fired(self) -> list[dict]:
        """Schedule accounting for tests/benchmarks: every fault that has
        fired, in firing order."""
        with self._chaos_lock:
            return list(self.log)

    # ---- corruption ----------------------------------------------------
    def _corrupt(self, blob: bytes, kind: str) -> bytes:
        """Damage the *payload* region only — the manifest must stay
        parseable so the failure is a retryable ChecksumError, not a
        terminal WireFormatError (a torn read rarely lands in the first
        few hundred header bytes of a multi-KB blob)."""
        _, _, mlen = _HEADER.unpack_from(blob)
        payload_start = _HEADER.size + mlen
        if payload_start >= len(blob):         # degenerate blob: drop a byte
            return blob[:-1]
        if kind == "partial":
            keep = max(payload_start, (payload_start + len(blob)) // 2)
            return blob[:keep]
        flipped = bytearray(blob)
        with self._chaos_lock:
            pos = int(self._rng.integers(payload_start, len(blob)))
            bit = int(self._rng.integers(8))
        flipped[pos] ^= 1 << bit
        return bytes(flipped)

    # ---- backend hooks -------------------------------------------------
    def _apply(self, name: str) -> Optional[str]:
        """Consume the next fault for ``name``; raise for dead-replica
        kinds, sleep for slow-start, return corrupt kinds to the caller."""
        kind, delay = self._next_fault(name)
        if kind == "blackout":
            raise ReplicaUnreachable(
                f"replica for {name!r} blacked out (injected)")
        if kind in ("replica_blackout", "replica_flap"):
            raise ReplicaUnreachable(
                f"replica dark ({kind}, injected) while fetching {name!r}")
        if kind == "timeout":
            raise FetchTimeout(f"fetch of {name!r} timed out (injected)")
        if delay:
            import time
            time.sleep(delay)
        return kind

    def _get(self, name: str) -> bytes:
        kind = self._apply(name)
        blob = self.inner._get(name)
        if kind in ("partial", "bitflip"):
            return self._corrupt(blob, kind)
        return blob

    def _get_range(self, name: str, start: int, length: int) -> bytes:
        # Ranged ops advance the same per-name counter as whole gets, so
        # one schedule covers both access patterns.  ``partial`` truncates
        # the chunk (leaf CRC rejects it); ``bitflip`` flips one chunk bit
        # (seeded) — note a flip landing in a head/manifest chunk is a
        # terminal WireFormatError, exactly like real header corruption.
        kind = self._apply(name)
        chunk = self.inner._get_range(name, start, length)
        if kind == "partial":
            return chunk[:len(chunk) // 2]
        if kind == "bitflip" and chunk:
            flipped = bytearray(chunk)
            with self._chaos_lock:
                pos = int(self._rng.integers(len(chunk)))
                bit = int(self._rng.integers(8))
            flipped[pos] ^= 1 << bit
            return bytes(flipped)
        return chunk

    def _put(self, name: str, blob: bytes) -> None:
        self.inner._put(name, blob)

    def _replica_dark(self) -> bool:
        """Host-level darkness (call under ``_chaos_lock``): a blackout
        ReplicaFault that starts at op 0 or has already fired takes the
        control plane down too — ``names()``/``contains`` probes must
        fail like data reads do, or a revalidation sweep would "recover"
        a dead host."""
        if self._replica_restored:
            return False
        for f in self.replica_faults:
            if f.kind != "blackout":
                continue
            if f.at == 0 or self._saw_replica_blackout:
                return True
        return False

    def _names(self) -> list[str]:
        with self._chaos_lock:
            if self._replica_dark():
                raise ReplicaUnreachable(
                    "replica dark (blackout, injected); names() unanswered")
        return self.inner._names()
