"""ReplicatedTransport — a small expert CDN over N transport replicas:
port of ``repro/transport/replication.py`` (the same ring, so the same
owners for the same replica ids and names).

The paper's serving story fetches experts per query over high-latency
networks; retries make a *single* origin survivable, but one origin is
one point of failure.  This module fronts N independent
:class:`~repro_torch.transport.backends.ExpertTransport` replicas and
makes a fetch survive any single-replica failure with **zero extra
fetched bytes in the common case**.  Four layers:

1. **Placement** — a consistent-hash ring (``vnodes`` virtual nodes per
   replica).  ``publish`` writes the blob to the R =
   ``replication_factor`` owners of ``hash(name)``; ``names`` /
   ``contains`` union across ring members.  Ring positions derive from
   stable replica ids, so adding or removing one replica moves only the
   expected ~1/N of keys (bounded key movement).
2. **Selection** — per-replica health: an EWMA latency score per replica
   (:class:`repro_torch.distributed.fault.StragglerMonitor`, fed by every
   ranged read) plus a consecutive-failure counter with a timed
   quarantine mirroring the remote store's per-expert quarantine.
   Candidates are ordered owners-first, fastest-healthy-first;
   quarantined replicas sort last and are only touched when everyone
   else failed.
3. **Resumable streamed fetch** — the fetch proceeds leaf by leaf using
   the manifest's per-leaf ``offset``/``nbytes`` (ranged reads via
   :meth:`ExpertTransport.get_range`).  When a replica dies mid-blob,
   failover re-requests **only the unfinished leaves** from the next
   candidate; per-leaf CRCs verify the stitched payload
   (:func:`repro_torch.transport.wire.verify_leaf`).  Legacy blobs
   without per-leaf CRCs degrade to whole-payload resumption.
4. **Tail control** — optional hedged reads (``hedge_ms``: fire a second
   contender over a rotated candidate order after the budget elapses;
   first complete wins, the loser is cancelled between leaves and its
   bytes are charged to ``stats.bytes_wasted``) and a revalidation sweep
   (:meth:`revalidate` / :meth:`start_sweep`) that re-probes quarantined
   replicas and re-copies under-replicated names after a host returns.

The ledger keeps the CDN's headline claim assertable: on a clean fetch
``stats.bytes_in`` equals bytes-on-wire of the blob and
``stats.bytes_wasted`` is 0 — even when a replica died mid-stream.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time
from typing import Any, Optional, Sequence

from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.expert import Expert
from repro_torch.transport.backends import _DEADLINE, ExpertTransport
from repro_torch.transport.retry import (DeadlineExceeded, ExpertNotFound,
                                         RetriesExhausted, RetryPolicy,
                                         is_retryable)
from repro_torch.transport.wire import (_HEADER, ChecksumError,
                                        TransportError, WireFormatError,
                                        decode_expert, decode_leaves,
                                        encode_expert, payload_offset,
                                        peek_manifest, supports_resume,
                                        verify_leaf)


def _hash64(key: str) -> int:
    """Stable 64-bit ring position (independent of PYTHONHASHSEED)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class _HedgeCancelled(Exception):
    """The other hedge contender won; unwind quietly."""


@dataclasses.dataclass
class _ReplicaHealth:
    monitor: StragglerMonitor
    observations: int = 0
    failures: int = 0
    quarantined_until: Optional[float] = None
    quarantines: int = 0
    last_error: str = ""


class _FetchState:
    """Progress of one (possibly multi-replica) resumable fetch: the
    verified head + manifest, the contiguous payload prefix reusable from
    the probe, and the per-leaf bytes already verified.  Failover hands
    this to the next replica so finished work is never refetched."""

    __slots__ = ("raw_head", "manifest", "payload_abs", "head", "prefix",
                 "leaves", "got", "fetched", "wasted")

    def __init__(self):
        self.raw_head: Optional[bytes] = None   # blob[0:...] as fetched
        self.manifest: Optional[dict] = None
        self.payload_abs = 0                    # header + manifest nbytes
        self.head = b""                         # verified header+manifest
        self.prefix = b""                       # payload[0:len) from probe
        self.leaves: list[dict] = []
        self.got: dict[str, bytes] = {}
        self.fetched = 0                        # bytes pulled off replicas
        self.wasted = 0                         # fetched but unusable

    def assemble(self) -> bytes:
        return self.head + b"".join(self.got[l["path"]] for l in self.leaves)


class ReplicatedTransport(ExpertTransport):
    """Fetch/publish experts across a fleet of transport replicas.

    ``replicas`` is a sequence of any :class:`ExpertTransport` instances
    (mix freely: HTTP origins, filesystem mounts, simulated links).
    ``replica_ids`` (optional) are the stable identities hashed onto the
    ring — pass them when replicas can join/leave so surviving replicas
    keep their ring positions.  See the module docstring for the four
    layers; knobs:

    * ``replication_factor`` — R owners per name (clamped to fleet size).
    * ``hedge_ms`` — tail-latency budget; ``None`` disables hedging.
    * ``quarantine_after`` / ``quarantine_probe_s`` — consecutive
      failures before a replica is benched, and for how long.
    * ``probe_bytes`` — first ranged read size; covers header + manifest
      and, for small blobs, the whole payload (then a fetch is exactly
      one request and "zero extra bytes" is literal).
    """

    def __init__(self, replicas: Sequence[ExpertTransport], *,
                 replication_factor: int = 2,
                 hedge_ms: Optional[float] = None,
                 quarantine_after: int = 3,
                 quarantine_probe_s: float = 30.0,
                 vnodes: int = 64,
                 probe_bytes: int = 65536,
                 replica_ids: Optional[Sequence[str]] = None,
                 retry: Optional[RetryPolicy] = None):
        super().__init__(retry=retry)
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("ReplicatedTransport needs at least 1 replica")
        if replication_factor < 1:
            raise ValueError("replication_factor must be >= 1")
        if replica_ids is not None and len(replica_ids) != len(self.replicas):
            raise ValueError("replica_ids must match replicas 1:1")
        self.replica_ids = (list(replica_ids) if replica_ids is not None
                            else [f"replica-{i}" for i in
                                  range(len(self.replicas))])
        self.replication_factor = min(replication_factor, len(self.replicas))
        self.hedge_ms = hedge_ms
        self.quarantine_after = quarantine_after
        self.quarantine_probe_s = quarantine_probe_s
        self.probe_bytes = int(probe_bytes)
        self._ring: list[tuple[int, int]] = sorted(
            (_hash64(f"{rid}#{v}"), i)
            for i, rid in enumerate(self.replica_ids)
            for v in range(vnodes))
        self._ring_points = [p for p, _ in self._ring]
        self._health = [_ReplicaHealth(monitor=StragglerMonitor())
                        for _ in self.replicas]
        self._health_lock = threading.Lock()
        self._published: set[str] = set()
        self._sweep_thread: Optional[threading.Thread] = None
        self._sweep_stop: Optional[threading.Event] = None

    # ---- placement -----------------------------------------------------
    def _owners(self, name: str) -> list[int]:
        """The R distinct replicas owning ``hash(name)``, clockwise."""
        pos = bisect.bisect(self._ring_points, _hash64(name))
        owners: list[int] = []
        for k in range(len(self._ring)):
            _, ri = self._ring[(pos + k) % len(self._ring)]
            if ri not in owners:
                owners.append(ri)
                if len(owners) == self.replication_factor:
                    break
        return owners

    # ---- health & selection --------------------------------------------
    def _in_quarantine(self, ri: int, now: float) -> bool:
        until = self._health[ri].quarantined_until
        return until is not None and now < until

    def _mark_failure(self, ri: int, err: Exception) -> None:
        now = time.monotonic()
        with self._health_lock:
            st = self._health[ri]
            st.failures += 1
            st.last_error = f"{type(err).__name__}: {err}"
            if st.failures >= self.quarantine_after:
                if st.quarantined_until is None or now >= st.quarantined_until:
                    st.quarantines += 1
                st.quarantined_until = now + self.quarantine_probe_s

    def _mark_success(self, ri: int) -> None:
        with self._health_lock:
            st = self._health[ri]
            st.failures = 0
            st.quarantined_until = None
            st.last_error = ""

    def _observe(self, ri: int, seconds: float) -> None:
        with self._health_lock:
            st = self._health[ri]
            st.observations += 1
            st.monitor.observe(st.observations, seconds)

    def _ordered(self, name: str) -> list[int]:
        """Candidate order: owners before non-owners, fastest known EWMA
        first (unprobed replicas sort fastest — natural exploration),
        quarantined replicas last (touched only when all else failed)."""
        now = time.monotonic()
        owner_set = set(self._owners(name))
        with self._health_lock:
            def score(i):
                ew = self._health[i].monitor.ewma
                return (0 if i in owner_set else 1,
                        ew if ew is not None else 0.0, i)
            active = [i for i in range(len(self.replicas))
                      if not self._in_quarantine(i, now)]
            benched = [i for i in range(len(self.replicas))
                       if self._in_quarantine(i, now)]
            active.sort(key=score)
            benched.sort(key=lambda i: self._health[i].quarantined_until)
        return active + benched

    # ---- resumable streamed fetch --------------------------------------
    def _ensure_manifest(self, ri: int, name: str, st: _FetchState) -> None:
        """Fetch enough of the blob head to know the manifest (resumable:
        a later replica continues from wherever the head fetch died)."""
        if st.manifest is not None:
            return
        r = self.replicas[ri]
        if st.raw_head is None or len(st.raw_head) < _HEADER.size:
            have = len(st.raw_head) if st.raw_head else 0
            t0 = time.monotonic()
            chunk = r.get_range(name, have, max(self.probe_bytes - have,
                                                _HEADER.size))
            self._observe(ri, time.monotonic() - t0)
            st.fetched += len(chunk)
            st.raw_head = (st.raw_head or b"") + chunk
        if len(st.raw_head) < _HEADER.size:
            raise WireFormatError(
                f"blob for {name!r} shorter than the wire header")
        need = payload_offset(st.raw_head)      # validates magic too
        if len(st.raw_head) < need:
            t0 = time.monotonic()
            more = r.get_range(name, len(st.raw_head),
                               need - len(st.raw_head))
            self._observe(ri, time.monotonic() - t0)
            st.fetched += len(more)
            st.raw_head += more
            if len(st.raw_head) < need:
                raise ChecksumError(
                    f"short read of {name!r} manifest: have "
                    f"{len(st.raw_head)} of {need} bytes")
        manifest = peek_manifest(st.raw_head[:need])
        st.manifest = manifest
        st.payload_abs = need
        st.head = st.raw_head[:need]
        st.prefix = st.raw_head[need:]
        if supports_resume(manifest) and manifest["leaves"]:
            st.leaves = decode_leaves(manifest)
        else:
            # Legacy blob without per-leaf CRCs: resume at whole-payload
            # granularity, verified by the manifest's payload CRC.
            st.leaves = [{"path": "__payload__", "offset": 0,
                          "nbytes": manifest["payload_nbytes"],
                          "crc32": manifest["crc32"]}]

    def _pull_leaves(self, ri: int, name: str, st: _FetchState,
                     cancel: Optional[threading.Event]) -> None:
        """Fetch + verify every still-unfinished leaf from replica ``ri``.
        Bytes already in ``st`` (probe prefix, finished leaves) are never
        re-requested — that is the zero-waste failover invariant."""
        r = self.replicas[ri]
        for leaf in st.leaves:
            path = leaf["path"]
            if path in st.got:
                continue
            if cancel is not None and cancel.is_set():
                raise _HedgeCancelled()
            off, n = leaf["offset"], leaf["nbytes"]
            pref = len(st.prefix)
            pulled = 0
            if off + n <= pref:
                raw = st.prefix[off:off + n]
            else:
                head_part = st.prefix[off:pref] if off < pref else b""
                start_abs = st.payload_abs + max(off, pref)
                need = n - len(head_part)
                t0 = time.monotonic()
                chunk = r.get_range(name, start_abs, need)
                self._observe(ri, time.monotonic() - t0)
                st.fetched += len(chunk)
                pulled = len(chunk)
                if len(chunk) != need:
                    st.wasted += pulled
                    raise ChecksumError(
                        f"short range read for leaf {path!r} of {name!r}: "
                        f"got {len(chunk)} of {need} bytes")
                raw = head_part + chunk
            try:
                verify_leaf(leaf, raw)
            except ChecksumError:
                # A corrupt prefix region must not poison the next
                # replica: truncate the prefix back to this leaf's start
                # so failover refetches it from clean bytes.
                if off < pref:
                    st.wasted += min(pref, off + n) - off
                    st.prefix = st.prefix[:off]
                st.wasted += pulled
                raise
            st.got[path] = raw

    def _resumable_fetch(self, name: str, pol: RetryPolicy,
                         st: _FetchState, rotate: int = 0,
                         cancel: Optional[threading.Event] = None) -> bytes:
        """Failover loop: walk the candidate order, resuming the same
        :class:`_FetchState` on each replica; back off between passes."""
        t0 = time.monotonic()
        absent: set[int] = set()
        last: Optional[Exception] = None
        for attempt in range(pol.max_attempts):
            if attempt:
                delay = pol.backoff_s(attempt - 1, name)
                if (pol.deadline_s is not None
                        and time.monotonic() - t0 + delay > pol.deadline_s):
                    raise DeadlineExceeded(
                        f"fetch of {name!r} would exceed the "
                        f"{pol.deadline_s}s deadline after {attempt} "
                        f"pass(es); last error: {last}") from last
                if delay:
                    if cancel is not None:
                        if cancel.wait(delay):
                            raise _HedgeCancelled()
                    else:
                        time.sleep(delay)
            order = self._ordered(name)
            if rotate and len(order) > 1:
                k = rotate % len(order)
                order = order[k:] + order[:k]
            for ri in order:
                if ri in absent:
                    continue
                if cancel is not None and cancel.is_set():
                    raise _HedgeCancelled()
                try:
                    self._ensure_manifest(ri, name, st)
                    self._pull_leaves(ri, name, st, cancel)
                    self._mark_success(ri)
                    return st.assemble()
                except _HedgeCancelled:
                    raise
                except ExpertNotFound as e:
                    # Absent on this replica is not a health failure and
                    # not absence everywhere — but absent on ALL
                    # candidates is definitive.
                    absent.add(ri)
                    last = e
                    if absent >= set(order):
                        raise ExpertNotFound(
                            f"no replica holds {name!r} "
                            f"(asked {len(order)})") from e
                except Exception as e:
                    if not is_retryable(e):
                        raise
                    self._mark_failure(ri, e)
                    with self._stats_lock:
                        self.stats.retries += 1
                    last = e
        raise RetriesExhausted(
            f"fetch of {name!r} failed after {pol.max_attempts} pass(es) "
            f"over {len(self.replicas)} replica(s); last error: {last}") \
            from last

    # ---- hedged reads --------------------------------------------------
    def _hedged_fetch(self, name: str, pol: RetryPolicy
                      ) -> tuple[bytes, _FetchState]:
        """Primary contender starts immediately; if it has not finished
        within ``hedge_ms``, a second contender races over a rotated
        candidate order.  First complete blob wins; the loser is
        cancelled between leaves and its bytes are charged to
        ``stats.bytes_wasted`` when it unwinds."""
        import concurrent.futures as cf
        hedge_s = float(self.hedge_ms) / 1000.0
        states = [_FetchState(), _FetchState()]
        cancels = [threading.Event(), threading.Event()]
        pool = cf.ThreadPoolExecutor(max_workers=2,
                                     thread_name_prefix="cdn-hedge")

        def run(k: int, rot: int) -> bytes:
            prev = getattr(_DEADLINE, "until", None)
            if pol.deadline_s is not None:
                _DEADLINE.until = time.monotonic() + pol.deadline_s
            try:
                return self._resumable_fetch(name, pol, states[k],
                                             rotate=rot, cancel=cancels[k])
            finally:
                _DEADLINE.until = prev

        futs = [pool.submit(run, 0, 0)]
        done, _ = cf.wait(futs, timeout=hedge_s)
        if not done:
            futs.append(pool.submit(run, 1, 1))
        try:
            pending = set(futs)
            errors: list[Exception] = []
            while pending:
                done, pending = cf.wait(pending,
                                        return_when=cf.FIRST_COMPLETED)
                for f in done:
                    try:
                        blob = f.result()
                    except _HedgeCancelled:
                        continue
                    except Exception as e:
                        errors.append(e)
                        continue
                    k = futs.index(f)
                    loser = 1 - k
                    cancels[loser].set()
                    if loser < len(futs):
                        def charge(lf, lk=loser):
                            lf.exception()          # consume, keep quiet
                            ls = states[lk]
                            with self._stats_lock:
                                self.stats.bytes_wasted += (ls.fetched
                                                            + ls.wasted)
                        futs[loser].add_done_callback(charge)
                    return blob, states[k]
            with self._stats_lock:          # both contenders failed: all
                for ls in states:           # their bytes bought nothing
                    self.stats.bytes_wasted += ls.fetched + ls.wasted
            raise errors[0] if errors else RetriesExhausted(
                f"hedged fetch of {name!r}: every contender failed")
        finally:
            pool.shutdown(wait=False)

    # ---- public API ----------------------------------------------------
    def publish(self, expert: Any, rep: Optional[str] = None) -> dict:
        """Encode once, upload to every ring owner of the name.  Returns
        ``{name, rep, nbytes, replicas}`` — ``nbytes`` is bytes-on-wire
        per copy; ``bytes_out`` charges the full R-way fan-out."""
        rep = rep or self.default_rep
        blob = encode_expert(expert, rep=rep)
        name = getattr(expert, "name", None) or "expert"
        owners = self._owners(name)
        for ri in owners:
            self.replicas[ri]._put(name, blob)
        with self._stats_lock:
            self.stats.publishes += 1
            self.stats.bytes_out += len(blob) * len(owners)
        self._published.add(name)
        return {"name": name, "rep": rep, "nbytes": len(blob),
                "replicas": owners}

    def fetch_bytes(self, name: str,
                    retry: Optional[RetryPolicy] = None) -> bytes:
        """Resumable multi-replica download of the raw wire blob.  The
        stitched result is leaf-CRC verified even when multiple replicas
        contributed bytes."""
        pol = retry or self.retry
        st = _FetchState()
        prev = getattr(_DEADLINE, "until", None)
        if pol.deadline_s is not None:
            _DEADLINE.until = time.monotonic() + pol.deadline_s
        t0 = time.monotonic()
        try:
            if self.hedge_ms is not None and len(self.replicas) > 1:
                blob, st = self._hedged_fetch(name, pol)
            else:
                blob = self._resumable_fetch(name, pol, st)
        except Exception:
            with self._stats_lock:
                # a failed fetch bought nothing: everything it pulled
                # (including verified leaves) is waste
                self.stats.bytes_wasted += st.fetched
                self.stats.fetch_seconds += time.monotonic() - t0
            raise
        finally:
            _DEADLINE.until = prev
        dt = time.monotonic() - t0
        with self._stats_lock:
            self.stats.fetches += 1
            self.stats.bytes_in += st.fetched
            self.stats.bytes_wasted += st.wasted
            self.stats.fetch_seconds += dt
        return blob

    def fetch_expert(self, name: str,
                     retry: Optional[RetryPolicy] = None
                     ) -> tuple[Expert, int]:
        blob = self.fetch_bytes(name, retry=retry)
        return decode_expert(blob, name=name, device="cpu"), len(blob)

    def contains(self, name: str) -> bool:
        """True if ANY replica holds the name.  False only when every
        reachable replica definitively answered "absent" AND all replicas
        were reachable; otherwise the unreachability surfaces."""
        unreachable: Optional[Exception] = None
        for r in self.replicas:
            try:
                if r.contains(name):
                    return True
            except TransportError as e:
                unreachable = e
        if unreachable is not None:
            raise unreachable
        return False

    def _names(self) -> list[str]:
        out: set[str] = set()
        for r in self.replicas:
            try:
                out.update(r._names())
            except TransportError:
                continue        # unreachable / cannot enumerate
        return sorted(out)

    def _put(self, name: str, blob: bytes) -> None:
        for ri in self._owners(name):
            self.replicas[ri]._put(name, blob)
        self._published.add(name)

    def _get(self, name: str) -> bytes:
        # whole-blob fallback (base-class paths); the resumable fetch
        # above is the real read path
        last: Optional[Exception] = None
        for ri in self._ordered(name):
            try:
                return self.replicas[ri]._get(name)
            except Exception as e:
                if not is_retryable(e) and not isinstance(e, ExpertNotFound):
                    raise
                last = e
        raise last if last is not None else ExpertNotFound(name)

    # ---- health / revalidation ----------------------------------------
    def health(self) -> dict:
        now = time.monotonic()
        with self._health_lock:
            reps = []
            for i, st in enumerate(self._health):
                q_for = (max(0.0, st.quarantined_until - now)
                         if st.quarantined_until is not None else 0.0)
                reps.append({"replica": i, "id": self.replica_ids[i],
                             "ewma_s": st.monitor.ewma,
                             "failures": st.failures,
                             "flagged": st.monitor.flags,
                             "recommendation": st.monitor.recommendation(),
                             "quarantined_for_s": q_for,
                             "quarantines": st.quarantines,
                             "last_error": st.last_error})
        return {"replicas": reps,
                "quarantined": sum(1 for r in reps
                                   if r["quarantined_for_s"] > 0),
                "replication_factor": self.replication_factor}

    def _probe(self, ri: int) -> bool:
        """Is the replica answering at all?  A definitive "absent" from a
        contains probe still proves reachability."""
        r = self.replicas[ri]
        try:
            r._names()
            return True
        except TransportError as e:
            if "enumerate" not in str(e):
                return False
        probe_name = next(iter(self._published), None)
        if probe_name is None:
            return True
        try:
            r.contains(probe_name)
            return True
        except TransportError:
            return False

    def revalidate(self, repair: bool = True) -> dict:
        """One sweep pass: re-probe unhealthy replicas (recover or
        re-bench them) and, with ``repair=True``, copy any
        under-replicated name back onto its missing ring owners from a
        surviving holder.  Returns
        ``{probed, recovered, repaired, under_replicated}``."""
        out = {"probed": 0, "recovered": 0, "repaired": 0,
               "under_replicated": 0}
        now = time.monotonic()
        with self._health_lock:
            suspects = [i for i, st in enumerate(self._health)
                        if st.failures > 0 or self._in_quarantine(i, now)]
        for ri in suspects:
            out["probed"] += 1
            if self._probe(ri):
                self._mark_success(ri)
                out["recovered"] += 1
            else:
                self._mark_failure(
                    ri, TransportError("revalidation probe failed"))
        if not repair:
            return out
        for name in sorted(set(self._names()) | self._published):
            holders: list[int] = []
            missing: list[int] = []
            unknown = False
            for ri in self._owners(name):
                try:
                    (holders if self.replicas[ri].contains(name)
                     else missing).append(ri)
                except TransportError:
                    unknown = True
            if not missing:
                continue
            blob: Optional[bytes] = None
            for src in holders or [j for j in range(len(self.replicas))
                                   if j not in missing]:
                try:
                    blob = self.replicas[src]._get(name)
                    break
                except Exception:
                    continue
            if blob is None:
                out["under_replicated"] += 1
                continue
            repaired_any = False
            for ri in missing:
                try:
                    self.replicas[ri]._put(name, blob)
                    out["repaired"] += 1
                    repaired_any = True
                except Exception:
                    pass
            if unknown or not repaired_any:
                out["under_replicated"] += 1
        return out

    def start_sweep(self, interval_s: float = 5.0,
                    repair: bool = True) -> None:
        """Run :meth:`revalidate` in a daemon thread every
        ``interval_s`` until :meth:`stop_sweep`."""
        if self._sweep_thread is not None:
            return
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.revalidate(repair=repair)
                except Exception:
                    pass            # the sweep must never kill serving

        t = threading.Thread(target=loop, daemon=True,
                             name="cdn-revalidate")
        self._sweep_stop = stop
        self._sweep_thread = t
        t.start()

    def stop_sweep(self) -> None:
        if self._sweep_thread is None:
            return
        self._sweep_stop.set()
        self._sweep_thread.join(timeout=5.0)
        self._sweep_thread = None
        self._sweep_stop = None
