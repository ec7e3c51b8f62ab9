"""Transport backends: how a wire-format expert blob actually moves.
Port of ``repro/transport/backends.py``.

:class:`ExpertTransport` is the abstraction the serving stack's REMOTE
tier (:class:`~repro_torch.serve.expert_cache.RemoteExpertStore`) sits
on: a named blob store with ``publish`` (encode + upload) and ``fetch``
(download + decode) and per-transport byte/latency accounting.  The
backends:

* :class:`InMemoryTransport`   — a dict (tests, and the simulated
  link's inner store).
* :class:`LocalTransport`      — a directory of ``<name>.cpft`` files
  (shared filesystem / object-store mount).
* :class:`SimulatedNetworkTransport` — in-process store behind a
  configurable bandwidth / latency / loss model.  Deterministic (seeded),
  so measurements of the paper's communication-cost claim are
  reproducible without real network flakiness.
* :class:`HTTPTransport`       — fetch over HTTP(S) with stdlib urllib
  (no extra dependencies); any static file server works, e.g.
  :func:`serve_local_http` over a :class:`LocalTransport` root.

A fetch decodes to the **host**: the planes of a fetched expert are CPU
tensors.  Fetches run on the prefetch workers of
:class:`~repro_torch.serve.expert_cache.DeviceCache` while the engine's
thread may be capturing a CUDA graph, and a CUDA call from another
thread invalidates a capture; only ``DeviceCache.fetch``, on the
engine's thread, moves planes to the card.

Backends are thread-safe for concurrent ``fetch`` of distinct names, so
transfer overlaps decode across the prefetch workers.

Every backend applies one uniform
:class:`~repro_torch.transport.retry.RetryPolicy` to its fetch path:
retryable failures (5xx, unreachable replica, seeded loss, timeouts, CRC
mismatch → refetch) back off and retry up to the attempt/deadline
budget; terminal failures (404, bad magic, unsupported version) raise
immediately.  See :mod:`repro_torch.transport.retry` for the taxonomy
and :class:`~repro_torch.transport.chaos.ChaosTransport` for the
failure-injection wrapper that exercises every branch deterministically.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.expert import GOLOMB, Expert
from repro_torch.transport.retry import (DEFAULT_RETRY, SIMULATED_RETRY,
                                         DeadlineExceeded, ExpertNotFound,
                                         FetchTimeout, ReplicaUnreachable,
                                         RetriesExhausted, RetryPolicy,
                                         TransientTransportError,
                                         is_retryable)
from repro_torch.transport.wire import (WIRE_SUFFIX, TransportError,
                                        WireFormatError, decode_expert,
                                        encode_expert)


@dataclasses.dataclass
class TransportStats:
    publishes: int = 0
    fetches: int = 0
    range_fetches: int = 0
    bytes_out: int = 0
    bytes_in: int = 0
    bytes_wasted: int = 0
    fetch_seconds: float = 0.0
    retries: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


# Overall fetch deadline for the *current thread*, as a monotonic instant.
# ``_retrying`` (and the replicated fetch loop) arm it so backends that
# charge wall time — the simulated link above all — can refuse to start a
# transfer the caller will no longer wait for, instead of sleeping through
# an already-expired deadline (chaos sweeps with many blackouts would
# otherwise serially burn CI wall-clock).
_DEADLINE = threading.local()


def _deadline_remaining() -> Optional[float]:
    until = getattr(_DEADLINE, "until", None)
    return None if until is None else until - time.monotonic()


class ExpertTransport:
    """Named blob store for wire-format experts.

    Subclasses implement ``_put(name, blob)``, ``_get(name) -> bytes``
    and ``_names() -> list[str]``; this base class owns encode/decode,
    the :class:`TransportStats` ledger, and the uniform retry loop
    (``retry=`` a :class:`~repro_torch.transport.retry.RetryPolicy`).
    """

    default_rep = GOLOMB

    def __init__(self, retry: Optional[RetryPolicy] = None):
        self.retry = retry or DEFAULT_RETRY
        self.stats = TransportStats()
        self._stats_lock = threading.Lock()

    # ---- public API ----------------------------------------------------
    def publish(self, expert: Any, rep: Optional[str] = None) -> dict:
        """Encode ``expert`` (Expert or legacy artifact) and upload it.

        Returns ``{name, rep, nbytes}`` — ``nbytes`` is bytes-on-wire.
        """
        rep = rep or self.default_rep
        blob = encode_expert(expert, rep=rep)
        name = getattr(expert, "name", None) or "expert"
        self._put(name, blob)
        with self._stats_lock:
            self.stats.publishes += 1
            self.stats.bytes_out += len(blob)
        return {"name": name, "rep": rep, "nbytes": len(blob)}

    def _timed_get(self, name: str) -> bytes:
        """One fetch attempt with byte/latency accounting (bytes that
        arrive are charged even if decode later rejects them)."""
        t0 = time.perf_counter()
        blob = self._get(name)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.stats.fetches += 1
            self.stats.bytes_in += len(blob)
            self.stats.fetch_seconds += dt
        return blob

    def _retrying(self, name: str, attempt: Callable[[], Any],
                  retry: Optional[RetryPolicy] = None) -> Any:
        """Run ``attempt`` under the retry policy: retryable errors back
        off (seeded jitter, deterministic per name) and retry within the
        attempt/deadline budget; terminal errors raise immediately."""
        pol = retry or self.retry
        t0 = time.monotonic()
        prev_deadline = getattr(_DEADLINE, "until", None)
        if pol.deadline_s is not None:
            _DEADLINE.until = t0 + pol.deadline_s
        last: Optional[Exception] = None
        try:
            for i in range(pol.max_attempts):
                if i:
                    delay = pol.backoff_s(i - 1, name)
                    if (pol.deadline_s is not None
                            and time.monotonic() - t0 + delay
                            > pol.deadline_s):
                        raise DeadlineExceeded(
                            f"fetch of {name!r} would exceed the "
                            f"{pol.deadline_s}s deadline after {i} "
                            f"attempt(s); last error: {last}") from last
                    if delay:
                        time.sleep(delay)
                    with self._stats_lock:
                        self.stats.retries += 1
                try:
                    return attempt()
                except Exception as e:
                    if not is_retryable(e):
                        raise
                    last = e
            raise RetriesExhausted(
                f"fetch of {name!r} failed after {pol.max_attempts} "
                f"attempt(s); last error: {last}") from last
        finally:
            _DEADLINE.until = prev_deadline

    def fetch_bytes(self, name: str,
                    retry: Optional[RetryPolicy] = None) -> bytes:
        """Download the raw wire blob for ``name`` (no decode).  Retries
        transport-level failures; cannot see checksum corruption — use
        :meth:`fetch_expert` for the verified refetch-on-corruption path."""
        return self._retrying(name, lambda: self._timed_get(name), retry)

    def fetch_expert(self, name: str,
                     retry: Optional[RetryPolicy] = None
                     ) -> tuple[Expert, int]:
        """Download + decode + verify ``name``; returns ``(expert,
        bytes_on_wire)``, the expert's planes on the host.  The retry loop
        spans decode too, so a blob that arrives corrupt
        (``ChecksumError``) is *refetched* instead of failing the caller.
        Bytes that arrived but failed verification are charged to
        ``stats.bytes_wasted`` — they crossed the link and bought
        nothing."""
        def attempt():
            blob = self._timed_get(name)
            try:
                return (decode_expert(blob, name=name, device="cpu"),
                        len(blob))
            except WireFormatError:
                with self._stats_lock:
                    self.stats.bytes_wasted += len(blob)
                raise
        return self._retrying(name, attempt, retry)

    def get_range(self, name: str, start: int, length: int) -> bytes:
        """One ranged read of the stored blob: ``length`` bytes from
        absolute offset ``start``, clamped at end-of-blob (a probe larger
        than the blob returns the whole blob, never an error).

        No retry loop and no decode — this is the primitive the
        replicated CDN (:mod:`repro_torch.transport.replication`) builds its
        leaf-resumable fetch on; multi-replica callers own failover.
        Charged to ``stats.range_fetches`` / ``bytes_in``.
        """
        t0 = time.perf_counter()
        chunk = self._get_range(name, int(start), int(length))
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.stats.range_fetches += 1
            self.stats.bytes_in += len(chunk)
            self.stats.fetch_seconds += dt
        return chunk

    def fetch(self, name: str) -> Expert:
        """Download + decode ``name`` into an :class:`Expert` on the host
        (checksum verified; GOLOMB payloads stay lazily encoded on the
        Expert)."""
        return self.fetch_expert(name)[0]

    def names(self) -> list[str]:
        return self._names()

    def contains(self, name: str) -> bool:
        """Definitive membership: True/False when the backend can answer,
        :class:`ReplicaUnreachable` when it cannot — "the replica is
        down" is NOT "the expert is absent" (health accounting depends
        on the distinction)."""
        return name in self._names()

    def __contains__(self, name: str) -> bool:
        return self.contains(name)

    # ---- backend hooks -------------------------------------------------
    def _put(self, name: str, blob: bytes) -> None:
        raise NotImplementedError

    def _get(self, name: str) -> bytes:
        raise NotImplementedError

    def _get_range(self, name: str, start: int, length: int) -> bytes:
        # Fallback: fetch whole, slice locally.  Backends with a native
        # ranged read (file seek, HTTP Range) override this.
        return self._get(name)[start:start + length]

    def _names(self) -> list[str]:
        raise NotImplementedError


class InMemoryTransport(ExpertTransport):
    """Dict-backed store — unit tests and the simulated-network inner
    store."""

    def __init__(self, retry: Optional[RetryPolicy] = None):
        super().__init__(retry=retry)
        self._blobs: dict[str, bytes] = {}

    def _put(self, name: str, blob: bytes) -> None:
        self._blobs[name] = blob

    def _get(self, name: str) -> bytes:
        try:
            return self._blobs[name]
        except KeyError:
            raise ExpertNotFound(f"no published expert named {name!r}") \
                from None

    def _get_range(self, name: str, start: int, length: int) -> bytes:
        return self._get(name)[start:start + length]

    def _delete(self, name: str) -> None:
        self._blobs.pop(name, None)

    def _names(self) -> list[str]:
        return list(self._blobs)


class LocalTransport(ExpertTransport):
    """Filesystem backend: one ``<name>.cpft`` file per expert under
    ``root``.  Expert names must be filesystem-safe (they are used as
    file names verbatim)."""

    def __init__(self, root: str, retry: Optional[RetryPolicy] = None):
        super().__init__(retry=retry)
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name + WIRE_SUFFIX)

    def _put(self, name: str, blob: bytes) -> None:
        tmp = self._path(name) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._path(name))      # atomic: no torn reads

    def _get(self, name: str) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ExpertNotFound(
                f"no published expert named {name!r} under {self.root}") \
                from None

    def _get_range(self, name: str, start: int, length: int) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                f.seek(start)
                return f.read(length)
        except FileNotFoundError:
            raise ExpertNotFound(
                f"no published expert named {name!r} under {self.root}") \
                from None

    def _names(self) -> list[str]:
        return sorted(f[:-len(WIRE_SUFFIX)] for f in os.listdir(self.root)
                      if f.endswith(WIRE_SUFFIX))


class SimulatedNetworkTransport(ExpertTransport):
    """A link model in front of another transport.

    One ``_get`` attempt charges ``latency_s + nbytes / bandwidth_bps``
    of real wall time, and with probability ``loss`` the attempt is
    dropped (the full delay is still paid, then
    :class:`~repro_torch.transport.retry.TransientTransportError` surfaces and
    the base class's :class:`~repro_torch.transport.retry.RetryPolicy` decides
    whether to retry).  Seeded, so a benchmark run is reproducible.
    ``max_retries`` survives as a shorthand for ``retry=
    RetryPolicy(max_attempts=max_retries, backoff_base_s=0)`` — the link
    already charges latency per attempt, so the default adds no backoff.
    Publishing is free: the publisher's upload is not what the paper's
    per-query retrieval claim is about.
    """

    def __init__(self, bandwidth_bps: float = 1e9, latency_s: float = 0.0,
                 loss: float = 0.0, seed: int = 0,
                 inner: Optional[ExpertTransport] = None,
                 max_retries: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None):
        if retry is None:
            retry = (SIMULATED_RETRY if max_retries is None else
                     dataclasses.replace(SIMULATED_RETRY,
                                         max_attempts=max_retries))
        elif max_retries is not None:
            raise ValueError("pass either retry= or max_retries=, not both")
        super().__init__(retry=retry)
        if not (0.0 <= loss < 1.0):
            raise ValueError(f"loss must be in [0, 1), got {loss}")
        self.bandwidth_bps = float(bandwidth_bps)
        self.latency_s = float(latency_s)
        self.loss = float(loss)
        self.inner = inner or InMemoryTransport()
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

    def _delay(self, nbytes: int) -> float:
        return self.latency_s + nbytes / max(self.bandwidth_bps, 1.0)

    def _dropped(self) -> bool:
        if not self.loss:
            return False
        with self._rng_lock:
            return bool(self._rng.random() < self.loss)

    def _put(self, name: str, blob: bytes) -> None:
        self.inner._put(name, blob)

    def _transmit(self, name: str, nbytes: int) -> None:
        """Charge link time for ``nbytes``, honouring the caller's
        per-attempt timeout AND overall deadline, and roll the loss dice.

        If the sleep we are about to pay would outlive the thread's armed
        deadline, raise :class:`DeadlineExceeded` *without sleeping* —
        the caller has already given up on this fetch, so burning its
        wall-clock on the link model is pure waste (chaos CI sweeps hit
        this constantly).  Bytes that cross the link but never reach the
        caller (timeout partials, loss drops) are charged to
        ``stats.bytes_wasted``.
        """
        delay = self._delay(nbytes)
        timeout = self.retry.per_attempt_timeout_s
        sleep_s = delay if (timeout is None or delay <= timeout) else timeout
        remaining = _deadline_remaining()
        if remaining is not None and sleep_s > remaining:
            raise DeadlineExceeded(
                f"fetch of {name!r} needs {sleep_s:.3f}s of link time but "
                f"only {max(0.0, remaining):.3f}s of the deadline remain")
        if timeout is not None and delay > timeout:
            time.sleep(timeout)     # the attempt hangs until its budget
            arrived = int(max(0.0, timeout - self.latency_s)
                          * self.bandwidth_bps)
            with self._stats_lock:
                self.stats.bytes_wasted += min(nbytes, arrived)
            raise FetchTimeout(
                f"fetch of {name!r} needs {delay:.3f}s on this link, over "
                f"the {timeout}s per-attempt timeout")
        time.sleep(delay)
        if self._dropped():
            with self._stats_lock:
                self.stats.bytes_wasted += nbytes
            raise TransientTransportError(
                f"fetch of {name!r} dropped (loss={self.loss})")

    def _get(self, name: str) -> bytes:
        blob = self.inner._get(name)
        self._transmit(name, len(blob))
        return blob

    def _get_range(self, name: str, start: int, length: int) -> bytes:
        # Link time is charged per chunk: a leaf-granular resumable fetch
        # pays for exactly the bytes it requests, nothing more.
        chunk = self.inner._get_range(name, start, length)
        self._transmit(name, len(chunk))
        return chunk

    def _names(self) -> list[str]:
        return self.inner._names()


class HTTPTransport(ExpertTransport):
    """Fetch experts from ``<base_url>/<name>.cpft`` over HTTP(S).

    Read-mostly by design: any static file server fronting a
    :class:`LocalTransport` root works (see :func:`serve_local_http`).
    ``publish`` issues an HTTP PUT, which plain static servers reject —
    publish through the filesystem/object store behind the server instead.

    Failures are classified for the retry policy: 404 is a terminal
    :class:`ExpertNotFound` (the expert was never published), 5xx and
    socket timeouts are retryable, and a connection-level failure is
    :class:`ReplicaUnreachable` — retryable, and explicitly NOT the same
    thing as "absent" (see :meth:`contains`).
    """

    def __init__(self, base_url: str, timeout_s: float = 30.0,
                 retry: Optional[RetryPolicy] = None):
        super().__init__(retry=retry)
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _url(self, name: str) -> str:
        from urllib.parse import quote
        return f"{self.base_url}/{quote(name)}{WIRE_SUFFIX}"

    def _request(self, name: str, method: str,
                 headers: Optional[dict] = None):
        import socket
        import urllib.error
        import urllib.request
        req = urllib.request.Request(self._url(name), method=method,
                                     headers=headers or {})
        timeout = self.retry.per_attempt_timeout_s or self.timeout_s
        try:
            return urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise ExpertNotFound(
                    f"no expert {name!r} at {self._url(name)} "
                    f"(HTTP 404)") from e
            cls = (TransientTransportError if e.code >= 500
                   else TransportError)
            raise cls(
                f"HTTP {e.code} for expert {name!r} at {self._url(name)}") \
                from e
        except urllib.error.URLError as e:
            if isinstance(e.reason, (TimeoutError, socket.timeout)):
                raise FetchTimeout(
                    f"fetch of {name!r} from {self._url(name)} timed out "
                    f"after {timeout}s") from e
            raise ReplicaUnreachable(
                f"cannot reach {self._url(name)}: {e.reason}") from e
        except (TimeoutError, socket.timeout) as e:
            raise FetchTimeout(
                f"fetch of {name!r} from {self._url(name)} timed out "
                f"after {timeout}s") from e

    def _get(self, name: str) -> bytes:
        with self._request(name, "GET") as resp:
            return resp.read()

    def _get_range(self, name: str, start: int, length: int) -> bytes:
        """Ranged GET via an RFC 7233 ``Range`` header.

        A 206 body is the requested slice (clamped at end-of-file by the
        server).  A server that ignores Range answers 200 with the full
        blob — we slice locally and charge the surplus to
        ``stats.bytes_wasted``, so "zero extra bytes" claims stay honest
        against non-compliant origins."""
        if length <= 0:
            return b""
        hdrs = {"Range": f"bytes={start}-{start + length - 1}"}
        with self._request(name, "GET", headers=hdrs) as resp:
            body = resp.read()
            if resp.status == 206:
                return body
        chunk = body[start:start + length]
        with self._stats_lock:
            self.stats.bytes_wasted += len(body) - len(chunk)
        return chunk

    def _put(self, name: str, blob: bytes) -> None:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(self._url(name), data=blob,
                                     method="PUT")
        try:
            urllib.request.urlopen(req, timeout=self.timeout_s).close()
        except (urllib.error.URLError, OSError) as e:
            raise TransportError(
                f"HTTP publish to {self._url(name)} failed ({e}); static "
                "servers are read-only — publish via the store behind "
                "the server (e.g. LocalTransport on its root)") from e

    def contains(self, name: str) -> bool:
        """HEAD probe.  False ONLY on a definitive 404 ("the expert is
        absent"); an unreachable replica raises
        :class:`ReplicaUnreachable` instead of masquerading as absence —
        health accounting must never quarantine an expert because the
        probe could not be delivered."""
        try:
            resp = self._request(name, "HEAD")
        except ExpertNotFound:
            return False
        resp.close()
        return True

    def _names(self) -> list[str]:
        raise TransportError(
            "HTTPTransport cannot enumerate experts; fetch by name")


def _make_range_handler():
    import re
    from http.server import SimpleHTTPRequestHandler

    class RangeRequestHandler(SimpleHTTPRequestHandler):
        """SimpleHTTPRequestHandler + single-range ``Range: bytes=a-b``
        support (RFC 7233): answers 206 Partial Content with the
        requested slice, clamped at end-of-file.  This is what makes the
        replicated CDN's leaf-resumable fetch work over plain HTTP."""

        _range_re = re.compile(r"bytes=(\d+)-(\d*)$")

        def log_message(self, *a):        # keep test output quiet
            pass

        def do_GET(self):
            m = self._range_re.match(self.headers.get("Range", ""))
            if not m:
                return super().do_GET()
            path = self.translate_path(self.path)
            try:
                f = open(path, "rb")
            except OSError:
                self.send_error(404, "File not found")
                return
            try:
                size = os.fstat(f.fileno()).st_size
                start = int(m.group(1))
                end = int(m.group(2)) if m.group(2) else size - 1
                end = min(end, size - 1)
                if start >= size or start > end:
                    self.send_error(
                        416, "Requested Range Not Satisfiable")
                    return
                length = end - start + 1
                self.send_response(206)
                self.send_header("Content-Type",
                                 self.guess_type(path))
                self.send_header("Accept-Ranges", "bytes")
                self.send_header("Content-Range",
                                 f"bytes {start}-{end}/{size}")
                self.send_header("Content-Length", str(length))
                self.end_headers()
                f.seek(start)
                self.wfile.write(f.read(length))
            finally:
                f.close()

    return RangeRequestHandler


def serve_local_http(root: str, host: str = "127.0.0.1", port: int = 0):
    """Serve a :class:`LocalTransport` root over HTTP in a daemon thread.

    Returns ``(server, base_url)``; call ``server.shutdown()`` when done.
    Pairs a filesystem publisher with :class:`HTTPTransport` consumers
    (the tests and ``chip_smoke.py`` phase 3r use it, on loopback).
    Answers ``Range`` requests with 206 Partial Content, so
    :meth:`HTTPTransport.get_range` (and the replicated CDN's resumable
    fetch on top of it) transfers only the requested bytes.
    """
    import functools
    from http.server import ThreadingHTTPServer
    handler = functools.partial(_make_range_handler(), directory=root)
    server = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"
