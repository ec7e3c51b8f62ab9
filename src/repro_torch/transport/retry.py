"""Retry/backoff policy and the transport error taxonomy: port of
``repro/transport/retry.py``, pure numpy, so a schedule equals the
reference's for the same seed.

The paper's headline scenario fetches experts *per query over
high-latency networks* — links that time out, drop packets, and corrupt
payloads.  Fault tolerance starts with naming the failures precisely:

**Retryable** (another attempt can plausibly succeed):

* :class:`TransientTransportError` — seeded loss on a simulated link,
  HTTP 5xx, an injected chaos fault.
* :class:`FetchTimeout`            — a single attempt exceeded its
  per-attempt timeout.
* :class:`ReplicaUnreachable`      — connection refused / DNS failure /
  URLError: the *replica* is down, which says nothing about whether the
  expert exists.
* :class:`~repro_torch.transport.wire.ChecksumError` — the blob arrived but
  failed CRC (torn or bit-flipped transfer): a **refetch** is the fix.

**Terminal** (retrying cannot help):

* :class:`ExpertNotFound`  — a definitive 404 / missing file / absent
  key: the expert was never published.  Distinct from
  :class:`ReplicaUnreachable` on purpose, so health accounting never
  quarantines an expert that simply does not exist.
* :class:`~repro_torch.transport.wire.WireFormatError` (non-checksum) — bad
  magic / unsupported version / malformed manifest: the published blob
  itself is wrong.

:class:`RetryPolicy` drives the uniform retry loop in
:class:`~repro_torch.transport.backends.ExpertTransport`: bounded attempts,
exponential backoff with **seeded** jitter (deterministic per (seed,
name, attempt) — no shared RNG state, so concurrent prefetch threads
cannot perturb each other's schedules), an optional per-attempt timeout
and an optional overall deadline.  Exhaustion surfaces as
:class:`RetriesExhausted` / :class:`DeadlineExceeded`, both terminal.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np

from repro_torch.transport.wire import (ChecksumError, TransportError,
                                        WireFormatError)


class TransientTransportError(TransportError):
    """A retryable failure: the next attempt can plausibly succeed."""


class FetchTimeout(TransientTransportError):
    """One fetch attempt exceeded its per-attempt timeout."""


class ReplicaUnreachable(TransientTransportError):
    """The replica/origin cannot be reached (connection refused, DNS,
    URLError).  Says nothing about whether the expert exists."""


class ExpertNotFound(TransportError):
    """Terminal: the expert was never published (definitive 404 /
    missing file / absent key) — retrying cannot help."""


class RetriesExhausted(TransportError):
    """The retry budget (``max_attempts``) ran out; carries the last
    underlying error in its message and ``__cause__``."""


class DeadlineExceeded(TransportError):
    """The overall fetch deadline (``deadline_s``) would be crossed."""


def is_retryable(exc: BaseException) -> bool:
    """Classify one transport-layer exception.

    ``ChecksumError`` is checked before its ``WireFormatError`` parent:
    a failed CRC means the *transfer* was torn (refetch), while the
    other wire-format errors mean the *blob* is wrong (terminal).
    """
    if isinstance(exc, ChecksumError):
        return True
    if isinstance(exc, (ExpertNotFound, RetriesExhausted, DeadlineExceeded,
                        WireFormatError)):
        return False
    if isinstance(exc, TransientTransportError):
        return True
    return False        # unknown errors (incl. bare TransportError): terminal


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Uniform retry/backoff contract for every transport backend.

    ``backoff_s(attempt, name)`` is pure and seeded: the jitter draw is
    keyed by ``(seed, crc32(name), attempt)``, so a retry schedule is
    bit-reproducible across runs and indifferent to thread interleaving
    — the property the chaos harness gates on.
    """

    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_multiplier: float = 2.0
    jitter: float = 0.1                      # +- fraction of the base delay
    per_attempt_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None       # overall budget across attempts
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")

    def backoff_s(self, attempt: int, name: str = "") -> float:
        """Delay before retry number ``attempt`` (0-based) of ``name``."""
        base = self.backoff_base_s * self.backoff_multiplier ** attempt
        if not base:
            return 0.0
        if not self.jitter:
            return base
        rng = np.random.default_rng(
            (self.seed, zlib.crc32(name.encode("utf-8")), attempt))
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


#: Default policy for real backends (HTTP / filesystem).
DEFAULT_RETRY = RetryPolicy()

#: Default for :class:`SimulatedNetworkTransport` — immediate retries,
#: matching the historical loss-model loop (the link already charges
#: latency per attempt, so added backoff would double-count it).
SIMULATED_RETRY = RetryPolicy(max_attempts=5, backoff_base_s=0.0)
