"""Fault tolerance: failure injection, straggler monitoring, and the
elastic and serve-side restart contracts.

Port of ``repro/distributed/fault.py``.  The remote expert tiers feed
:class:`StragglerMonitor` promotion and ranged-read latencies
(:class:`~repro_torch.serve.expert_cache.DeviceCache`,
:class:`~repro_torch.transport.replication.ReplicatedTransport`);
:class:`FailureInjector` raises :class:`SimulatedFailure` at chosen steps,
so a recovery path is testable; ``ServeEngine.resume`` returns a
:class:`RecoveryPlan` in ``recovery_stats["plan"]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss / device error during a step."""


@dataclasses.dataclass
class FailureInjector:
    """Raise SimulatedFailure at the configured global steps (once each)."""

    fail_at_steps: Sequence[int] = ()

    def __post_init__(self):
        self._pending = set(self.fail_at_steps)

    def check(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker: a step slower than ``slowdown_threshold``
    x the EWMA is flagged (and kept out of the EWMA); the flag count
    becomes a recommendation.

    slowdown_threshold: flag a step slower than threshold x EWMA.
    """

    MAX_FLAGGED = 256        # ring cap: week-long runs must not leak

    alpha: float = 0.2
    slowdown_threshold: float = 2.0
    ewma: Optional[float] = None
    flagged_steps: list = dataclasses.field(default_factory=list)
    flags: int = 0           # total flag count (survives the ring cap)

    def observe(self, step: int, seconds: float) -> bool:
        is_straggler = (self.ewma is not None
                        and seconds > self.slowdown_threshold * self.ewma)
        if is_straggler:
            self.flags += 1
            if len(self.flagged_steps) >= self.MAX_FLAGGED:
                del self.flagged_steps[0]
            self.flagged_steps.append((step, seconds, self.ewma))
        # stragglers don't poison the EWMA
        if not is_straggler:
            self.ewma = (seconds if self.ewma is None
                         else self.alpha * seconds
                         + (1 - self.alpha) * self.ewma)
        return is_straggler

    @contextlib.contextmanager
    def probe(self, step: int):
        """Time a step with the monotonic clock and observe it (a
        wall-clock jump is never a straggler)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.observe(step, time.monotonic() - t0)

    def recommendation(self) -> str:
        if self.flags >= 3:
            return "exclude-host-and-reshard"
        if self.flags:
            return "monitor"
        return "healthy"


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Restart contract: a checkpoint saved under one device layout
    restores under another when (1) arrays are logical and on the host on
    disk, (2) the data pipeline is stateless in ``step``, and (3)
    placements are re-derived from the new layout.
    :func:`repro_torch.checkpoint.manager.restore` (``device=``) does (1)
    and (3)."""

    old_shape: tuple
    new_shape: tuple

    def valid(self) -> bool:
        # any layout works as long as every extent is positive
        return all(x > 0 for x in self.new_shape)


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """Serve-side restart accounting (snapshot -> journal -> replay).

    A killed engine resumes when (1) the journal names every request and
    every emitted token, (2) the snapshot restores the in-flight wave's
    KV at a chunk boundary, and (3) streams are pure functions of (seed,
    uid, draw index), so everything past the restored state regenerates
    the same tokens.  ``ServeEngine.resume`` returns one of these in
    ``recovery_stats["plan"]``.
    """

    snapshot_step: Optional[int]   # restored snapshot (None = journal-only)
    journal_records: int           # intact journal records replayed
    replayed_rows: int             # rows continued from restored KV
    reprefilled_rows: int          # rows whose KV postdated the snapshot

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
