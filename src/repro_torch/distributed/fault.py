"""Straggler monitoring: port of ``StragglerMonitor`` from
``repro/distributed/fault.py``.

The remote expert tiers feed it promotion and ranged-read latencies
(:class:`~repro_torch.serve.expert_cache.DeviceCache`,
:class:`~repro_torch.transport.replication.ReplicatedTransport`).  The
rest of the reference's file (failure injection, the elastic and
serve-side restart plans) comes with ROADMAP queue 1, item 9.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional


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
