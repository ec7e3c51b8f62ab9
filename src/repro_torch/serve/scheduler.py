"""Admission scheduling for the serving engine of the port: FIFO.

A copy of ``FIFOScheduler`` from ``repro/serve/scheduler.py`` (the port
never imports the JAX package, whose ``serve`` package pulls in the
engine and JAX).  The wave builder takes requests from the head until the
batch or the expert-stack budget fills; a slot refill considers the head
only, and a head that cannot be placed blocks every request behind it
(``strict_fifo``), which is what the reference's parity gates compare
against.

The scheduler only orders and releases work; whether a request can be
placed (stack budget, ring position) is the engine's call.  Requests carry
``arrival_s`` (seconds on the engine clock): a request is invisible to wave
building until its arrival time has passed.  The priority and affinity
schedulers come with ROADMAP queue 1, item 7.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

__all__ = ["FIFOScheduler", "SCHEDULERS", "make_scheduler"]


class FIFOScheduler:
    """Arrival-order admission with head-of-line blocking."""

    name = "fifo"
    strict_fifo = True

    def __init__(self):
        self._ready: deque = deque()
        self._future: list = []        # arrival_s in the engine's future
        self.queue_depth_max = 0
        self.deferred = 0              # placeable-skips (non-FIFO only)

    # -- intake -----------------------------------------------------------

    def push(self, r) -> None:
        if getattr(r, "arrival_s", 0.0) and r.arrival_s > 0.0:
            self._future.append(r)
            self._future.sort(key=lambda x: (x.arrival_s, x.uid))
        else:
            self._ready.append(r)
        self._note_depth()

    def release(self, now: float) -> None:
        """Move every request whose arrival time has passed into the ready
        set (arrival order)."""
        while self._future and self._future[0].arrival_s <= now:
            self._ready.append(self._future.pop(0))
        self._note_depth()

    def _note_depth(self) -> None:
        self.queue_depth_max = max(self.queue_depth_max, len(self._ready))

    # -- queries ----------------------------------------------------------

    def pending(self) -> int:
        return len(self._ready) + len(self._future)

    def ready_count(self) -> int:
        return len(self._ready)

    def next_arrival(self) -> Optional[float]:
        return self._future[0].arrival_s if self._future else None

    def peek(self, n: int) -> list:
        """Upcoming requests in admission order."""
        out = list(self._ready)[:n]
        if len(out) < n:
            out += self._future[:n - len(out)]
        return out

    # -- wave building -----------------------------------------------------

    def take_wave(self, max_batch: int, max_stack: int) -> tuple:
        """Pop the next wave: take from the head until the batch fills or
        the head names an expert that would exceed the stack budget."""
        wave: list = []
        experts: list = []
        while self._ready and len(wave) < max_batch:
            r = self._ready[0]
            if r.expert not in experts and len(experts) >= max_stack:
                break                          # over-capacity: next wave
            if r.expert not in experts:
                experts.append(r.expert)
            wave.append(self._ready.popleft())
        return wave, experts

    # -- slot-refill admission --------------------------------------------

    def candidates(self, slot: dict) -> list:
        """Requests the engine may place into a finished slot, in order.
        FIFO considers the head only (head-of-line semantics)."""
        return [self._ready[0]] if self._ready else []

    def remove(self, r) -> None:
        try:
            self._ready.remove(r)
        except ValueError:
            self._future.remove(r)

    def note_deferred(self, reason: str = "") -> None:
        self.deferred += 1

    def stats(self) -> dict:
        return {"policy": self.name,
                "queue_depth_max": self.queue_depth_max,
                "deferred": self.deferred}


SCHEDULERS = {FIFOScheduler.name: FIFOScheduler}


def make_scheduler(name: str):
    if name in SCHEDULERS:
        return SCHEDULERS[name]()
    if name in ("priority", "affinity"):
        raise NotImplementedError(
            f"scheduler={name!r}: priority and affinity scheduling come with "
            "ROADMAP queue 1, item 7")
    raise ValueError(f"unknown scheduler {name!r}; expected one of "
                     f"{sorted(SCHEDULERS)}")
