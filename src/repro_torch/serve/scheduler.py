"""Admission scheduling for the serving engine of the port.

A copy of ``repro/serve/scheduler.py`` (the port never imports the JAX
package, whose ``serve`` package pulls in the engine and JAX):

* :class:`FIFOScheduler`: the wave builder takes requests from the head
  until the batch or the expert-stack budget fills; a slot refill
  considers the head only, and a head that cannot be placed blocks every
  request behind it (``strict_fifo``), which is what the reference's
  parity gates compare against.
* :class:`PriorityScheduler`: priority classes (lower is more urgent),
  earliest deadline first inside a class, arrival order after that; the
  engine scans past a candidate it cannot place, so a blocked head defers
  only itself.
* :class:`AffinityScheduler`: priority order plus expert-affinity wave
  packing: the previous wave's experts first (sticky), then the most
  backlogged, then the most urgent; the expert tuple in sorted order, so
  repeat traffic finds its experts' slots filled; refills prefer requests
  whose expert the wave already holds.

The scheduler only orders and releases work; whether a request can be
placed (stack budget, ring position, KV blocks) is the engine's call.
Requests carry ``arrival_s`` (seconds on the engine clock): a request is
invisible to wave building until its arrival time has passed
(:mod:`repro_torch.serve.traffic` makes such timelines).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

__all__ = ["FIFOScheduler", "PriorityScheduler", "AffinityScheduler",
           "SCHEDULERS", "make_scheduler"]


class FIFOScheduler:
    """Arrival-order admission with head-of-line blocking."""

    name = "fifo"
    strict_fifo = True

    def __init__(self):
        self._ready: deque = deque()
        self._future: list = []        # arrival_s in the engine's future
        self.queue_depth_max = 0
        self.deferred = 0              # placeable-skips (non-FIFO only)
        # decision hook, as the reference's (its journal sets it; the
        # port has no journal yet): None is a no-op
        self.on_decision = None

    def _note_wave(self, wave: list, experts: list) -> None:
        """Report one take_wave decision to the hook."""
        if self.on_decision is not None and wave:
            self.on_decision({"event": "take_wave", "policy": self.name,
                              "uids": [r.uid for r in wave],
                              "experts": list(experts)})

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
        self._note_wave(wave, experts)
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


class PriorityScheduler(FIFOScheduler):
    """Priority classes (lower value is more urgent), earliest deadline
    first inside a class, FIFO inside equal (priority, deadline).

    ``strict_fifo = False``: the engine scans past candidates it cannot
    place, so a blocked head (KV blocks exhausted, over-stack expert)
    defers only itself."""

    name = "priority"
    strict_fifo = False

    @staticmethod
    def _key(r):
        dl = r.deadline_s if r.deadline_s is not None else math.inf
        return (r.priority, dl, r.arrival_s, r.uid)

    def take_wave(self, max_batch: int, max_stack: int) -> tuple:
        wave: list = []
        experts: list = []
        for r in sorted(self._ready, key=self._key):
            if len(wave) >= max_batch:
                break
            if r.expert not in experts and len(experts) >= max_stack:
                self.deferred += 1             # skipped, not blocking
                continue
            if r.expert not in experts:
                experts.append(r.expert)
            wave.append(r)
        for r in wave:
            self._ready.remove(r)
        self._note_wave(wave, experts)
        return wave, experts

    def candidates(self, slot: dict) -> list:
        return sorted(self._ready, key=self._key)


class AffinityScheduler(PriorityScheduler):
    """Priority ordering plus expert-affinity wave packing.

    A wave takes at most ``max_stack`` experts, preferring the previous
    wave's (sticky), then the most backlogged, then the most urgent, and
    fills the batch from those experts' requests in priority order.  The
    expert tuple comes out sorted, so two waves of one expert set present
    the same tuple.  Refills prefer requests whose expert is already in
    the wave (no new slot)."""

    name = "affinity"

    def __init__(self):
        super().__init__()
        self._last_experts: frozenset = frozenset()

    def take_wave(self, max_batch: int, max_stack: int) -> tuple:
        by_expert: dict = {}
        for r in self._ready:
            by_expert.setdefault(r.expert, []).append(r)
        if not by_expert:
            return [], []

        def escore(e):
            sticky = 0 if e in self._last_experts else 1
            best = min(self._key(r) for r in by_expert[e])
            return (sticky, -len(by_expert[e]), best)

        chosen = set(sorted(by_expert, key=escore)[:max_stack])
        pool = sorted((r for e in chosen for r in by_expert[e]),
                      key=self._key)
        wave = pool[:max_batch]
        skipped = len(self._ready) - len(pool)
        if skipped > 0:
            self.deferred += skipped
        for r in wave:
            self._ready.remove(r)
        # sorted: identical expert sets give identical tuples wave after
        # wave
        experts = sorted({r.expert for r in wave})
        self._last_experts = frozenset(experts)
        self._note_wave(wave, experts)
        return wave, experts

    def candidates(self, slot: dict) -> list:
        inside = [r for r in self._ready if r.expert in slot]
        outside = [r for r in self._ready if r.expert not in slot]
        return sorted(inside, key=self._key) + sorted(outside, key=self._key)


SCHEDULERS = {c.name: c for c in
              (FIFOScheduler, PriorityScheduler, AffinityScheduler)}


def make_scheduler(name: str):
    try:
        return SCHEDULERS[name]()
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"expected one of {sorted(SCHEDULERS)}") from None
