"""The traced slice of a window: ``torch.profiler`` on the card, reduced
to what the per-layer metrics read.

The profiler starts and stops at host points where the device is idle
(a serving cell's chunk flushes, a compression's synchronise), so the
work attributed to the slice is exactly the work between them.  The
reduction reads the raw kineto events (no event tree is built): each
device kernel's name, start and length, and the host operations that
were open when the device went idle.
"""

from __future__ import annotations

import time
from collections import defaultdict

ANNOTATIONS = ("gpu_user_annotation",)


class Slice:
    """Starts the profiler at :meth:`start` and stops it at :meth:`stop`;
    :meth:`reduce` gives the kernels and the busy time."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop()

    def reduce(self) -> dict:
        """{window_s, busy_s, kernels: {name: [seconds, count]},
        intervals: [(start_ns, end_ns, name)], device_ops, idle_gaps}."""
        import torch
        evs = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        kern, host = [], []
        for e in evs:
            name = e.name()
            if e.device_type() == cuda:
                if name in ANNOTATIONS or e.duration_ns() <= 0:
                    continue
                kern.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             name))
            elif e.duration_ns() > 0:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             name))
        kern.sort()
        by = defaultdict(lambda: [0.0, 0])
        for s, t, n in kern:
            by[n][0] += (t - s) / 1e9
            by[n][1] += 1
        busy, gaps = 0.0, []
        cur_s = cur_t = None
        for s, t, _ in kern:
            if cur_t is None or s > cur_t:
                if cur_t is not None:
                    busy += cur_t - cur_s
                    gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_t is not None:
            busy += cur_t - cur_s
        window_s = self.t1 - self.t0
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = []
        for a, b in gaps[:10]:
            # the innermost host operation open at the gap's middle
            mid = (a + b) // 2
            open_ops = [(t - s, n) for s, t, n in host if s <= mid <= t]
            label = min(open_ops)[1] if open_ops else "host, no operation"
            idle.append([label, (b - a) / 1e9])
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:10]
        return {"window_s": window_s, "busy_s": busy / 1e9,
                "kernels": {k: list(v) for k, v in by.items()},
                "intervals": kern,
                "device_ops": [[k, v[0]] for k, v in top],
                "idle_gaps": idle}


def kernel_seconds(red: dict, *needles: str) -> float:
    """Device seconds of the kernels whose names hold any needle."""
    return sum(v[0] for k, v in red["kernels"].items()
               if any(n in k for n in needles))
