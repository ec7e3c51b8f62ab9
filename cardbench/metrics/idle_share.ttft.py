"""The device's idle share of the traced slice: 1 - (union of the kernel
intervals in the profiler's trace) / the slice's length."""

from cardbench.lib import layers


def read(rec):
    return layers.idle_share(rec)
