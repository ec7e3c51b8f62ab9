"""Kernel 1 (``ternary_matmul_grouped``): the least time that the traced
slice's overlay products need (``cardbench/work/ternary_matmul_grouped.py``
at 989 TFLOP/s and 3.35 TB/s) over the kernel's device time."""

from cardbench.lib import layers


def read(rec):
    return layers.ternary_roofline(rec)
