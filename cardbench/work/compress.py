"""The work of the compression kernels (``segment_absmax``, the two
``segment_hist_moments`` sweeps and ``pack_ternary_planes_segmented``),
from the configuration's shapes.

What one compression needs of them: the task vector's f32 elements read
once and the two sign planes (2 bits an element) written once.  The
passes that the two-pass histogram adds (absmax, then coarse and refine
sweeps, then the pack, each reading the segment buffer) are the design's
cost, not the input's: a design that reads the vector fewer times reads
nearer 100%.
"""

NEEDLES = ("absmax_kernel", "hist_sweep_kernel", "segment_moments_kernel",
           "pack_rows_kernel", "pack_scalar_kernel")


def compression(sizes: list) -> tuple:
    """(operations, bytes) of one compression of leaves of ``sizes``
    elements."""
    return 0, sum(4 * n + 2 * 4 * -(-n // 32) for n in sizes)

