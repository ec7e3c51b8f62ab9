"""The work of kernel 4 (``unpack_add_many``, merge-on-swap), from the
configuration's shapes: one swap writes ``round(base + scale * (pos -
neg))`` for every leaf the expert carries.  It needs each base element
read once, each merged element written once, and the planes at 2 bits a
weight read once."""

NEEDLES = ("unpack_add_kernel",)


def swap(leaves: list) -> tuple:
    """(operations, bytes) of one swap over [(element count, bytes per
    element)] of the expert's leaves.  The adds are not counted as
    operations at the tensor-core rate: the merge is bound by bytes."""
    nbytes = sum(2 * n * size + 2 * 4 * -(-n // 32) for n, size in leaves)
    return 0, nbytes
