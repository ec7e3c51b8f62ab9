"""The work of kernel 1 (``ternary_matmul_grouped``, the zero-merge
overlay's per-row ternary delta product), from the configuration's shapes.

Every projection that the overlay serves (q, k, v, o, gate, up, down of
every unit, and the head: the tied head through the transposed form) computes
``x[m] @ T_e(m)`` for each token row m.  What the inputs need, per call:

* operations: 2 K N per row and projection (a sum of +-1 terms);
* bytes: the planes of each distinct expert in the call once, at 2 bits a
  weight; the rows' f32 inputs read once and f32 outputs written once.
"""

NEEDLES = ("grouped_kernel", "grouped_t_kernel")


def projections(cfg: dict) -> list:
    """[(K, N)] of one token's kernel-1 products."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    unit = [(d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f), (f, d)]
    return unit * cfg["num_hidden_layers"] + [(d, cfg["vocab_size"])]


def call(cfg: dict, rows: int, experts: int) -> tuple:
    """(operations, bytes) of one pass of ``rows`` token rows holding
    ``experts`` distinct experts through every projection."""
    p = projections(cfg)
    kn = sum(k * n for k, n in p)
    io = sum(k + n for k, n in p)
    return 2 * rows * kn, experts * kn / 4 + rows * io * 4
