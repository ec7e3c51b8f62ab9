"""Quickstart on the PyTorch port: ComPEFT in 60 seconds, through the
``repro_torch.api`` facade.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cuda]

One ``Expert`` artifact moves across the whole representation lattice:
DENSE (task vector) -> TERNARY -> PACKED (2-bit bitplanes) -> GOLOMB
(wire format), with storage accounting at every stop, plus the bitwise
expert-similarity ops and a save/load round trip.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.ternary_ops import cosine_similarity, scaled_dot
from repro_torch.expert import DENSE, GOLOMB, PACKED, TERNARY


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    # a fake fine-tuning residual: near-zero Gaussian (paper App. B.4)
    tau = {"layer0/wq": torch.as_tensor(rng.normal(0, 7e-4, (512, 512)),
                                        dtype=torch.float32),
           "layer0/wo": torch.as_tensor(rng.normal(0, 7e-4, (512, 512)),
                                        dtype=torch.float32)}

    print("== Algorithm 1: sparsify + ternary-quantize (k=5%, alpha=1) ==")
    ex = api.compress(tau, name="quickstart", density=0.05, alpha=1.0,
                      device=args.device)
    s = ex.summary()
    print(f"  params            : {s['n_params']:,}")
    print(f"  surviving (nnz)   : {s['nnz']:,}  (density {s['density']:.3f})")
    print(f"  dense bf16        : {s['dense_bits']/8/1024:.1f} KiB")
    print(f"  entropy bound     : {s['entropy_bits']/8/1024:.1f} KiB "
          f"({s['compression_x_entropy']:.1f}x)")
    print(f"  bitplane (compute): {s['bitplane_bits']/8/1024:.1f} KiB "
          f"({s['compression_x_bitplane']:.1f}x)")
    print(f"  reconstruction err: {s['rel_recon_err']:.3f} (relative)")

    print("\n== Representation lattice (one artifact, four forms) ==")
    for rep in (DENSE, TERNARY, PACKED, GOLOMB):
        print(f"  nbytes({rep:7s})   : {ex.nbytes(rep):,}")

    print("\n== Golomb round trip (storage format) ==")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "quickstart_expert.npz")
        stats = ex.save(out)
        back = api.load(out, device=args.device)
        pt, bpt = ex.packed["layer0/wq"], back.packed["layer0/wq"]
        assert torch.equal(pt.pos, bpt.pos) and torch.equal(pt.neg, bpt.neg)
    print(f"  saved {os.path.basename(out)}: {stats['compressed_bytes']:,} "
          f"bytes ({stats['ratio']:.1f}x vs bf16); save/load round-trip "
          "exact")

    print("\n== Bitwise expert algebra (AND/XOR + POPCNT) ==")
    a = ex.packed["layer0/wq"]
    print(f"  packed bytes       : {ex.nbytes(PACKED):,}")
    print(f"  self cosine        : {float(cosine_similarity(a, a)):.3f}")
    print(f"  self scaled dot    : {float(scaled_dot(a, a)):.3e}")

    print("\n== Reconstruct -> dense delta ==")
    dense = ex.to_dense_tau()
    vals = torch.unique(dense["layer0/wq"]).cpu().numpy()
    print(f"  unique values in reconstructed leaf: {vals}")
    print("\nOK")


if __name__ == "__main__":
    main()
