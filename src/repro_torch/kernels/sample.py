"""Gumbel-max sampling on JAX's threefry stream: CUDA kernel wrapper +
plain version.

The last two steps of sampled token selection
(``repro_torch.serve.decode_loop.select_tokens``): for scaled, top-k
masked logits x [B, V] f32, per-row keys [B, 2] and stream positions gen
[B] (int64 holding 32-bit words),

    out[b] = first argmax over v of x[b, v] + noise[b, v],
    noise[b] = gumbel(fold_in(keys[b], gen[b]), [V])

which is ``jax.random.categorical`` as the reference calls it.  The plain
version is :mod:`repro_torch.serve.sampling` plus ``torch.argmax``; the
kernel is ``csrc/sample.cu``, bitwise equal to it (noise and tokens).
The reference computes this step in jnp and ``jax.random`` (no Pallas).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

H100_SMS = 132          # streaming multiprocessors of the target card
SPAN_THREADS = 256      # threads per block of the span kernel


def sample_gumbel_argmax_plain(x: torch.Tensor, keys: torch.Tensor,
                               gen: torch.Tensor, noise: bool = False):
    """The plain version: tokens [B] int32, and with ``noise`` the gumbel
    noise [B, V] f32 too."""
    # imported here: the serve package imports the kernels at its import
    from repro_torch.serve import sampling
    g = sampling.gumbel(sampling.fold_in(keys, gen), x.shape[-1])
    tok = torch.argmax(x + g, dim=-1).to(torch.int32)
    return (tok, g) if noise else tok


def launch_chunks(B: int, V: int) -> int:
    """Spans per row: about two blocks per SM over the batch, and at least
    four elements per thread.  Any count gives the same tokens."""
    return max(1, min(-(-2 * H100_SMS // max(B, 1)),
                      -(-V // (4 * SPAN_THREADS))))


def sample_gumbel_argmax(x: torch.Tensor, keys: torch.Tensor,
                         gen: torch.Tensor, noise: bool = False):
    """x [B, V] f32, keys [B, 2] int64, gen [B] int64 (all contiguous, on
    one device) -> tokens [B] int32 (and, with ``noise``, the noise [B, V]
    f32 the draw added, for checks).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    if x.device.type == "cpu":
        return sample_gumbel_argmax_plain(x, keys, gen, noise)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [B, V] float32 tensor")
    B, V = x.shape
    if V >= 2 ** 31:
        raise ValueError(f"V = {V}: token ids must fit an int32")
    for t, shape in ((keys, (B, 2)), (gen, (B,))):
        if (t.dtype != torch.int64 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"keys and gen must be contiguous int64 {(B, 2)}"
                             f" and {(B,)} on x's device; got {t.dtype} "
                             f"{tuple(t.shape)}")
    chunks = launch_chunks(B, V)
    part_val = torch.empty((B, chunks), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((B, chunks), dtype=torch.int32, device=x.device)
    out = torch.empty((B,), dtype=torch.int32, device=x.device)
    g = torch.empty_like(x) if noise else None
    lib = build.library("sample")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.sample_gumbel_argmax(x.data_ptr(), keys.data_ptr(),
                                  gen.data_ptr(), B, V, chunks,
                                  part_val.data_ptr(), part_idx.data_ptr(),
                                  out.data_ptr(),
                                  g.data_ptr() if noise else None, stream)
    build.check(rc, "sample_gumbel_argmax")
    sample_gumbel_argmax.launches += 1
    return (out, g) if noise else out


sample_gumbel_argmax.launches = 0
