"""Sampled token selection on JAX's threefry stream: CUDA kernel wrapper +
plain version.

The sampled branch of ``repro_torch.serve.decode_loop.select_tokens``,
whole: for logits [B, V] (f32 or bf16), per-row keys [B, 2] and stream
positions gen [B] (int64 holding 32-bit words), a temperature T and a
``top_k``,

    x[b]     = f32(logits[b]) / max(T, 1e-6)
    x[b, v]  = -inf where x[b, v] < the top_k-th largest of x[b]
               (when 0 < top_k < V)
    out[b]   = first argmax over v of x[b, v] + noise[b, v],
    noise[b] = gumbel(fold_in(keys[b], gen[b]), [V])

which is the reference's ``lax.top_k`` mask and ``jax.random.categorical``
as it calls them.  The plain version is that sequence in PyTorch
(:func:`scale_and_mask`, then :mod:`repro_torch.serve.sampling` plus
``torch.argmax``); the kernel is ``csrc/sample.cu``, one launch per call,
bitwise equal to it (tokens, and noise).  The reference computes this
step in jnp, ``lax.top_k`` and ``jax.random`` (no Pallas).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

H100_SMS = 132          # streaming multiprocessors of the target card
SPAN_THREADS = 256      # threads per block of the no-cut kernel
MAX_ROWS = 65535        # rows per launch (the grid's y dimension)


def _check_top_k(top_k: int) -> int:
    if top_k < 0:
        raise ValueError(f"top_k = {top_k}: must be >= 0 (0: no cut)")
    return int(top_k)


def scale_and_mask(logits: torch.Tensor, temperature: float,
                   top_k: int) -> torch.Tensor:
    """The first three steps, plain: logits [B, V] widened to f32 and
    divided by ``max(temperature, 1e-6)``, every value below the
    ``top_k``-th largest (counted with multiplicity; ties all stay) set to
    -inf when ``0 < top_k < V``."""
    top_k = _check_top_k(top_k)
    x = logits.to(torch.float32)
    # a tensor divisor: torch would multiply by the reciprocal of a Python
    # scalar on the card, where jnp divides
    scaled = x / x.new_full((1, 1), max(temperature, 1e-6))
    if top_k and top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    return scaled


def sample_gumbel_argmax_plain(x: torch.Tensor, keys: torch.Tensor,
                               gen: torch.Tensor, noise: bool = False):
    """The draw alone, plain: tokens [B] int32 of argmax(x + gumbel), and
    with ``noise`` the gumbel noise [B, V] f32 too."""
    # imported here: the serve package imports the kernels at its import
    from repro_torch.serve import sampling
    g = sampling.gumbel(sampling.fold_in(keys, gen), x.shape[-1])
    tok = torch.argmax(x + g, dim=-1).to(torch.int32)
    return (tok, g) if noise else tok


def sample_tokens_plain(logits: torch.Tensor, keys: torch.Tensor,
                        gen: torch.Tensor, temperature: float, top_k: int,
                        noise: bool = False):
    """The plain version: tokens [B] int32, and with ``noise`` the gumbel
    noise [B, V] f32 too."""
    return sample_gumbel_argmax_plain(
        scale_and_mask(logits, temperature, top_k), keys, gen, noise)


def launch_chunks(B: int, V: int) -> int:
    """Spans per row without a cut: about two blocks per SM over the
    batch, and at least four elements per thread.  Any count gives the
    same tokens."""
    return max(1, min(-(-2 * H100_SMS // max(B, 1)),
                      -(-V // (4 * SPAN_THREADS))))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  gen: torch.Tensor, temperature: float, top_k: int,
                  noise: bool = False):
    """logits [B, V] f32 or bf16, keys [B, 2] int64, gen [B] int64 (all
    contiguous, on one device), ``temperature`` > 0 and ``top_k`` >= 0 ->
    tokens [B] int32 (and, with ``noise``, the noise [B, V] f32 the draw
    added, for checks).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    if logits.device.type == "cpu":
        return sample_tokens_plain(logits, keys, gen, temperature, top_k,
                                   noise)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if (logits.dtype not in (torch.float32, torch.bfloat16)
            or logits.dim() != 2):
        raise ValueError("logits must be a [B, V] float32 or bfloat16 "
                         f"tensor; got {logits.dtype} {tuple(logits.shape)}")
    B, V = logits.shape
    if V >= 2 ** 31:
        raise ValueError(f"V = {V}: token ids must fit an int32")
    if B > MAX_ROWS:
        raise ValueError(f"B = {B}: at most {MAX_ROWS} rows a launch")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    top_k = _check_top_k(top_k)
    for t, shape in ((keys, (B, 2)), (gen, (B,))):
        if (t.dtype != torch.int64 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != logits.device):
            raise ValueError(f"keys and gen must be contiguous int64 {(B, 2)}"
                             f" and {(B,)} on the logits' device; got "
                             f"{t.dtype} {tuple(t.shape)}")
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    g = (torch.empty((B, V), dtype=torch.float32, device=logits.device)
         if noise else None)
    if B == 0:
        return (out, g) if noise else out
    chunks, part_val, part_idx, tickets = 0, None, None, None
    if not 0 < top_k < V:
        # the no-cut kernel's scratch, its own for each launch: the spans'
        # maxima and each row's ticket counter (which the library zeroes)
        chunks = launch_chunks(B, V)
        part_val = torch.empty((B, chunks), dtype=torch.float32,
                               device=logits.device)
        part_idx = torch.empty((B, chunks), dtype=torch.int32,
                               device=logits.device)
        tickets = torch.empty((B,), dtype=torch.int32, device=logits.device)
    lib = build.library("sample")
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = lib.sample_tokens(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        keys.data_ptr(), gen.data_ptr(), B, V, max(temperature, 1e-6), top_k,
        chunks, None if part_val is None else part_val.data_ptr(),
        None if part_idx is None else part_idx.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
        None if g is None else g.data_ptr(), stream)
    build.check(rc, "sample_tokens")
    sample_tokens.launches += 1
    return (out, g) if noise else out


sample_tokens.launches = 0


def sample_gumbel_argmax(x: torch.Tensor, keys: torch.Tensor,
                         gen: torch.Tensor, noise: bool = False):
    """The draw alone: :func:`sample_tokens` at T = 1.0 and no cut
    (division by 1.0 is exact), so x [B, V] f32 (contiguous) -> tokens [B]
    int32 of argmax(x + gumbel), and with ``noise`` the noise [B, V] f32.
    Its launches count under ``sample_tokens.launches``."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise ValueError("x must be a contiguous [B, V] float32 tensor")
    return sample_tokens(x, keys, gen, 1.0, 0, noise)
