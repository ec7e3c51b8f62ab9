"""repro_torch — the PyTorch/CUDA port of the ComPEFT system.

Mirrors the module layout of the JAX package ``repro`` (its reference),
imports ``torch`` and never ``jax``.  Entry points run on the CUDA card
unless the caller asks for the CPU (``device="cpu"``), where every kernel
wrapper takes its plain PyTorch version.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
