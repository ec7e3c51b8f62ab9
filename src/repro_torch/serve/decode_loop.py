"""Chunked decode: K decode steps per host round trip (PyTorch port).

Port of ``repro/serve/decode_loop.py``.  The reference compiles K steps
into one ``lax.scan`` with a donated cache and a ``lax.cond`` that stops
the position once every row is done.  Here a chunk is a Python loop of K
``decode_step`` calls on the device: each iteration emits the pending
token of every row that still has budget (:data:`PAD_TOKEN` otherwise,
from an on-device ``remaining`` mask), and decodes only while some row
still needs another token.  The host knows every row's budget, so that
stop needs no device read; the engine reads the ``[B, K]`` token buffer
once per chunk.  (A CUDA graph over the chunk is later work.)
"""

from __future__ import annotations

import dataclasses

import torch

# emitted for rows whose budget is exhausted; never read by the engine
PAD_TOKEN = -1


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Token selection: ``temperature <= 0`` is greedy argmax, the only
    mode the port serves so far."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def select_tokens(logits: torch.Tensor,
                  sampling: SamplingConfig) -> torch.Tensor:
    """logits [B, V] -> next token [B] int32, on the device (the first
    maximum, as ``jnp.argmax`` picks)."""
    if not sampling.greedy:
        raise NotImplementedError(
            "temperature > 0: sampled decoding comes with ROADMAP queue 1, "
            "item 5")
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def host_decode_steps(max_remaining: int, chunk: int) -> int:
    """Decode steps a chunk runs: it emits first and decodes only while a
    row still has budget after the emit, so a chunk whose largest
    remaining budget is R advances the position by ``min(K, R - 1)``."""
    return min(chunk, max(max_remaining - 1, 0))


def make_decode_chunk(api, chunk: int, sampling: SamplingConfig):
    """The K-step wave loop body for one engine.

    Returns ``run(params, overlay, eid, tok, cache, remaining) -> (tok,
    cache, tokens [B, K])``: ``tok`` [B, 1] is the pending (selected, not
    yet emitted) token of each row, ``remaining`` the host list of each
    row's budget of tokens still to emit.  The cache is updated in place.
    """

    def run(params, overlay, eid, tok, cache, remaining: list[int]):
        steps = host_decode_steps(max(remaining), chunk)
        rem = torch.as_tensor(remaining, dtype=torch.int32).to(tok.device)
        emitted = []
        for i in range(chunk):
            active = rem > 0
            emitted.append(torch.where(active, tok[:, 0], PAD_TOKEN))
            rem = torch.where(active, rem - 1, rem)
            if i < steps:
                logits, cache = api.decode_step(params, tok, cache,
                                                delta=overlay, eid=eid)
                tok = select_tokens(logits[:, -1], sampling)[:, None]
        return tok, cache, torch.stack(emitted, dim=1)

    return run
