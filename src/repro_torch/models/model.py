"""Model API of the port (mirrors ``repro/models/model.py::build``).

``build(cfg)`` returns a :class:`ModelApi` whose members close over the
config: ``init``, ``forward`` and ``loss_and_logits`` (train),
``prefill``, ``decode_step`` and ``init_decode_cache`` (serve).  Batches
are dicts ``{"tokens": [B, T] int, "targets": [B, T] int}``; ``targets``
uses -1 for masked positions.  The reference's ``Runtime`` is gone: the
one training knob it carries here, ``remat_policy``, is an argument of
:func:`build`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer as tf

AUX_LOSS_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE over targets >= 0.  logits [B, T, V] (any float dtype),
    the log-sum-exp in f32."""
    l32 = logits.to(torch.float32)
    lse = torch.logsumexp(l32, dim=-1)
    tgt = torch.clamp(targets.to(torch.int64), 0, logits.shape[-1] - 1)
    picked = torch.gather(l32, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    mask = (targets >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


@dataclasses.dataclass
class ModelApi:
    cfg: object
    init: Callable            # (seed=, device=) -> params
    loss_and_logits: Callable   # (params, batch) -> (loss, (logits, aux))
    forward: Callable         # (params, batch) -> (logits, aux)
    prefill: Callable         # (params, batch, cache_len, delta=, eid=, start=,
    #                            cache=)
    decode_step: Callable     # (params, token, cache, delta=, eid=)
    init_decode_cache: Callable   # (batch, cache_len, device=) -> cache


def build(cfg, remat_policy: str = "none") -> ModelApi:
    def init(seed: int = 0, device="cuda"):
        return tf.init_params(cfg, seed=seed, device=device)

    def forward(params, batch):
        return tf.forward_train(params, batch["tokens"], cfg,
                                remat_policy=remat_policy)

    def loss_and_logits(params, batch):
        logits, aux = forward(params, batch)
        loss = cross_entropy(logits, batch["targets"]) + AUX_LOSS_WEIGHT * aux
        return loss, (logits, aux)

    def prefill_fn(params, batch, cache_len: int, delta=None, eid=None,
                   start=None, cache=None):
        return tf.prefill(params, batch["tokens"], cfg, cache_len,
                          delta=delta, eid=eid, start=start, cache=cache)

    def decode_fn(params, token, cache, delta=None, eid=None):
        return tf.decode_step(params, token, cache, cfg, delta=delta,
                              eid=eid)

    def init_cache(batch: int, cache_len: int, device="cuda"):
        return tf.init_decode_cache(cfg, batch, cache_len, device=device)

    return ModelApi(cfg=cfg, init=init, loss_and_logits=loss_and_logits,
                    forward=forward, prefill=prefill_fn,
                    decode_step=decode_fn, init_decode_cache=init_cache)
