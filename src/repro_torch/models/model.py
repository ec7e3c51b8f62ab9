"""Model API of the port (mirrors ``repro/models/model.py::build``).

``build(cfg)`` returns a :class:`ModelApi` whose members close over the
config: ``init``, ``forward`` and ``loss_and_logits`` (train),
``prefill``, ``decode_step`` and ``init_decode_cache`` (serve).  Batches
are dicts:

* LM:      ``{"tokens": [B, T] int, "targets": [B, T] int}``
* VLM:     ``+ {"mm_embeds": [B, n_patches, e]}``, the vision stub's output
* enc-dec: ``+ {"frames": [B, S_src, e]}``, the audio stub's output

``targets`` uses -1 for masked positions.  A VLM's logits cover the mm
prefix and the text; its loss scores the text positions only.  The
reference's ``Runtime`` is gone: the one training knob it carries here,
``remat_policy``, is an argument of :func:`build`, and the scans' chunk
sizes are the constants ``models.mamba.CHUNK`` and ``models.rwkv.CHUNK``.
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
    loss_and_logits: Callable   # (params, batch, run=) -> (loss, (logits,
    #                              aux)); run: a training mesh's PodRun
    forward: Callable         # (params, batch, run=) -> (logits, aux)
    prefill: Callable         # (params, batch, cache_len, delta=, eid=, start=,
    #                            cache=, comm=, shard_rows=)
    decode_step: Callable     # (params, token, cache, delta=, eid=, comm=,
    #                            decode_attn=)
    init_decode_cache: Callable   # (batch, cache_len, device=) -> cache


def build(cfg, remat_policy: str = "none") -> ModelApi:
    is_encdec = cfg.enc_n_units > 0
    is_vlm = cfg.frontend is not None and not is_encdec

    def init(seed: int = 0, device="cuda"):
        return tf.init_params(cfg, seed=seed, device=device)

    def forward(params, batch, run=None):
        if run is not None:
            params = run.top(params)
        enc_out = (tf.encode(params, batch["frames"], cfg,
                             remat_policy=remat_policy, run=run)
                   if is_encdec else None)
        mm = batch.get("mm_embeds") if is_vlm else None
        return tf.forward_train(params, batch["tokens"], cfg,
                                remat_policy=remat_policy, mm_embeds=mm,
                                enc_out=enc_out, run=run)

    def loss_and_logits(params, batch, run=None):
        logits, aux = forward(params, batch, run=run)
        targets = batch["targets"]
        if is_vlm:
            # the logits cover [mm prefix + text]: score the text only
            logits = logits[:, logits.shape[1] - targets.shape[1]:]
        ce = cross_entropy if run is None else run.cross_entropy
        loss = ce(logits, targets) + AUX_LOSS_WEIGHT * aux
        return loss, (logits, aux)

    def prefill_fn(params, batch, cache_len: int, delta=None, eid=None,
                   start=None, cache=None, comm=None, shard_rows=False):
        enc_out = (tf.encode(params, batch["frames"], cfg) if is_encdec
                   else None)
        mm = batch.get("mm_embeds") if is_vlm else None
        return tf.prefill(params, batch["tokens"], cfg, cache_len,
                          delta=delta, eid=eid, start=start, cache=cache,
                          comm=comm, shard_rows=shard_rows, mm_embeds=mm,
                          enc_out=enc_out)

    def decode_fn(params, token, cache, delta=None, eid=None, comm=None,
                  decode_attn=None):
        return tf.decode_step(params, token, cache, cfg, delta=delta,
                              eid=eid, comm=comm, decode_attn=decode_attn)

    def init_cache(batch: int, cache_len: int, device="cuda"):
        return tf.init_decode_cache(cfg, batch, cache_len, device=device)

    return ModelApi(cfg=cfg, init=init, loss_and_logits=loss_and_logits,
                    forward=forward, prefill=prefill_fn,
                    decode_step=decode_fn, init_decode_cache=init_cache)
