"""Model API of the port (mirrors ``repro/models/model.py::build``).

``build(cfg)`` returns a :class:`ModelApi` whose members close over the
config: ``init``, ``prefill``, ``decode_step`` and ``init_decode_cache``.
Only the serving members are ported; training comes with ROADMAP queue 1,
item 11.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer as tf


@dataclasses.dataclass
class ModelApi:
    cfg: object
    init: Callable            # (seed=, device=) -> params
    prefill: Callable         # (params, batch, cache_len, delta=, eid=, start=,
    #                            cache=)
    decode_step: Callable     # (params, token, cache, delta=, eid=)
    init_decode_cache: Callable   # (batch, cache_len, device=) -> cache


def build(cfg) -> ModelApi:
    def init(seed: int = 0, device="cuda"):
        return tf.init_params(cfg, seed=seed, device=device)

    def prefill_fn(params, batch, cache_len: int, delta=None, eid=None,
                   start=None, cache=None):
        return tf.prefill(params, batch["tokens"], cfg, cache_len,
                          delta=delta, eid=eid, start=start, cache=cache)

    def decode_fn(params, token, cache, delta=None, eid=None):
        return tf.decode_step(params, token, cache, cfg, delta=delta,
                              eid=eid)

    def init_cache(batch: int, cache_len: int, device="cuda"):
        return tf.init_decode_cache(cfg, batch, cache_len, device=device)

    return ModelApi(cfg=cfg, init=init, prefill=prefill_fn,
                    decode_step=decode_fn, init_decode_cache=init_cache)
