"""Chunked decode: K decode steps per host round trip (PyTorch port).

Port of ``repro/serve/decode_loop.py``.  The reference compiles K steps
into one ``lax.scan`` with a donated cache and a ``lax.cond`` that stops
the position once every row is done.  Here a chunk is K iterations over
the caller's buffers, updated in place: each iteration emits the pending
token of every row that still has budget (:data:`PAD_TOKEN` otherwise,
from an on-device ``remaining`` mask), and decodes only while some row
still needs another token.  The host knows every row's budget, so that
stop needs no device read (:func:`host_decode_steps`); the engine reads
the ``[B, K]`` token buffer once per chunk.

On the CPU the chunk runs as that Python loop: it is the plain path, as a
kernel's plain version is.  On a CUDA device it runs as one
``torch.cuda.CUDAGraph`` replay, the counterpart of the reference's single
compiled launch.  A graph is captured per (rows, decode steps) at first
use, and keyed further by every object it reads by address: the
parameters, the overlay, the caller's token, expert-id and KV buffers
(the dense ring, or the paged pools with their block tables and row
vectors), and the kernel dispatch table.  The caller keeps those at fixed
addresses and writes them in place between replays; ``remaining`` goes in
through a buffer of the graph's own.  With paged KV a row turns inactive
inside the chunk when its budget runs dry, as in the reference.  A
capture or replay that fails raises: nothing falls back to the loop on
the card.  A capture runs in the global error mode, where any other CUDA
call invalidates it, so it runs with Python's cyclic garbage collector
paused: a collection there could free an unreachable engine's graphs or
buffers, which is such a call.

Sampled selection (``temperature > 0``) draws the reference's own
threefry stream (:mod:`repro_torch.serve.sampling`): token ``i`` of a
request is drawn under ``fold_in(keys[row], i)`` with ``keys[row] =
fold_in(PRNGKey(seed), uid)``, so a stream depends only on (seed, uid,
i), not on the chunk size, the slot or the admission time.  The per-row
keys and stream positions ``gen`` are caller buffers like ``tok``: a chunk
advances ``gen`` in place at every decode step, and a graph holds no
generator state.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from repro_torch import tree as tree_util
from repro_torch.kernels import ops

# emitted for rows whose budget is exhausted; never read by the engine
PAD_TOKEN = -1


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Token selection: ``temperature <= 0`` is greedy argmax;
    otherwise a draw from ``softmax(logits / temperature)``, cut to the
    ``top_k`` largest (0: the whole vocabulary), on the stream rooted at
    ``seed``."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def to_meta(self) -> dict:
        """JSON form for the serve journal: the sampled-stream contract is
        exactly these three numbers, so ``resume()`` can refuse a
        mismatched engine before it emits a token."""
        return {"temperature": self.temperature, "top_k": self.top_k,
                "seed": self.seed}

    @classmethod
    def from_meta(cls, d: dict) -> "SamplingConfig":
        return cls(temperature=float(d["temperature"]),
                   top_k=int(d["top_k"]), seed=int(d["seed"]))


def select_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  gen: torch.Tensor, sampling: SamplingConfig) -> torch.Tensor:
    """logits [B, V] -> next token [B] int32, on the device.

    Greedy: the first maximum, as ``jnp.argmax`` picks.  Sampled, in the
    reference's order: ``logits / max(T, 1e-6)`` (a true division, as
    jnp's), every value below the k-th largest masked to -inf when
    ``0 < top_k < V``, then row b draws ``argmax(scaled + gumbel)`` under
    ``fold_in(keys[b], gen[b])`` (keys [B, 2] and gen [B] int64, see
    :mod:`repro_torch.serve.sampling`); the first maximum wins.  The whole
    sampled branch is the ``sample_tokens`` kernel on the card, one launch
    on the logits as they come (f32 or bf16)."""
    if sampling.greedy:
        return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
    return ops.kernel("sample_tokens")(logits.contiguous(), keys, gen,
                                       sampling.temperature, sampling.top_k)


def host_decode_steps(max_remaining: int, chunk: int) -> int:
    """Decode steps a chunk runs: it emits first and decodes only while a
    row still has budget after the emit, so a chunk whose largest
    remaining budget is R advances the position by ``min(K, R - 1)``."""
    return min(chunk, max(max_remaining - 1, 0))


class DecodeChunk:
    """The K-step wave loop body of one engine (see the module docstring).

    ``chunk(params, overlay, eid, tok, cache, remaining, gen, keys) ->
    (tok, cache, tokens [B, K])``: ``tok`` [B, 1] int32 is the pending
    (selected, not yet emitted) token of each row, ``remaining`` the host
    list of each row's budget of tokens still to emit, ``gen`` [B] int64
    each row's stream position for the next draw and ``keys`` [B, 2] its
    key (:func:`select_tokens`).  ``tok``, ``gen`` and the cache are
    updated in place; ``tok`` and the cache are returned.  ``captures``,
    ``capture_s`` and ``replays`` count the CUDA graphs' work.
    """

    def __init__(self, api, chunk: int, sampling: SamplingConfig):
        self.api = api
        self.chunk = chunk
        self.sampling = sampling
        self._graphs: dict = {}
        self._stream = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def __call__(self, params, overlay, eid, tok, cache,
                 remaining: list[int], gen, keys):
        steps = host_decode_steps(max(remaining), self.chunk)
        if tok.device.type == "cuda":
            buf = self._replay(params, overlay, eid, tok, cache, remaining,
                               gen, keys, steps)
        else:
            rem = torch.as_tensor(remaining, dtype=torch.int32)
            buf = self._run(params, overlay, eid, tok, cache, rem, gen, keys,
                            steps)
        return tok, cache, buf

    def _run(self, params, overlay, eid, tok, cache, rem, gen, keys,
             steps: int):
        emitted = []
        for i in range(self.chunk):
            active = rem > 0
            emitted.append(torch.where(active, tok[:, 0], PAD_TOKEN))
            rem = torch.where(active, rem - 1, rem)
            if "active" in cache:
                # paged KV: a row whose budget just ran dry turns inactive,
                # so decode_step sends its writes to the trash block and
                # freezes its position (in place, inside the graph)
                cache["active"].copy_(rem > 0)
            if i < steps:
                logits, _ = self.api.decode_step(params, tok, cache,
                                                 delta=overlay, eid=eid)
                tok.copy_(select_tokens(logits[:, -1], keys, gen,
                                        self.sampling)[:, None])
                gen.add_(1)
        return torch.stack(emitted, dim=1)

    def _replay(self, params, overlay, eid, tok, cache, remaining, gen, keys,
                steps):
        key = (tok.shape[0], steps, id(params), id(overlay), id(eid),
               id(tok), id(cache), id(gen), id(keys), id(ops.table()))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(params, overlay, eid, tok,
                                                  cache, gen, keys, steps)
        g["rem"].copy_(torch.as_tensor(remaining, dtype=torch.int32))
        g["graph"].replay()
        ops.add_launches(g["launches"])
        self.replays += 1
        return g["buf"]

    def _capture(self, params, overlay, eid, tok, cache, gen, keys,
                 steps: int) -> dict:
        t0 = time.monotonic()
        dev = tok.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        rem = torch.zeros((tok.shape[0],), dtype=torch.int32, device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        if steps:
            # one step outside the capture, on copies of the state and on
            # the capture's stream: it builds the kernels at first use and
            # sets up cuBLAS and the rope tables there
            with torch.cuda.stream(stream):
                logits, _ = self.api.decode_step(
                    params, tok.clone(),
                    tree_util.tree_map(lambda t: t.clone(), cache),
                    delta=overlay, eid=eid)
                select_tokens(logits[:, -1], keys, gen.clone(),
                              self.sampling)
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                buf = self._run(params, overlay, eid, tok, cache, rem, gen,
                                keys, steps)
        finally:
            if collecting:
                gc.enable()
        # the capture recorded these launches and ran none of them: take
        # them back here, and add them on every replay
        launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                    if n != before[k]}
        ops.add_launches({k: -n for k, n in launches.items()})
        self.captures += 1
        self.capture_s += time.monotonic() - t0
        return {"graph": graph, "buf": buf, "rem": rem, "launches": launches,
                "refs": (params, overlay, eid, tok, cache, gen, keys)}

    def stats(self) -> dict:
        return {"graphs": len(self._graphs), "captures": self.captures,
                "capture_s": self.capture_s, "replays": self.replays}


def make_decode_chunk(api, chunk: int, sampling: SamplingConfig
                      ) -> DecodeChunk:
    """The K-step wave loop body for one engine (:class:`DecodeChunk`)."""
    return DecodeChunk(api, chunk, sampling)
