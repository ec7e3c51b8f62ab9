"""Expert storage tiers of the port: a local store and the device cache.

Port of the local tiers of ``repro/serve/expert_cache.py``:

  ExpertStore    (cold tier)     name -> :class:`~repro_torch.expert.Expert`,
                                 or only its Golomb-Rice streams
                                 (``cold_golomb=True``), decoded to
                                 planes on promotion
  DeviceCache    (device tier)   packed bitplane trees on the card under one
                                 byte budget (LRU)
  ExpertRegistry                 the front door over both, and the
                                 fused merge of named experts into the
                                 base (merge-on-swap, merged ensembles)

Experts stay in the 2-bit bitplane form end to end.  A mixed wave reads
its experts through the serving engine's expert slots
(:class:`~repro_torch.models.delta.SlotOverlay`), filled by copy from the
trees here; the slots are the engine's and outside this budget.  The
remote tiers (transports, prefetch workers, quarantine) come with ROADMAP
queue 1, item 8.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core.packing import tree_packed_bytes
from repro_torch.device import resolve_device
from repro_torch.expert import GOLOMB, PACKED, Expert, as_expert
from repro_torch.kernels.ops import apply_ternary_delta_many_flat

BASE = "__base__"   # pseudo-expert: serve the unmodified base weights

DEFAULT_DEVICE_BYTES = 1 << 28


@dataclasses.dataclass
class SwapStats:
    store_to_host_bytes: int = 0
    host_to_device_bytes: int = 0
    promotions: int = 0
    evictions: int = 0
    hits: int = 0
    misses: int = 0
    seconds: float = 0.0
    stack_builds: int = 0          # expert slots filled by copy
    stack_hits: int = 0            # experts found already in their slot
    golomb_decode_seconds: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


class ExpertStore:
    """Cold tier: name -> Expert (its packed planes wherever they were
    compressed).

    ``cold_golomb=True`` keeps only each expert's Golomb-Rice streams (the
    storage-optimal form) and the leaf geometry; :meth:`get` then builds a
    fresh Expert from them and pays one host decode over all its leaves,
    with the planes on the host, for the device tier to move.
    """

    def __init__(self, cold_golomb: bool = False):
        self.cold_golomb = cold_golomb
        self._store: dict[str, Expert] = {}
        self._blobs: dict[str, dict] = {}
        self._meta: dict[str, dict] = {}

    def put(self, art) -> Expert:
        ex = as_expert(art)
        if not self.cold_golomb:
            self._store[ex.name] = ex
            return ex
        self._blobs[ex.name] = dict(ex.as_(GOLOMB))
        self._meta[ex.name] = {
            "leaf": {p: dict(m) for p, m in ex._leaf_meta.items()},
            "kind": ex.kind, "density": ex.density, "alpha": ex.alpha}
        return ex

    def get(self, name: str) -> Expert:
        if not self.cold_golomb:
            return self._store[name]
        m = self._meta[name]
        ex = Expert(name, m["kind"], density=m["density"], alpha=m["alpha"])
        ex._leaf_meta = {p: dict(v) for p, v in m["leaf"].items()}
        ex._reps[GOLOMB] = self._blobs[name]
        ex.as_(PACKED)     # one decode now, so promotion timing is the
        return ex          # store tier's

    def __contains__(self, name: str) -> bool:
        return name in (self._blobs if self.cold_golomb else self._store)

    def names(self) -> list[str]:
        return list(self._blobs if self.cold_golomb else self._store)

    def nbytes(self, name: str) -> int:
        if self.cold_golomb:
            return sum(len(b) for b in self._blobs[name].values())
        return self._store[name].nbytes(PACKED)


class DeviceCache:
    """LRU cache of packed bitplane trees on one device under a byte
    budget."""

    def __init__(self, store: ExpertStore, capacity_bytes: int, device):
        self.store = store
        self.capacity = capacity_bytes
        self.dev = torch.device(device)
        self._cache: OrderedDict[str, dict] = OrderedDict()
        self._sizes: dict[str, int] = {}
        self.stats = SwapStats()

    def resident_bytes(self) -> int:
        return sum(self._sizes.values())

    def _drop_tree(self, name: str) -> None:
        self._cache.pop(name)
        self._sizes.pop(name)
        self.stats.evictions += 1

    def _enforce_budget(self) -> None:
        """Evict least-recently-used trees until within budget."""
        while self._cache and self.resident_bytes() > self.capacity:
            self._drop_tree(next(iter(self._cache)))

    def fetch(self, name: str) -> dict:
        """-> {path: PackedTernary} resident on the cache's device."""
        if name in self._cache:
            self._cache.move_to_end(name)
            self.stats.hits += 1
            return self._cache[name]
        self.stats.misses += 1
        t0 = time.monotonic()
        art = self.store.get(name)
        if self.store.cold_golomb:
            self.stats.golomb_decode_seconds += time.monotonic() - t0
        packed = {p: dataclasses.replace(pt, pos=pt.pos.to(self.dev),
                                         neg=pt.neg.to(self.dev),
                                         scale=pt.scale.to(self.dev))
                  for p, pt in art.packed.items()}
        size = tree_packed_bytes(packed)
        while self._cache and self.resident_bytes() + size > self.capacity:
            self._drop_tree(next(iter(self._cache)))
        self._cache[name] = packed
        self._sizes[name] = size
        self.stats.store_to_host_bytes += self.store.nbytes(name)
        self.stats.host_to_device_bytes += size
        self.stats.promotions += 1
        self.stats.seconds += time.monotonic() - t0
        return packed


class ExpertRegistry:
    """One expert library over the cold store and the device cache."""

    def __init__(self, store: Optional[ExpertStore] = None, *,
                 cold_golomb: bool = False,
                 device_cache_bytes: int = DEFAULT_DEVICE_BYTES,
                 device="cuda"):
        self.store = (store if store is not None
                      else ExpertStore(cold_golomb=cold_golomb))
        self.device_cache_bytes = device_cache_bytes
        self.dev = resolve_device(device)
        self._device: Optional[DeviceCache] = None

    def add(self, expert, *experts) -> Expert:
        out = [self.store.put(e) for e in (expert,) + experts]
        return out[0]

    def get(self, name: str) -> Expert:
        return self.store.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.store

    def device(self, capacity_bytes: Optional[int] = None) -> DeviceCache:
        """The device tier (created on first call); an explicit
        ``capacity_bytes`` sets or retargets its budget."""
        if self._device is None:
            self._device = DeviceCache(
                self.store, capacity_bytes or self.device_cache_bytes,
                self.dev)
        elif (capacity_bytes is not None
              and capacity_bytes != self._device.capacity):
            self._device.capacity = capacity_bytes
            self._device._enforce_budget()
        return self._device

    def fetch_packed(self, name: str) -> dict:
        """Device-resident ``{path: PackedTernary}`` of one expert
        (``{}`` for ``BASE``)."""
        return {} if name == BASE else self.device().fetch(name)

    def merged_params(self, base: dict, names, weights=None,
                      out: Optional[dict] = None) -> dict:
        """``W_base + sum_e w_e * Delta_e`` with ONE fused sweep per leaf.

        Each leaf that any named expert carries goes through
        ``unpack_add_many`` once, over the experts that carry it, bitwise
        equal to applying the weight-scaled experts one at a time; a leaf
        no expert carries is returned as it is (not copied).  With one
        name this is the merge-on-swap promotion.  ``out`` (a tree shaped
        like ``base``) takes every merged leaf, and every other leaf of the
        base, by copy, and is returned: a caller whose CUDA graphs read
        the parameters by address keeps them at one place across swaps."""
        names = [names] if isinstance(names, str) else list(names)
        w = list(weights) if weights is not None else [1.0] * len(names)
        if len(w) != len(names):
            raise ValueError(f"{len(w)} weights for {len(names)} experts")
        packs = [self.fetch_packed(n) for n in names]
        dst = dict(tree_util.flatten_with_paths(out)) if out is not None \
            else None
        flat = {}
        for path, leaf in tree_util.flatten_with_paths(base):
            pts = [(pk[path], wi) for pk, wi in zip(packs, w) if path in pk]
            flat[path] = leaf if not pts else apply_ternary_delta_many_flat(
                leaf, [pt for pt, _ in pts], [wi for _, wi in pts])
            if dst is not None:
                dst[path].copy_(flat.pop(path))
        return out if out is not None else tree_util.unflatten_paths(flat)
