"""Zero-merge expert overlays: per-row ternary deltas applied inside forward.

Port of ``repro/models/delta.py``.  The packed bitplanes of several experts
stay stacked on the device, and every projection computes

    y[m] = x[m] @ W_base + scale[e(m)] * (x[m] @ T_{e(m)})

with the grouped ternary kernel, so one batch mixes experts freely and no
merged parameters ever exist.  Unlike the JAX package off the TPU, the
overlay never unpacks the planes to dense signs: they stay packed on every
device, and on the card the grouped kernel reads them (on the CPU the
kernel's plain version unpacks them per call).

Block-level deltas carry the unit axis in front, like the parameters;
:func:`slice_unit` cuts out one unit for the model's loop over units.
:class:`SlotOverlay` is the serving engine's overlay: a fixed number of
expert slots at fixed addresses, filled by copy, so the engine's CUDA
graphs read every expert set through the same tensors.

On a serving mesh with an "expert" axis the projection and embedding
planes are expert-parallel (:class:`ExpertShard`): a rank holds a
contiguous block of the slots, runs the grouped kernel over its own slots
only (a row whose expert lives on another shard takes slot -1, whose
delta the kernel makes 0) and sums the delta over the axis before it is
added to the base product.  Every element then sums one term and exact
zeros, so the result is the single-device one.  The small vector leaves
stay whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.packing import LANE, lane_shifts, stacked_bytes
from repro_torch.kernels.ref import dense_of_planes


@dataclasses.dataclass
class ExpertShard:
    """The slots ``[lo, hi)`` a rank holds of an expert-parallel stack,
    and the mesh (a :class:`~repro_torch.distributed.collectives.
    ServeComm`) whose "expert" axis sums the deltas."""

    lo: int
    hi: int
    comm: Any

    def local_eid(self, eid: torch.Tensor) -> torch.Tensor:
        """Global slot ids -> this shard's (-1 for another shard's)."""
        e = eid.to(torch.int32)
        return torch.where((e >= self.lo) & (e < self.hi), e - self.lo, -1)


@dataclasses.dataclass
class MatmulDelta:
    """Stacked planes of one projection leaf, matmul view [K, N].

    ``pos``/``neg``: int32 [(U,) E, K, N/32] ([(U,) E, N, K/32] when
    ``transpose``); ``scales``: f32 [(U,) E].  With a unit axis the planes
    are a strided view of the stack (no copy); each expert's [K, N/32]
    block stays contiguous, which is what the kernel needs.
    """

    pos: torch.Tensor
    neg: torch.Tensor
    scales: torch.Tensor
    n_out: int = 0
    transpose: bool = False
    shard: Optional[ExpertShard] = None


@dataclasses.dataclass
class EmbedDelta:
    """Stacked planes of the embedding table [V, d] (d % 32 == 0):
    pos/neg int32 [E, V, d/32], scales f32 [E]."""

    pos: torch.Tensor
    neg: torch.Tensor
    scales: torch.Tensor
    shard: Optional[ExpertShard] = None


@dataclasses.dataclass
class VectorDelta:
    """Dense per-expert delta stack of a small leaf: f32 [(U,) E, *shape]
    (scale folded in)."""

    values: torch.Tensor


def slice_unit(node, u: int):
    """One unit's slice of a block-level overlay subtree."""
    if isinstance(node, dict):
        return {k: slice_unit(v, u) for k, v in node.items()}
    if isinstance(node, MatmulDelta):
        return dataclasses.replace(node, pos=node.pos[u], neg=node.neg[u],
                                   scales=node.scales[u])
    if isinstance(node, VectorDelta):
        return VectorDelta(values=node.values[u])
    raise TypeError(type(node).__name__)


# ---------------------------------------------------------------------------
# Per-row application helpers (called from the model forward)
# ---------------------------------------------------------------------------


def delta_proj(x: torch.Tensor, md: Optional[MatmulDelta],
               eid: Optional[torch.Tensor]):
    """f32 delta of a projection: x [B, T, K] -> [B, T, n_out] or None."""
    if md is None or eid is None:
        return None
    from repro_torch.kernels.ops import grouped_delta_matmul
    B, T, K = x.shape
    rows = x.reshape(B * T, K)
    if md.shard is not None:
        eid = md.shard.local_eid(eid)
    eid_rows = torch.repeat_interleave(eid.to(torch.int32), T)
    d = grouped_delta_matmul(rows, md.pos, md.neg, md.scales, eid_rows,
                             transpose_rhs=md.transpose, n_out=md.n_out)
    if md.shard is not None:
        d = md.shard.comm.reduce_experts(d.contiguous())
    return d.reshape(B, T, md.n_out)


def add_delta(y: torch.Tensor, d: Optional[torch.Tensor]) -> torch.Tensor:
    """y + d in f32, cast back to y.dtype (no-op when d is None)."""
    if d is None:
        return y
    return (y.to(torch.float32) + d.reshape(y.shape)).to(y.dtype)


def eff_param(base: torch.Tensor, vd: Optional[VectorDelta],
              eid: Optional[torch.Tensor], expand: int = 1) -> torch.Tensor:
    """Per-row effective small parameter ``(base + delta[e(m)])`` in the
    base dtype, shaped [B, 1*expand, *base.shape] to broadcast over time
    (and head) axes; ``base`` itself without a delta."""
    if vd is None or eid is None:
        return base
    v = vd.values[eid.to(torch.int64)]                      # [B, *shape]
    v = v.reshape(v.shape[:1] + (1,) * expand + v.shape[1:])
    return (base.to(torch.float32) + v).to(base.dtype)


def embed_delta_rows(ed: Optional[EmbedDelta], tokens: torch.Tensor,
                     eid: Optional[torch.Tensor], d_model: int):
    """Per-(row, token) embedding delta: f32 [B, T, d] or None."""
    if ed is None or eid is None:
        return None
    mine = None
    if ed.shard is not None:
        eid = ed.shard.local_eid(eid)
        mine = eid >= 0
        eid = eid.clamp(min=0)
    e = eid.to(torch.int64)[:, None]                        # [B, 1]
    pw = ed.pos[e, tokens]                                  # [B, T, W]
    nw = ed.neg[e, tokens]
    shifts = lane_shifts(pw.device)
    pb = ((pw[..., None] >> shifts) & 1).to(torch.float32)
    nb = ((nw[..., None] >> shifts) & 1).to(torch.float32)
    delta = (pb - nb).reshape(pw.shape[:2] + (-1,))[..., :d_model]
    delta = delta * ed.scales[e][..., None]
    if mine is None:
        return delta
    delta = torch.where(mine[:, None, None], delta, 0.0)
    return ed.shard.comm.reduce_experts(delta.contiguous())


def tied_logits_delta(x: torch.Tensor, ed: Optional[EmbedDelta],
                      eid: Optional[torch.Tensor], vocab: int):
    """f32 delta of the tied LM head: x [B, T, d] -> [B, T, V] or None.
    The embedding planes are packed along d, the head's contraction dim,
    so the grouped kernel runs in its transposed form on them."""
    if ed is None or eid is None:
        return None
    md = MatmulDelta(pos=ed.pos, neg=ed.neg, scales=ed.scales, n_out=vocab,
                     transpose=True, shard=ed.shard)
    return delta_proj(x, md, eid)


# ---------------------------------------------------------------------------
# Overlay planning / construction
# ---------------------------------------------------------------------------

_VEC_NAMES = {"pre_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm",
              "final_norm", "bq", "bk", "bv", "q_norm", "k_norm"}
_IN_PROJ = {"wq", "wk", "wv", "wg", "wu"}


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    kind: str                 # "matmul" | "vector" | "embed"
    units: int                # leading unit axis length (0 = no unit axis)
    core: tuple[int, ...]     # per-unit shape
    k: int = 0                # matmul view contraction dim
    n: int = 0                # matmul view output dim


def _classify(parts: list[str], core: tuple[int, ...], units: int):
    name = parts[-1]
    if parts == ["embed"]:
        return None if core[1] % LANE else LeafSpec("embed", 0, core)
    if parts == ["lm_head"]:
        k, n = core
        return LeafSpec("matmul", 0, core, k, n) if n % LANE == 0 else None
    if name in _VEC_NAMES:
        return LeafSpec("vector", units, core)
    if name in _IN_PROJ and len(core) >= 2:
        k, n = core[0], int(np.prod(core[1:]))
        return LeafSpec("matmul", units, core, k, n) if n % LANE == 0 else None
    if name == "wo" and len(core) == 3:       # attn out: [H, D, d]
        k, n = int(np.prod(core[:2])), core[-1]
        return LeafSpec("matmul", units, core, k, n) if n % LANE == 0 else None
    if name == "wo" and len(core) == 2:       # ffn out: [f, d]
        k, n = core
        return LeafSpec("matmul", units, core, k, n) if n % LANE == 0 else None
    return None


def plan_overlay(params: dict, cfg) -> Optional[dict]:
    """Map every base-param path to a LeafSpec, or None when the family is
    not coverable by the zero-merge path.  The engine then serves it by
    merge-on-swap (``ExpertRegistry.merged_params``, one expert merged at a
    time): the port's MoE configs take that path; recurrent blocks,
    enc-dec, cross-attention and frontends would too, but the port's model
    does not run them yet."""
    if cfg.enc_n_units or cfg.cross_attn or cfg.frontend is not None:
        return None
    for b in cfg.pattern:
        if b.kind != "attn" or (b.ffn is not None and b.ffn.moe is not None):
            return None
    plan = {}
    for ps, leaf in tree_util.flatten_with_paths(params):
        parts = ps.split("/")
        if parts[0] == "blocks":
            units, core = leaf.shape[0], tuple(leaf.shape[1:])
            if int(np.prod(core)) % LANE:
                return None     # unit rows must stay word-aligned
        else:
            units, core = 0, tuple(leaf.shape)
        spec = _classify(parts, core, units)
        if spec is None:
            return None
        plan[ps] = spec
    return plan


def build_overlay(plan: dict, stacks: dict,
                  shard: Optional[ExpertShard] = None) -> Optional[dict]:
    """Shape stacked plane buffers into an overlay tree.

    ``stacks`` is {path: (pos [E, W], neg [E, W], scales [E], shape)} as
    :func:`repro_torch.core.packing.stack_packed` builds it.  Returns a
    nested dict mirroring the parameter tree, or None when a delta lands
    on a path the plan cannot express.  Projection planes stay packed
    (views of the stack, no copy); only the small vector leaves are
    unpacked, with their scale folded in.  ``shard`` marks the projection
    and embedding stacks as one rank's block of expert-parallel slots.
    """
    for path in stacks:
        if path not in plan:
            return None
    flat: dict[str, Any] = {}
    for path, (pos, neg, scales, _) in stacks.items():
        spec = plan[path]
        E = pos.shape[0]
        if spec.kind == "vector":
            n = int(np.prod(spec.core)) * max(spec.units, 1)
            vals = dense_of_planes(pos, neg, n) * scales[:, None]
            if spec.units:
                vals = vals.reshape((E, spec.units) + spec.core).transpose(0, 1)
            else:
                vals = vals.reshape((E,) + spec.core)
            flat[path] = VectorDelta(values=vals)
        elif spec.kind == "embed":
            V, d = spec.core
            flat[path] = EmbedDelta(pos=pos.reshape(E, V, d // LANE),
                                    neg=neg.reshape(E, V, d // LANE),
                                    scales=scales, shard=shard)
        else:
            shape = (E, max(spec.units, 1), spec.k, spec.n // LANE)
            p, q = pos.reshape(shape), neg.reshape(shape)
            if spec.units:
                flat[path] = MatmulDelta(
                    pos=p.transpose(0, 1), neg=q.transpose(0, 1),
                    scales=scales[None].expand(spec.units, E), n_out=spec.n,
                    shard=shard)
            else:
                flat[path] = MatmulDelta(pos=p[:, 0], neg=q[:, 0],
                                         scales=scales, n_out=spec.n,
                                         shard=shard)
    return tree_util.unflatten_paths(flat)


class SlotOverlay:
    """A zero-merge overlay over ``n_slots`` expert slots whose tensors
    never move.

    Slot s holds one expert's planes and scale, copied in from its
    device-resident tree, or zeros (``BASE``, or an expert without the
    leaf).  The vector leaves' dense deltas are recomputed for a slot when
    it is filled.  A row's delta depends only on its own slot (the grouped
    kernel's contract, and the plain version's arithmetic), so which slot
    an expert holds and how many slots sit unused change no value; unused
    slots cost the grouped kernel's launch empty blocks.

    The buffers cover every leaf that any expert placed so far carries; an
    expert with a leaf none carried before reallocates them (a new
    ``overlay`` object) and refills every held slot.

    With ``comm`` (a serving mesh) the slot count is padded to a multiple
    of the "expert" axis, and this rank holds the projection and
    embedding planes of its block ``[lo, hi)`` of the slots only; a pad
    slot holds zeros, so it adds exact zeros.  A new expert then takes a
    free slot on the shard that holds the fewest experts, so the shards
    fill evenly.
    """

    def __init__(self, plan: dict, n_slots: int, device, comm=None):
        self.plan = plan
        self.dev = torch.device(device)
        self.comm = comm
        self.n_shards = comm.n_expert if comm is not None else 1
        if comm is not None:
            n_slots, self.lo, self.hi = comm.slot_range(n_slots)
        else:
            self.lo, self.hi = 0, n_slots
        self.n_slots = n_slots
        self.shard = (ExpertShard(self.lo, self.hi, comm)
                      if self.n_shards > 1 else None)
        self.names: list[Optional[str]] = [None] * n_slots
        self._lru: list[int] = []        # held slots, least recent first
        self.stacks: dict = {}
        self.overlay: dict = {}
        self._vectors: dict[str, VectorDelta] = {}
        self.fills = 0

    def slot_of(self, name: str) -> Optional[int]:
        return self.names.index(name) if name in self.names else None

    def shard_names(self) -> list[list[str]]:
        """The experts held by each shard's block of slots."""
        per = self.n_slots // self.n_shards
        return [[n for n in self.names[k * per:(k + 1) * per]
                 if n is not None] for k in range(self.n_shards)]

    def _take_free(self, free: list, names: list) -> int:
        if self.n_shards == 1:
            return free.pop(0)
        per = self.n_slots // self.n_shards
        load = [sum(n is not None for n in names[k * per:(k + 1) * per])
                for k in range(self.n_shards)]
        s = min(free, key=lambda s: (load[s // per], s))
        free.remove(s)
        return s

    def _local(self, path: str, s: int) -> Optional[int]:
        """Slot ``s``'s row in this rank's stack of ``path`` (None: on
        another shard)."""
        if self.plan[path].kind == "vector":
            return s
        return s - self.lo if self.lo <= s < self.hi else None

    def nbytes(self) -> int:
        return stacked_bytes(self.stacks)

    def place(self, names, fetch) -> Optional[dict]:
        """Give every expert of ``names`` a slot and return the overlay.

        ``fetch(name)`` gives an expert's {path: PackedTernary} on this
        device (``{}`` for ``BASE``).  Every tree a slot will be filled
        from is fetched before anything changes, so a fetch that raises
        (an expert a remote store cannot promote, or an unknown one)
        leaves the slots, their names and their order as they were.  A
        slot goes to a free one first, else to the least recently used
        expert outside ``names``.  Returns None, changing nothing, when an
        expert carries a leaf the plan cannot express."""
        want = list(dict.fromkeys(names))
        new = [n for n in want if n not in self.names]
        packs = {n: fetch(n) for n in new}
        if any(p not in self.plan for pk in packs.values() for p in pk):
            return None
        free = [s for s, n in enumerate(self.names) if n is None]
        victims = [s for s in self._lru if self.names[s] not in want]
        if len(new) > len(free) + len(victims):
            raise ValueError(f"{len(want)} experts for {self.n_slots} slots")
        names = list(self.names)
        for n in new:
            names[self._take_free(free, names) if free
                  else victims.pop(0)] = n
        leaves = {p: (pt.pos.numel(), tuple(pt.shape))
                  for pk in packs.values() for p, pt in pk.items()}
        grow = any(p not in self.stacks for p in leaves)
        refill = ([s for s, n in enumerate(names) if n is not None] if grow
                  else [names.index(n) for n in new])
        # the kept experts a reallocation refills: their trees may have
        # left the device cache, and fetching them again may fail
        packs.update({names[s]: fetch(names[s]) for s in refill
                      if names[s] not in packs})
        self.names = names
        if grow:
            kept = {p: (pos.shape[1], shape)
                    for p, (pos, _, _, shape) in self.stacks.items()}
            self._allocate({**kept, **leaves})
        for s in refill:
            self._fill(s, packs[self.names[s]])
        for n in want:
            s = self.names.index(n)
            if s in self._lru:
                self._lru.remove(s)
            self._lru.append(s)
        return self.overlay

    def _allocate(self, leaves: dict) -> None:
        def rows(p):
            return (self.n_slots if self.plan[p].kind == "vector"
                    else self.hi - self.lo)
        self.stacks = {
            p: (torch.zeros((rows(p), W), dtype=torch.int32, device=self.dev),
                torch.zeros((rows(p), W), dtype=torch.int32, device=self.dev),
                torch.zeros((rows(p),), dtype=torch.float32, device=self.dev),
                shape) for p, (W, shape) in sorted(leaves.items())}
        self.overlay = build_overlay(self.plan, self.stacks, self.shard)
        self._vectors = {p: vd for p, vd in tree_util.flatten_with_paths(
            self.overlay) if isinstance(vd, VectorDelta)}

    def _fill(self, s: int, packed: dict) -> None:
        for p, (pos, neg, scales, shape) in self.stacks.items():
            pt = packed.get(p)
            if pt is not None and tuple(pt.shape) != shape:
                raise ValueError(f"{p}: shape {pt.shape} != {shape}")
            i = self._local(p, s)
            if i is None:
                continue
            if pt is None:
                pos[i].zero_()
                neg[i].zero_()
                scales[i].zero_()
                continue
            pos[i].copy_(pt.pos.reshape(-1))
            neg[i].copy_(pt.neg.reshape(-1))
            scales[i].copy_(pt.scale.to(torch.float32).reshape(()))
        one = build_overlay(self.plan, {
            p: (pos[s:s + 1], neg[s:s + 1], scales[s:s + 1], shape)
            for p, (pos, neg, scales, shape) in self.stacks.items()
            if p in self._vectors})
        for p, vd in tree_util.flatten_with_paths(one or {}):
            dst = self._vectors[p].values
            if self.plan[p].units:
                dst[:, s].copy_(vd.values[:, 0])
            else:
                dst[s].copy_(vd.values[0])
        self.fills += 1
