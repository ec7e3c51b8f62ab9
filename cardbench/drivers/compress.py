"""Window driver of the compression cell: the program's
``repro_torch.api.compress(base, ft, density=...).as_(PACKED)`` over the
cell's fine-tunes, in turn, each synchronised, for the whole window.

Set-up makes the base and ``finetunes`` fine-tunes from the seed and
runs one compression of each (the kernels' first use).  The check holds
the last compression of each fine-tune to the reference: its planes bit
for bit and its scales.
"""

from __future__ import annotations

import dataclasses
import time

from cardbench.lib import serving, weights


@dataclasses.dataclass
class State:
    cell: object
    cfg: dict
    seed: int
    dev: object
    base: dict = None
    tunes: list = None
    last: dict = None
    parts: dict = None


def _once(st: State, i: int):
    from repro_torch import api
    from repro_torch.expert import PACKED
    ex = st.cell.workload["experts"]
    e = api.compress(st.base, st.tunes[i], name=f"x{i}",
                     density=ex["density"], alpha=ex.get("alpha", 1.0),
                     method=ex.get("method", "streaming"), device=st.dev)
    packed = e.as_(PACKED)
    return e, packed


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def setup(cell, seed: int, dev, warm: bool = True) -> State:
    from repro_torch.models import build
    st = State(cell=cell, cfg=cell.config, seed=seed, dev=dev)
    stamp = serving.Stamps(dev)
    st.parts = stamp.parts
    model = build(serving.port_config(st.cfg))
    st.base = serving.make_base(st.cfg, model, seed, dev)
    stamp("base_s")
    flat = weights.flatten(st.base)
    n = cell.workload["experts"]["finetunes"]
    st.tunes = [weights.finetune_tree(st.cfg, flat, seed, i) for i in range(n)]
    stamp("finetunes_s")
    st.last = {}
    for i in range(n):
        _once(st, i)
    stamp("warm_s")
    return st


def window(st: State, seconds: float, rec) -> None:
    n = len(st.tunes)
    rec.leaf_sizes = [t.numel() for t in weights.flatten(st.base).values()]
    rec.compressions = 0
    rec.traced_compressions = 0
    span = st.cell.workload.get("trace_seconds", seconds)
    _sync(st.dev)
    t_open = time.monotonic()
    rec.t_open = t_open
    k = 0
    while True:
        if rec.slice is not None and rec.slice.prof is None:
            rec.slice.start()
        e, packed = _once(st, k % n)
        _sync(st.dev)
        st.last[k % n] = packed
        del e
        k += 1
        if rec.slice is not None and rec.slice.running:
            rec.traced_compressions += 1
            if time.monotonic() - rec.slice.t0 >= span:
                rec.slice.stop()
        if time.monotonic() - t_open >= seconds:
            break
    rec.t_close = time.monotonic()
    if rec.slice is not None and rec.slice.running:
        rec.slice.stop()
    rec.compressions = k
    rec.attempted, rec.failed = k, 0
    rec.tracked = []


def check(st: State, rec, seed: int, control: bool = False) -> dict:
    """Planes and scales of the last compression of each fine-tune against
    the reference's; with ``control`` the reference's own, its task vector
    held in bfloat16, against the float32 one."""
    import torch
    from cardbench.reference import compeft
    ex = st.cell.workload["experts"]
    got = {i: weights.flatten(p) for i, p in st.last.items()}
    st.base = st.tunes = st.last = None
    serving.free()
    off_bits, worst_scale = 0, 0.0
    ctl_bits, ctl_scale = 0, 0.0
    for i in sorted(got):
        for li, (path, *_) in enumerate(weights.layout(st.cfg)):
            base = weights.base_leaf(st.cfg, seed, li, st.dev)
            tuned = weights.finetune_leaf(base, seed, i, li)
            tau = compeft.task_vector(base, tuned)
            del tuned
            sg, s = compeft.compress_leaf(tau, ex["density"],
                                          ex.get("alpha", 1.0))
            pt = got[i][path]
            for sign, plane in ((1, pt.pos), (-1, pt.neg)):
                want = compeft.pack(sg, sign)
                off_bits += _bit_diff(want, plane.reshape(-1))
            worst_scale = max(worst_scale, abs(float(pt.scale) - float(s))
                              / max(abs(float(s)), 1e-30))
            if control:
                low = compeft.task_vector(
                    base, weights.finetune_leaf(base, seed, i, li),
                    torch.bfloat16)
                lsg, ls = compeft.compress_leaf(low, ex["density"],
                                                ex.get("alpha", 1.0))
                for sign in (1, -1):
                    ctl_bits += _bit_diff(compeft.pack(sg, sign),
                                          compeft.pack(lsg, sign))
                ctl_scale = max(ctl_scale, abs(float(ls) - float(s))
                                / max(abs(float(s)), 1e-30))
                del low, lsg
            del base, tau, sg
    out = {"plane_bits_off": off_bits, "scale_rel_err": worst_scale}
    if control:
        out.update(control_plane_bits_off=ctl_bits,
                   control_scale_rel_err=ctl_scale)
    return out


def _bit_diff(a, b) -> int:
    """Bits that differ between two int32 word vectors."""
    import torch
    if a.numel() != b.numel():
        return 32 * max(a.numel(), b.numel())
    x = torch.bitwise_xor(a, b.to(a.device))
    n = 0
    for k in range(32):
        n += int(((x >> k) & 1).sum())
    return n
