"""The port's serving mesh on gloo ranks: the reference mesh test's
traffic (``tests/test_mesh_serve.py``) served by child processes, one per
rank, each on one torch thread on the CPU.  Shared by
``test_torch_mesh.py`` and ``test_torch_mesh_serve.py``.

The parent writes the logical base tree and the task vectors with
``torch.save``; every rank compresses the same experts from them and
serves the same requests.  A rank writes its tokens and
``swap_summary()`` as JSON.  Run as a script, this file is one rank:

    python tests/mesh_cases.py RANK WORLD PORT E M SETUP_DIR CASES OUT
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

BUDGET = 96 * 1024          # below the 6-expert resident set: evictions
N_EXPERTS = 6
ENGINE_KW = dict(max_batch=4, cache_len=64, decode_chunk=4)
SAMPLED = {"temperature": 0.8, "top_k": 5, "seed": 7}
KILL_AT = 2                 # the crash case dies after this chunk


def request_specs(n=10):
    """(uid, expert, prompt ids, budget) of the reference test's
    ``mk_requests``: mixed experts, varied prompts and budgets, more
    requests than ``max_batch`` so waves admit mid-chunk."""
    rng = np.random.default_rng(0)
    out = []
    for u in range(n):
        plen = int(rng.integers(3, 12)) if u % 3 else 11
        out.append((u, f"e{u % N_EXPERTS}",
                    [int(t) for t in np.arange(1, plen + 1) + u],
                    int(3 + u % 5)))
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_world(setup_dir):
    """(model, logical base, experts) of the port, from the parent's
    trees."""
    import torch
    from repro_torch import api as tapi
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    base = torch.load(os.path.join(setup_dir, "base.pt"))
    taus = torch.load(os.path.join(setup_dir, "taus.pt"))
    experts = [tapi.compress(t, name=f"e{i}", density=0.2, device="cpu")
               for i, t in enumerate(taus)]
    model = build(get_smoke_config("qwen2_5_3b", n_units=1))
    return model, base, experts


FAMILY_ARCHS = ("rwkv6_3b", "jamba_1_5_large_398b", "seamless_m4t_medium",
                "internvl2_1b")


def family_world(arch):
    """(model, logical base, experts) of a family outside the overlay at
    smoke size (1 unit), from seeded torch generators, alike in every
    process."""
    import torch
    from repro_torch import api as tapi
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    model = build(get_smoke_config(arch, n_units=1))
    base = model.init(seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    taus = [tree_util.tree_map(
        lambda l: 0.03 * torch.randn(l.shape, generator=gen), base)
        for _ in range(2)]
    return model, base, [tapi.compress(t, name=f"e{i}", density=0.2,
                                       device="cpu")
                         for i, t in enumerate(taus)]


def serve_case(world, case: dict, mesh=None, snapshot_dir=None):
    """One engine over the traffic -> (engine, finished requests).  A
    case may set ``max_batch`` and ``kv_blocks``, and build the registry
    without the engine's mesh (``"registry_mesh": False``).  A case with
    ``"arch"`` (``world`` then :func:`family_world`'s) sends the traffic
    to two experts, so the merge path's batches of 4 rows are cut over
    "model"."""
    from repro_torch import api as tapi
    from repro_torch.serve import Request
    import torch
    model, base, experts = world
    reg = tapi.registry(device="cpu", experts=experts,
                        device_cache_bytes=BUDGET,
                        mesh=mesh if case.get("registry_mesh", True) else None)
    kw = dict(ENGINE_KW, kv_layout=case["kv"], mesh=mesh,
              **{k: case[k] for k in ("max_batch", "kv_blocks") if k in case},
              **(SAMPLED if case.get("sampled") else {}))
    if snapshot_dir is not None:
        # chunks of 2 leave rows of the snapshotted wave unfinished at
        # the crash, so a resume restores their KV
        kw.update(snapshot_dir=snapshot_dir, snapshot_every_chunks=1,
                  decode_chunk=2)
    eng = tapi.serve(model, base, reg, **kw)
    if case.get("op") == "resume":
        return eng, eng.resume()
    specs = request_specs()
    if case.get("arch"):
        specs = [(u, f"e{u % 2}", p, n) for u, _, p, n in specs]
    reqs = [Request(uid=u, expert=e, prompt=torch.as_tensor(p),
                    max_new_tokens=n) for u, e, p, n in specs]
    if case.get("op") == "crash":
        def hook(i):
            if i == KILL_AT:
                raise RuntimeError(f"injected crash at chunk {i}")
        eng.chunk_hooks.append(hook)
        try:
            eng.run(reqs)
        except RuntimeError as e:
            assert "injected crash" in str(e), e
            return eng, []
        raise AssertionError("the crash hook never fired")
    return eng, eng.run(reqs)


def state_rows(eng) -> dict:
    """Per batch size, the rows this rank's kept cache holds (dim 1 of
    its first cache leaf)."""
    out = {}
    for n, st in eng._states.items():
        layer = next(iter(st["cache"]["layers"].values()))
        out[str(n)] = int(next(iter(layer.values())).shape[1])
    return out


def result(eng, done) -> dict:
    s = eng.swap_summary()
    return {"tokens": {str(r.uid): [r.status, [int(t) for t in r.out_tokens]]
                       for r in done},
            # the engine's tier is the registry's, open, after the run
            "own_tier": (eng.cache is eng.registry.device()
                         and eng.cache.slots is eng._slots),
            "state_rows": state_rows(eng),
            "summary": {k: s[k] for k in (
                "n_expert_shards", "admitted", "evictions",
                "stack_evictions", "graph_captures", "kv", "mesh", "shards")
                if k in s}}


def cache_case(world, mesh) -> dict:
    """The device tier and the expert slots on a mesh: three experts in
    three slots (padded to the "expert" axis), the per-shard gauges."""
    from repro_torch import api as tapi
    from repro_torch.distributed.collectives import ServeComm
    from repro_torch.models.delta import SlotOverlay, plan_overlay
    model, base, experts = world
    reg = tapi.registry(device="cpu", experts=experts,
                        device_cache_bytes=BUDGET, mesh=mesh)
    cache = reg.device()
    slots = SlotOverlay(plan_overlay(base, model.cfg), 3, "cpu",
                        comm=ServeComm(mesh, model.cfg.vocab))
    slots.place(("e0", "e1", "e2"), reg.fetch_packed)
    cache.slots = slots
    wq = slots.stacks["blocks/block0/attn/wq"]
    return {"n_shards": cache.n_shards, "n_slots": slots.n_slots,
            "lo": slots.lo, "hi": slots.hi, "names": slots.names,
            "local_rows": int(wq[0].shape[0]),
            "local_scales": [float(x) for x in wq[2]],
            "stats_shards": cache.stats.n_expert_shards,
            "summary": cache.shard_summary(),
            "shard_resident_bytes": cache.shard_resident_bytes(),
            "resident_bytes": cache.resident_bytes(),
            "rebuilt_n_shards": reg.device(mesh=None).n_shards}


def rank_main(argv):
    rank, world_size, port, e, m = (int(a) for a in argv[:5])
    setup_dir, cases, out = argv[5], json.loads(argv[6]), argv[7]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world_size)
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh((e, m), device="cpu")
    world = (port_world(setup_dir)
             if any("arch" not in c for c in cases) else None)
    res = []
    for case in cases:
        if case.get("op") == "cache":
            res.append(cache_case(world, mesh))
            continue
        eng, done = serve_case(
            family_world(case["arch"]) if "arch" in case else world, case,
            mesh=mesh, snapshot_dir=case.get("snapshot_dir"))
        res.append(result(eng, done))
        eng.registry.close()
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def run_mesh(shape, setup_dir, cases, tmp, timeout=240):
    """Serve ``cases`` on a mesh of ``shape`` over gloo ranks -> every
    rank's results (a list per rank, one entry per case)."""
    e, m = shape
    n = e * m
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    outs = [os.path.join(tmp, f"mesh{e}x{m}_rank{r}.json") for r in range(n)]
    kids = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(n),
         str(port), str(e), str(m), setup_dir, json.dumps(cases), outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        errs = []
        for p in kids:
            _, err = p.communicate(timeout=timeout)
            errs.append((p.returncode, err))
        for rc, err in errs:
            assert rc == 0, err[-3000:]
    finally:
        for p in kids:
            if p.poll() is None:
                p.kill()
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    return res


if __name__ == "__main__":
    rank_main(sys.argv[1:])
