"""SIGKILL child: serve a run with a snapshot after every chunk, then kill
the process from a chunk hook.

    python -m repro_torch.serve.restart_child SNAPSHOT_DIR SETUP_DIR KILL_AT [--device cpu]

The parent writes ``SETUP_DIR`` with :func:`write_setup`: the base
parameters as a checkpoint (``base/``, through
:func:`repro_torch.checkpoint.manager.save`), the experts as wire blobs in
a :class:`~repro_torch.transport.LocalTransport` directory (``experts/``),
and ``setup.json`` (the model config, the registry and engine keywords,
the requests and the parent's matmul precision flags).  The child
restores the base with :func:`~repro_torch.checkpoint.manager.restore`,
serves the requests through ``api.serve(snapshot_dir=SNAPSHOT_DIR,
snapshot_every_chunks=1, ...)`` and, when chunk ``KILL_AT`` has been
flushed and journaled, sends itself ``SIGKILL``: no atexit handler, no
buffered flush and no ``__del__`` runs.  The parent checks the death by
signal and resumes from what the journal and the snapshots made durable.
The child exits 3 if it was never killed (``KILL_AT`` past the run's
last chunk).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys

import torch

from repro_torch.expert import PACKED

# the matmul precision flags a bf16 or tf32 stream depends on; the child
# takes the parent's
_FLAGS = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
          "allow_fp16_reduced_precision_reduction")


def write_setup(setup_dir: str, *, arch: str, n_units: int, base: dict,
                experts, requests, engine_kw: dict, smoke: bool = False,
                dtype: str | None = None,
                registry_kw: dict | None = None) -> None:
    """Write everything the child needs into ``setup_dir``: ``base`` saved
    as step 0 of ``base/``, ``experts`` published as PACKED blobs (no
    decode on arrival) into ``experts/``, and ``setup.json``.  The model is ``arch``'s config
    (its smoke config with ``smoke``) with ``n_units`` units, and
    ``dtype`` widens it and the restored base (an f32 copy)."""
    from repro_torch import api
    from repro_torch.checkpoint import manager
    from repro_torch.transport import LocalTransport
    manager.save(base, os.path.join(setup_dir, "base"), 0)
    tr = LocalTransport(os.path.join(setup_dir, "experts"))
    for e in experts:
        api.publish(e, tr, rep=PACKED)
    spec = {
        "model": {"arch": arch, "n_units": n_units, "smoke": smoke,
                  "dtype": dtype},
        "registry": dict(registry_kw or {}),
        "engine": dict(engine_kw),
        "flags": {f: getattr(torch.backends.cuda.matmul, f)
                  for f in _FLAGS},
        "requests": [{
            "uid": r.uid, "expert": r.expert,
            "prompt": [int(t) for t in
                       torch.as_tensor(r.prompt).reshape(-1).tolist()],
            "max_new_tokens": r.max_new_tokens, "priority": r.priority,
            "deadline_s": r.deadline_s, "arrival_s": r.arrival_s,
        } for r in requests],
    }
    with open(os.path.join(setup_dir, "setup.json"), "w") as f:
        json.dump(spec, f)


def load_setup(setup_dir: str, device="cuda") -> tuple:
    """-> (model, base, registry, requests, engine keywords) from a
    directory written by :func:`write_setup`."""
    from repro_torch import api
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import manager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import build
    from repro_torch.serve import Request
    from repro_torch.transport import LocalTransport
    with open(os.path.join(setup_dir, "setup.json")) as f:
        spec = json.load(f)
    for flag, value in spec["flags"].items():
        setattr(torch.backends.cuda.matmul, flag, value)
    m = spec["model"]
    cfg = (get_smoke_config(m["arch"], n_units=m["n_units"]) if m["smoke"]
           else dataclasses.replace(get_config(m["arch"]),
                                    n_units=m["n_units"]))
    model = build(cfg)
    base = manager.restore(model.init(device=device),
                           os.path.join(setup_dir, "base"), device=device)
    if m["dtype"] is not None:
        model = build(dataclasses.replace(cfg, dtype=m["dtype"]))
        wide = getattr(torch, m["dtype"])
        base = tree_util.tree_map(lambda t: t.to(wide), base)
    reg = api.registry(transport=LocalTransport(
        os.path.join(setup_dir, "experts")), device=device,
        **spec["registry"])
    requests = [Request(uid=d["uid"], expert=d["expert"],
                        prompt=torch.as_tensor(d["prompt"],
                                               dtype=torch.int32),
                        max_new_tokens=d["max_new_tokens"],
                        priority=d["priority"], deadline_s=d["deadline_s"],
                        arrival_s=d["arrival_s"])
                for d in spec["requests"]]
    return model, base, reg, requests, spec["engine"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("snapshot_dir")
    ap.add_argument("setup_dir")
    ap.add_argument("kill_at", type=int,
                    help="the chunk after whose flush the child dies")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch import api
    torch.set_grad_enabled(False)
    model, base, reg, requests, engine_kw = load_setup(args.setup_dir,
                                                       args.device)
    eng = api.serve(model, base, reg, snapshot_dir=args.snapshot_dir,
                    snapshot_every_chunks=1, **engine_kw)

    def die(i: int) -> None:
        if i == args.kill_at:
            os.kill(os.getpid(), signal.SIGKILL)

    eng.chunk_hooks.append(die)
    eng.run(requests)
    return 3          # survived: kill_at never came


if __name__ == "__main__":
    sys.exit(main())
