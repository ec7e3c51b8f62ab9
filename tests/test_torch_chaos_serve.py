"""Chaos serving in the port against the JAX package: the port's engine
over a remote registry and the reference engine over the same blobs,
under the same seeded faults, end with the same statuses and tokens and
the same ``swap_summary()`` failure, quarantine, retry and prefetch
counts (``tests/test_chaos_serve.py``'s cases, on the qwen2.5-3b smoke
config); a failed fetch inside ``SlotOverlay.place`` changes no slot."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as rapi
from repro import transport as jtp
from repro.configs import get_smoke_config
from repro.models import Runtime, build
from repro.serve import ExpertUnavailable as JExpertUnavailable
from repro.serve import Request as JRequest
from repro_torch import api as tapi
from repro_torch import transport as ttp
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build as t_build
from repro_torch.models.delta import SlotOverlay, plan_overlay
from repro_torch.serve import DONE, FAILED, ExpertUnavailable, Request

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
N_EXPERTS = 3
COUNTS = ("failed", "quarantines", "retries", "prefetch_issued",
          "prefetch_hits", "prefetch_errors", "log_dropped")


@pytest.fixture(scope="module")
def setup():
    """The reference model and experts (``tests/test_chaos_serve.py``),
    their blobs, and the port's model on the same weights."""
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    blobs = jtp.InMemoryTransport()
    for i in range(N_EXPERTS):
        leaves, tdef = jax.tree_util.tree_flatten(base)
        keys = jax.random.split(jax.random.PRNGKey(100 + i), len(leaves))
        ft = jax.tree_util.tree_unflatten(tdef, [
            (l.astype(jnp.float32)
             + 0.01 * jax.random.normal(k, l.shape)).astype(l.dtype)
            for l, k in zip(leaves, keys)])
        rapi.publish(rapi.compress(base, ft, name=f"expert{i}",
                                   density=0.2), blobs)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 6) for _ in range(8)]
    model = t_build(t_smoke("qwen2_5_3b", n_units=1))
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    return api, base, blobs._blobs, prompts, model, tbase


def registries(blobs, faults=(), blackout=(), **kw):
    """The same blobs behind each package's transport, chaos-wrapped
    alike: {"ref": (registry, transport), "port": (...)}."""
    kw.setdefault("quarantine_after", 1)
    kw.setdefault("quarantine_probe_s", 1000.0)
    out = {}
    for k, mod, api, extra in (("ref", jtp, rapi, {}),
                               ("port", ttp, tapi, {"device": "cpu"})):
        inner = mod.InMemoryTransport()
        inner._blobs = dict(blobs)
        tr = (mod.ChaosTransport(inner, blackout=blackout, seed=0,
                                 faults=[mod.ChaosFault(*f) for f in faults])
              if (faults or blackout) else inner)
        out[k] = (api.registry(transport=tr, **kw, **extra), tr)
    return out


def serve_both(setup, stream, regs, max_new=3, **kw):
    """The stream through both engines: {package: (requests, summary)}."""
    api, base, _, prompts, model, tbase = setup
    jr = [JRequest(uid=i, expert=e, prompt=jnp.asarray(prompts[i],
                                                       jnp.int32),
                   max_new_tokens=max_new) for i, e in enumerate(stream)]
    tr = [Request(uid=i, expert=e, prompt=prompts[i], max_new_tokens=max_new)
          for i, e in enumerate(stream)]
    jeng = rapi.serve(api, RT, base, regs["ref"][0], **kw)
    teng = tapi.serve(model, tbase, regs["port"][0], **kw)
    out = {"ref": (jeng.run(jr), jeng.swap_summary()),
           "port": (teng.run(tr), teng.swap_summary())}
    for reg, _ in regs.values():
        reg.close()
    return out


def assert_alike(out):
    """Statuses, tokens, error kinds and the fault counts of both."""
    (jr, js), (tr, ts) = out["ref"], out["port"]
    assert [r.status for r in tr] == [r.status for r in jr]
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    for a, b in zip(tr, jr):
        assert (a.error is None) == (b.error is None)
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}


BLACKOUT = ["expert0", "expert1", "expert2", "expert0", "expert1",
            "expert2"]
PAGED_STREAM = ["expert0", "expert1", "expert0", "expert2", "expert1",
                "expert2", "expert0", "expert1"]


@pytest.mark.parametrize("stream,engine", [
    pytest.param(BLACKOUT, dict(max_batch=6, cache_len=32), id="dense"),
    pytest.param(PAGED_STREAM, dict(max_batch=3, cache_len=32,
                                    kv_layout="paged", scheduler="affinity"),
                 id="paged-affinity")])
def test_blackout_fails_only_affected_requests(setup, stream, engine):
    """expert2 blacked out: its requests fail with the typed error, every
    other request ends done with the no-fault run's tokens (the wave
    composition changed under it), and the counts equal the reference's;
    on paged KV no block is left in use."""
    clean = serve_both(setup, stream, registries(setup[2]), **engine)
    assert_alike(clean)
    want = [r.out_tokens for r in clean["port"][0]]
    out = serve_both(setup, stream, registries(setup[2],
                                               blackout=["expert2"]),
                     **engine)
    assert_alike(out)
    reqs, s = out["port"]
    for r, w in zip(reqs, want):
        if r.expert == "expert2":
            assert r.status == FAILED and r.out_tokens == []
            assert "expert2" in r.error and "unavailable" in r.error
        else:
            assert r.status == DONE and r.out_tokens == w
    assert s["failed"] == 2 and s["quarantines"] == 1
    assert s["prefetch_errors"] >= 1
    assert s["kv"]["blocks_in_use"] == 0
    assert s["log_dropped"] == {"swap": 0, "wave": 0, "failed": 0}


def test_transient_faults_are_absorbed(setup):
    """A timeout and a flipped bit are retried to success: nothing fails,
    tokens equal the no-fault run's, two retries in both packages."""
    stream = ["expert0", "expert1"]
    clean = serve_both(setup, stream, registries(setup[2]), max_batch=2,
                       cache_len=32)
    regs = registries(setup[2], faults=[("expert0", 0, "timeout"),
                                        ("expert1", 0, "bitflip")])
    out = serve_both(setup, stream, regs, max_batch=2, cache_len=32)
    assert_alike(out)
    reqs, s = out["port"]
    assert all(r.status == DONE for r in reqs)
    assert [r.out_tokens for r in reqs] == \
        [r.out_tokens for r in clean["port"][0]]
    assert (s["retries"], s["quarantines"]) == (2, 0)
    assert [f["kind"] for f in regs["port"][1].fired()] == \
        [f["kind"] for f in regs["ref"][1].fired()]


def test_admission_path_failure_does_not_block_queue(setup):
    stream = ["expert0", "expert0", "expert1", "expert0"]
    out = serve_both(setup, stream,
                     registries(setup[2], blackout=["expert1"]),
                     max_batch=2, cache_len=32)
    assert_alike(out)
    assert [r.status for r in out["port"][0]] == [DONE, DONE, FAILED, DONE]


def test_degrade_raise_propagates(setup):
    api, base, blobs, prompts, model, tbase = setup
    regs = registries(blobs, blackout=["expert0"])
    with pytest.raises(JExpertUnavailable):
        rapi.serve(api, RT, base, regs["ref"][0], max_batch=2, cache_len=32,
                   degrade="raise").run([JRequest(
                       uid=0, expert="expert0",
                       prompt=jnp.asarray(prompts[0], jnp.int32))])
    with pytest.raises(ExpertUnavailable, match="expert0"):
        tapi.serve(model, tbase, regs["port"][0], max_batch=2, cache_len=32,
                   degrade="raise").run([Request(uid=0, expert="expert0",
                                                 prompt=prompts[0])])
    for reg, _ in regs.values():
        reg.close()


def tiny(mod, api):
    tau = {"w": np.full((8, 8), 0.5, np.float32)}
    if mod is ttp:
        import torch
        ex = api.compress({"w": torch.from_numpy(tau["w"])}, name="e",
                          density=0.5, device="cpu")
    else:
        ex = api.compress(tau, name="e", density=0.5)
    inner = mod.InMemoryTransport()
    api.publish(ex, inner)
    return mod.ChaosTransport(inner, blackout=["e"], seed=0)


@pytest.mark.parametrize("mod,api", [(jtp, rapi), (ttp, tapi)],
                         ids=["ref", "port"])
def test_quarantine_reprobe_recovers(mod, api):
    """Inside the window every access is refused without touching the
    wire; past it one probe is let through, and a restored replica
    serves and clears the account (the trip count stays)."""
    tr = tiny(mod, api)
    kw = {"device": "cpu"} if mod is ttp else {}
    reg = api.registry(transport=tr, quarantine_after=1,
                       quarantine_probe_s=0.05, **kw)
    with pytest.raises(mod.TransportError):
        reg.get("e")
    fired = len(tr.fired())
    with pytest.raises(mod.TransportError) as ei:
        reg.get("e")
    assert ei.value.quarantined and len(tr.fired()) == fired
    tr.restore("e")
    time.sleep(0.06)
    assert reg.get("e").name == "e"
    h = reg.health()
    assert (h["failures"], h["quarantined"], h["quarantines"]) == ({}, {}, 1)
    reg.close()


@pytest.mark.parametrize("mod,api", [(jtp, rapi), (ttp, tapi)],
                         ids=["ref", "port"])
def test_prefetch_failure_is_counted_and_surfaces(mod, api):
    tr = tiny(mod, api)
    kw = {"device": "cpu"} if mod is ttp else {}
    reg = api.registry(transport=tr, quarantine_after=1,
                       quarantine_probe_s=1000.0, **kw)
    cache = reg.device(1 << 20)
    assert reg.prefetch(["e"]) == 1
    with pytest.raises(mod.TransportError, match="unavailable"):
        cache.fetch("e")
    assert (cache.stats.prefetch_errors, cache.stats.quarantines) == (1, 1)
    reg.close()


@pytest.mark.parametrize("grow", [False, True],
                         ids=["new-expert", "refill-on-growth"])
def test_failed_fetch_in_place_changes_no_slot(setup, grow):
    """``SlotOverlay.place`` fetches every tree it will fill before it
    renames a slot: a fetch that raises, for a new expert or for a kept
    one that a growth of the buffers must refill, leaves ``names``,
    ``_lru``, the buffers and the fill count as they were."""
    _, _, blobs, _, model, tbase = setup
    tr = ttp.InMemoryTransport()
    tr._blobs = dict(blobs)
    trees = {f"expert{i}": tapi.fetch(tr, f"expert{i}", device="cpu").packed
             for i in range(N_EXPERTS)}
    part = dict(list(trees["expert0"].items())[:3])   # fewer leaves
    dead = set()

    def fetch(name):
        if name in dead:
            raise ExpertUnavailable(name, "blacked out")
        return part if name == "small" else trees[name]

    slots = SlotOverlay(plan_overlay(tbase, model.cfg), 2, "cpu")
    first = ["small"] if grow else ["expert0", "expert1"]
    assert slots.place(first, fetch) is not None
    slots.place([first[0]], fetch)                     # reorder the LRU
    before = (list(slots.names), list(slots._lru), slots.fills,
              {p: t[0].clone() for p, t in slots.stacks.items()})
    if grow:
        # expert2 brings leaves "small" lacks: the buffers grow and the
        # kept "small" must be refilled, and its fetch fails
        dead.add("small")
    else:
        dead.add("expert2")
    with pytest.raises(ExpertUnavailable):
        slots.place(["small" if grow else "expert0", "expert2"], fetch)
    assert (slots.names, slots._lru, slots.fills) == before[:3]
    assert set(slots.stacks) == set(before[3])
    for p, t in slots.stacks.items():
        assert bool((t[0] == before[3][p]).all())
    dead.clear()
    assert slots.place([first[0], "expert2"], fetch) is not None
    assert slots.slot_of("expert2") == 1     # free, or expert1's (LRU)
