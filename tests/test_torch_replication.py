"""The port's replicated transport against the JAX package: the same ring
owners for the same replica ids and names, R-way publish, leaf-resumable
mid-stream failover that refetches only unfinished leaves, a corrupt leaf
refetched clean, the hedge winner under seeded link latencies, replica
quarantine and revalidation, repair and the background sweep, ranged
HTTP reads, and the straggler monitor fed the same observations
(:mod:`repro_torch.transport.replication`,
:mod:`repro_torch.distributed.fault`)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as rapi
from repro import transport as jtp
from repro.distributed.fault import StragglerMonitor as JStraggler
from repro_torch import api as tapi
from repro_torch import transport as ttp
from repro_torch.convert import packed_from_jax
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.expert import GOLOMB, PACKED, Expert
from repro_torch.serve.expert_cache import ExpertRegistry

PKGS = {"ref": (jtp, rapi), "port": (ttp, tapi)}


def make_pair(name="cdn", seed=0, shape=(256, 192), nleaves=4):
    """One expert in both packages (the reference's planes carried into
    the port, so both encode the same bytes)."""
    rng = np.random.default_rng(seed)
    tau = {f"l{i}/w": jnp.asarray(rng.normal(0, 7e-4, shape), jnp.float32)
           for i in range(nleaves)}
    j = rapi.compress(tau, name=name, density=0.2)
    p = Expert.from_packed(name, j.kind,
                           packed_from_jax(j.as_(rapi.PACKED), device="cpu"),
                           density=j.density, alpha=j.alpha, meta=j.meta)
    return {"ref": j, "port": p}


def assert_planes(a, b):
    assert set(a) == set(b)
    for p in a:
        for f in ("pos", "neg"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a[p], f)).view(np.uint32),
                np.asarray(getattr(b[p], f)).view(np.uint32))
        assert float(a[p].scale) == float(b[p].scale)


def fast(mod):
    return mod.RetryPolicy(max_attempts=3, backoff_base_s=0.0)


def fleet(mod, n=3, fault_replica=None, replica_faults=(), faults=(),
          **rep_kw):
    """n chaos-wrapped in-memory replicas under one ReplicatedTransport
    (``tests/test_replication.py::fleet``)."""
    inners = [mod.InMemoryTransport() for _ in range(n)]
    chaos = [mod.ChaosTransport(
        inners[i], retry=fast(mod),
        faults=faults if i == fault_replica else (),
        replica_faults=replica_faults if i == fault_replica else ())
        for i in range(n)]
    rep_kw.setdefault("retry", fast(mod))
    return mod.ReplicatedTransport(chaos, **rep_kw), chaos, inners


@pytest.mark.parametrize("ids,R", [
    (["a", "b", "c", "d"], 2), (["a", "b", "c", "d", "e"], 2),
    (None, 1), (None, 3), (["x0", "x1"], 2)])
def test_ring_owners_equal_reference(ids, R):
    n = len(ids) if ids else 5
    names = [f"expert-{i}" for i in range(200)] + ["e0", "e1", "cdn"]
    reps = {k: mod.ReplicatedTransport(
        [mod.InMemoryTransport() for _ in range(n)], replica_ids=ids,
        replication_factor=R) for k, (mod, _) in PKGS.items()}
    for nm in names:
        assert reps["port"]._owners(nm) == reps["ref"]._owners(nm), nm


def test_publish_fans_out_to_the_reference_owners():
    holders = {}
    for k, (mod, api) in PKGS.items():
        fleet_ = [mod.InMemoryTransport() for _ in range(3)]
        infos = [api.publish(make_pair(f"e{i}", seed=i)[k], fleet_,
                             rep=GOLOMB, replication_factor=2)
                 for i in range(4)]
        holders[k] = ([sorted(f._blobs) for f in fleet_],
                      [i["replicas"] for i in infos],
                      [f._blobs for f in fleet_])
    assert holders["port"][:2] == holders["ref"][:2]
    assert holders["port"][2] == holders["ref"][2]      # the same bytes
    assert all(len(r) == 2 for r in holders["port"][1])


def failover_run(k, fault, n=3, R=3, **kw):
    mod, _ = PKGS[k]
    ex = make_pair()[k]
    rep, chaos, _ = fleet(mod, n=n, fault_replica=0, probe_bytes=4096,
                          replication_factor=R, **fault, **kw)
    rep.publish(ex, rep=PACKED)
    got = rep.fetch(ex.name)
    assert_planes(got.packed, ex.packed)
    return ([c.stats.bytes_in for c in chaos], rep.stats.bytes_in,
            rep.stats.bytes_wasted, rep.stats.retries,
            [c.fired() for c in chaos])


def test_midstream_failover_refetches_only_unfinished_leaves():
    """Replica 0 dies after its probe and one leaf: failover pulls only the
    unfinished leaves, nothing twice, and the ledger equals the
    reference's."""
    fault = dict(replica_faults=[ttp.ReplicaFault("blackout", at=2)])
    jfault = dict(replica_faults=[jtp.ReplicaFault("blackout", at=2)])
    got = failover_run("port", fault, quarantine_after=99)
    want = failover_run("ref", jfault, quarantine_after=99)
    assert got == want
    blob = ttp.encode_expert(make_pair()["port"], rep=PACKED)
    per_replica, bytes_in, wasted, retries, fired = got
    assert sum(per_replica) == bytes_in == len(blob)
    assert (wasted, retries) == (0, 1)
    assert fired[0] == [{"name": "cdn", "fetch": 2,
                         "kind": "replica_blackout"}]


def test_corrupt_leaf_from_one_replica_is_refetched_clean():
    got = failover_run("port", dict(faults=[ttp.ChaosFault("cdn", 1,
                                                           "bitflip")]),
                       n=2, R=2)
    want = failover_run("ref", dict(faults=[jtp.ChaosFault("cdn", 1,
                                                           "bitflip")]),
                        n=2, R=2)
    assert got == want
    assert got[2] > 0 and got[3] >= 1        # the corrupt chunk, a retry


def test_single_replica_fails_where_three_survive():
    ex = make_pair()["port"]
    rep1, _, _ = fleet(ttp, n=1, fault_replica=0,
                       replica_faults=[ttp.ReplicaFault("blackout", at=2)],
                       replication_factor=1, probe_bytes=4096)
    rep1.publish(ex, rep=PACKED)
    with pytest.raises(ttp.RetriesExhausted, match="failed after"):
        rep1.fetch(ex.name)
    assert rep1.stats.bytes_wasted == rep1.replicas[0].stats.bytes_in > 0
    with pytest.raises(ttp.ExpertNotFound):
        rep1.fetch_bytes("never-published")


def test_hedge_winner_under_seeded_latencies():
    """A slow primary (0.25 s a chunk) and a fast second replica: after
    the 40 ms hedge budget the fast contender wins, in both packages, and
    pulls the whole blob."""
    out = {}
    for k, (mod, _) in PKGS.items():
        ex = make_pair()[k]
        slow = mod.SimulatedNetworkTransport(latency_s=0.25, seed=0)
        quick = mod.SimulatedNetworkTransport(latency_s=0.002, seed=1)
        rep = mod.ReplicatedTransport([slow, quick], replication_factor=2,
                                      hedge_ms=40, probe_bytes=4096,
                                      retry=fast(mod))
        rep.publish(ex, rep=PACKED)
        t0 = time.perf_counter()
        blob = rep.fetch_bytes(ex.name)
        dt = time.perf_counter() - t0
        assert blob == mod.encode_expert(ex, rep=PACKED)
        assert dt < 0.8, f"{k}: the hedge did not win ({dt:.3f} s)"
        assert quick.stats.bytes_in >= len(blob) - 4096
        out[k] = (quick.stats.bytes_in, len(blob))
    assert out["port"] == out["ref"]


def health_seq(k):
    """Quarantine, a skipped replica, a failed and a good revalidation:
    the health accounts along the way, the fields that read the clock
    (latency EWMA and its verdict) dropped."""
    mod, _ = PKGS[k]
    ex = make_pair()[k]
    rep, chaos, _ = fleet(mod, n=2, fault_replica=0,
                          replica_faults=[mod.ReplicaFault("blackout",
                                                           at=0)],
                          replication_factor=2, probe_bytes=4096,
                          quarantine_after=1, quarantine_probe_s=30.0)
    rep.publish(ex, rep=PACKED)
    assert_planes(rep.fetch(ex.name).packed, ex.packed)

    def view():
        h = rep.health()
        return (h["quarantined"], [(r["failures"], r["quarantines"],
                                    r["quarantined_for_s"] > 0)
                                   for r in h["replicas"]])
    seq = [view()]
    ops = chaos[0].stats.range_fetches + chaos[0].stats.fetches
    rep.fetch_bytes(ex.name)                 # the benched replica skipped
    seq.append(chaos[0].stats.range_fetches + chaos[0].stats.fetches - ops)
    seq.append(rep.revalidate(repair=False))
    seq.append(view())
    chaos[0].restore_replica()
    seq.append(rep.revalidate(repair=False))
    seq.append(view())
    return seq


def test_quarantine_revalidate_recover_as_in_reference():
    got = health_seq("port")
    assert got == health_seq("ref")
    assert got[0][0] == 1 and got[1] == 0
    assert got[2]["recovered"] == 0 and got[4]["recovered"] == 1
    assert got[5][0] == 0


def test_revalidate_repairs_and_the_sweep_stops():
    ex = make_pair()["port"]
    rep, _, inners = fleet(ttp, n=3, replication_factor=2)
    info = rep.publish(ex, rep=GOLOMB)
    inners[info["replicas"][0]]._delete(ex.name)
    assert rep.revalidate(repair=True)["repaired"] == 1
    assert sorted(i for i, t in enumerate(inners) if ex.name in t._blobs) \
        == sorted(info["replicas"])
    assert_planes(rep.fetch(ex.name).packed, ex.packed)

    rep, _, inners = fleet(ttp, n=2, replication_factor=2)
    info = rep.publish(ex, rep=GOLOMB)
    inners[info["replicas"][0]]._delete(ex.name)
    rep.start_sweep(interval_s=0.02)
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not all(
                ex.name in inners[i]._blobs for i in info["replicas"]):
            time.sleep(0.01)
        assert all(ex.name in inners[i]._blobs for i in info["replicas"])
    finally:
        rep.stop_sweep()
    assert rep._sweep_thread is None


def test_http_range_roundtrip_206(tmp_path):
    ex = make_pair()
    ttp.LocalTransport(str(tmp_path)).publish(ex["port"], rep=PACKED)
    blob = ttp.encode_expert(ex["port"], rep=PACKED)
    server, url = ttp.serve_local_http(str(tmp_path))
    try:
        for mod in (ttp, jtp):            # either package's client
            tr = mod.HTTPTransport(url, retry=fast(mod))
            assert tr.get_range("cdn", 100, 1000) == blob[100:1100]
            assert tr.get_range("cdn", 0, len(blob) + 100000) == blob
            assert tr.stats.bytes_wasted == 0
        rep = ttp.ReplicatedTransport(
            [ttp.HTTPTransport(url, retry=fast(ttp)) for _ in range(2)],
            replication_factor=2, probe_bytes=4096, retry=fast(ttp))
        assert rep.fetch_bytes("cdn") == blob
        assert rep.stats.bytes_wasted == 0
        assert_planes(rep.fetch("cdn").packed, ex["ref"].packed)
    finally:
        server.shutdown()


def test_deadline_skips_link_sleep_and_drops_are_waste():
    ex = make_pair()["port"]
    crawl = ttp.SimulatedNetworkTransport(bandwidth_bps=1e3, seed=0)
    crawl.publish(ex, rep=GOLOMB)
    t0 = time.perf_counter()
    with pytest.raises(ttp.DeadlineExceeded):
        crawl.fetch_expert(ex.name, retry=ttp.RetryPolicy(
            max_attempts=3, backoff_base_s=0.0, deadline_s=0.05))
    assert time.perf_counter() - t0 < 1.0
    lossy = ttp.SimulatedNetworkTransport(loss=0.5, seed=3,
                                          retry=fast(ttp))
    lossy.publish(ex, rep=GOLOMB)
    n = len(ttp.encode_expert(ex, rep=GOLOMB))
    failures = 0
    for _ in range(6):
        try:
            lossy.fetch_bytes(ex.name)
        except ttp.RetriesExhausted:
            failures += 1
    drops = lossy.stats.bytes_wasted // n
    assert lossy.stats.bytes_wasted == drops * n
    assert drops == lossy.stats.retries + failures >= 1


def test_straggler_monitor_equals_reference():
    """The EWMA, flags and verdicts over the same fed observations (no
    timing), and the device tier's straggler section built from them."""
    rng = np.random.default_rng(0)
    obs = list(0.01 + 0.002 * rng.random(40))
    obs[10] = obs[25] = obs[26] = 0.2           # three slow promotions
    mons = [StragglerMonitor(), JStraggler()]
    for i, s in enumerate(obs):
        flags = [m.observe(i, s) for m in mons]
        assert flags[0] == flags[1]
        assert mons[0].ewma == mons[1].ewma
        assert mons[0].recommendation() == mons[1].recommendation()
    assert mons[0].flags == 3
    assert mons[0].flagged_steps == mons[1].flagged_steps
    reg = tapi.registry(transport=ttp.InMemoryTransport(), device="cpu")
    cache = reg.device()
    for s in obs:
        cache._observe_promotion(s)
    cache._sync_remote_stats()
    assert cache.stats.straggler_flags == 3
    assert cache.stats.straggler_recommendation == \
        "exclude-host-and-reshard"
    assert reg.health()["straggler"] == {
        "recommendation": "exclude-host-and-reshard", "flags": 3,
        "ewma_s": mons[1].ewma}


def test_registry_replicas_knob_and_health_sections():
    ex = make_pair()
    reg = tapi.registry(replicas=[ttp.InMemoryTransport() for _ in range(3)],
                        replication_factor=2, device="cpu")
    assert isinstance(reg.store.transport, ttp.ReplicatedTransport)
    assert reg.store.transport.replication_factor == 2
    reg.publish(ex["port"], rep=GOLOMB)
    reg.store._evict_cold("cdn")              # the next get fetches
    assert_planes(reg.get("cdn").packed, ex["ref"].packed)
    h = reg.health()
    assert len(h["replicas"]["replicas"]) == 3
    assert h["replicas"]["quarantined"] == 0
    with pytest.raises(ValueError):
        tapi.registry(transport=ttp.InMemoryTransport(),
                      replicas=[ttp.InMemoryTransport()], device="cpu")
    with pytest.raises(ValueError):
        ExpertRegistry(replication_factor=2, device="cpu")
