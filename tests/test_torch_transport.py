"""The port's transports and remote tier against the JAX package: blobs
published by either package fetch bit-identically in the other over the
in-memory, filesystem, simulated-link and loopback-HTTP backends for
every wire representation; retry schedules and error classes equal the
reference's for the same seed; one chaos schedule fires the same faults;
the cold tier's byte-budget LRU evicts the same names; a local overlay
beats a staged prefetch; and the prefetch pipeline stages on the host
only (:mod:`repro_torch.transport`, :mod:`repro_torch.serve.
expert_cache`)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro import transport as jtp
from repro_torch import api as tapi
from repro_torch import transport as ttp
from repro_torch.convert import packed_from_jax
from repro_torch.expert import DENSE, GOLOMB, PACKED, Expert
from repro_torch.serve import ExpertUnavailable

WIRE_REPS = (DENSE, PACKED, GOLOMB)
FAST = dict(max_attempts=3, backoff_base_s=0.0)


def taus(seed=0, shape=(256, 192)):
    rng = np.random.default_rng(seed)
    return {"l0/wq": rng.normal(0, 7e-4, shape).astype(np.float32),
            "l0/wo": rng.normal(0, 7e-4, (shape[1], 70)).astype(np.float32)}


def pair(name="wire", seed=0, density=0.05):
    """One expert in both packages: the reference's compression, its
    planes and scales carried into the port."""
    t = taus(seed)
    j = rapi.compress({k: jnp.asarray(v) for k, v in t.items()}, name=name,
                      density=density, meta={"task": "unit-test"})
    p = Expert.from_packed(name, j.kind,
                           packed_from_jax(j.as_(rapi.PACKED), device="cpu"),
                           density=j.density, alpha=j.alpha, meta=j.meta)
    return j, p


def assert_planes(a, b):
    """Port planes ``a`` bitwise equal to planes ``b`` of either package."""
    assert set(a) == set(b)
    for path in a:
        for f in ("pos", "neg"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a[path], f)).view(np.uint32),
                np.asarray(getattr(b[path], f)).view(np.uint32))
        assert float(a[path].scale) == float(b[path].scale)
        assert tuple(a[path].shape) == tuple(b[path].shape)


def backends(kind, tmp_path):
    """A (reference, port) pair of transports over one storage, and a
    stop function."""
    if kind in ("memory", "simulated"):
        j, t = jtp.InMemoryTransport(), ttp.InMemoryTransport()
        t._blobs = j._blobs
        if kind == "simulated":
            j = jtp.SimulatedNetworkTransport(bandwidth_bps=1e9,
                                              latency_s=0.002, inner=j)
            t = ttp.SimulatedNetworkTransport(bandwidth_bps=1e9,
                                              latency_s=0.002, inner=t)
        return j, t, lambda: None
    j = jtp.LocalTransport(str(tmp_path))
    t = ttp.LocalTransport(str(tmp_path))
    if kind == "local":
        return j, t, lambda: None
    server, url = ttp.serve_local_http(str(tmp_path))
    return (jtp.HTTPTransport(url), ttp.HTTPTransport(url),
            server.shutdown)


@pytest.mark.parametrize("rep", WIRE_REPS)
@pytest.mark.parametrize("kind", ["memory", "local", "simulated", "http"])
def test_blobs_cross_packages_bit_identical(tmp_path, kind, rep):
    """A blob published by one package fetches in the other with the
    publisher's planes bitwise; both packages write the same bytes."""
    jex, tex = pair()
    jtr, ttr, stop = backends(kind, tmp_path)
    pub = jtr if kind != "http" else jtp.LocalTransport(str(tmp_path))
    try:
        jinfo = rapi.publish(jex, pub, rep=rep)
        got, n = ttr.fetch_expert("wire")
        assert n == jinfo["nbytes"]
        assert all(pt.pos.device.type == "cpu" for pt in got.packed.values())
        assert_planes(got.packed, jex.packed)
        assert got.meta == jex.meta and got.density == jex.density
        blob = (pub.fetch_bytes("wire") if kind != "http"
                else open(tmp_path / "wire.cpft", "rb").read())
        assert ttp.encode_expert(tex, rep=rep) == blob
        tex.name = "back"
        tpub = ttr if kind != "http" else ttp.LocalTransport(str(tmp_path))
        tapi.publish(tex, tpub, rep=rep)
        assert_planes(tex.packed, rapi.fetch(jtr, "back").packed)
        assert_planes(tex.packed,
                      tapi.fetch(ttr, "back", device="cpu").packed)
    finally:
        stop()


@pytest.mark.parametrize("seed,name", [(0, "ex"), (3, "ex"), (3, "other"),
                                       (11, "a-long-expert-name")])
def test_retry_schedule_equals_reference(seed, name):
    kw = dict(seed=seed, backoff_base_s=0.05, backoff_multiplier=2.0,
              jitter=0.1)
    jp, tp = jtp.RetryPolicy(**kw), ttp.RetryPolicy(**kw)
    got = [tp.backoff_s(a, name) for a in range(6)]
    assert got == [jp.backoff_s(a, name) for a in range(6)]
    for a, d in enumerate(got):
        assert 0.05 * 2.0 ** a * 0.9 <= d <= 0.05 * 2.0 ** a * 1.1
    assert ttp.RetryPolicy(seed=seed, jitter=0.0).backoff_s(2, name) == \
        jtp.RetryPolicy(seed=seed, jitter=0.0).backoff_s(2, name)
    with pytest.raises(ValueError):
        ttp.RetryPolicy(max_attempts=0)


def test_error_classes_classified_as_in_reference():
    names = ["ChecksumError", "WireFormatError", "TransportError",
             "TransientTransportError", "FetchTimeout", "ReplicaUnreachable",
             "ExpertNotFound", "RetriesExhausted", "DeadlineExceeded"]
    for n in names:
        assert ttp.is_retryable(getattr(ttp, n)("x")) == \
            jtp.is_retryable(getattr(jtp, n)("x")), n
    assert not ttp.is_retryable(ValueError("not transport-related"))
    assert issubclass(ExpertUnavailable, ttp.TransportError)


def chaos_run(mod, pkg_api, ex, faults, blackout=(), rep=GOLOMB):
    """A fixed sequence of fetches through a chaos-wrapped in-memory
    store: (fired faults, retries, bytes wasted, outcomes)."""
    inner = mod.InMemoryTransport()
    pkg_api.publish(ex, inner, rep=rep)
    tr = mod.ChaosTransport(
        inner, faults=[mod.ChaosFault(*f) for f in faults],
        blackout=blackout, seed=5, retry=mod.RetryPolicy(**FAST))
    outcomes = []
    for _ in range(4):
        try:
            got, n = tr.fetch_expert(ex.name)
            outcomes.append(("ok", n))
        except mod.TransportError as e:
            outcomes.append((type(e).__name__, None))
    return tr.fired(), tr.stats.retries, tr.stats.bytes_wasted, outcomes


@pytest.mark.parametrize("faults,blackout", [
    ([("wire", 0, "bitflip"), ("wire", 1, "partial"),
      ("wire", 3, "timeout")], ()),
    ([("wire", 0, "timeout"), ("wire", 2, "blackout")], ()),
    ([], ("wire",))])
def test_chaos_schedule_fires_as_in_reference(faults, blackout):
    jex, tex = pair()
    want = chaos_run(jtp, rapi, jex, faults, blackout)
    got = chaos_run(ttp, tapi, tex, faults, blackout)
    assert got == want
    assert [f["kind"] for f in got[0]][:len(faults)] == \
        [f[2] for f in faults][:len(got[0])]


def test_simulated_loss_retries_as_in_reference():
    """Seeded loss on the link drops the same attempts in both."""
    jex, tex = pair()
    out = []
    for mod, pkg, ex in ((jtp, rapi, jex), (ttp, tapi, tex)):
        tr = mod.SimulatedNetworkTransport(bandwidth_bps=1e9, loss=0.5,
                                           seed=7)
        pkg.publish(ex, tr, rep=PACKED)
        res = []
        for _ in range(6):
            try:
                tr.fetch_bytes("wire")
                res.append("ok")
            except mod.RetriesExhausted:
                res.append("exhausted")
        out.append((res, tr.stats.retries, tr.stats.bytes_wasted))
    assert out[0] == out[1]


def library(n=4):
    pairs = [pair(f"e{i}", seed=i) for i in range(n)]
    jtr, ttr = jtp.InMemoryTransport(), ttp.InMemoryTransport()
    for j, _ in pairs:
        rapi.publish(j, jtr, rep=GOLOMB)
    ttr._blobs = jtr._blobs
    return pairs, jtr, ttr


def test_cold_budget_lru_evicts_as_in_reference():
    """A cold budget of about two blobs: the same sequence of gets evicts
    the same names and counts the same refetches in both packages."""
    pairs, jtr, ttr = library()
    budget = 2 * len(jtr._blobs["e0"]) + 16
    jreg = rapi.registry(transport=jtr, cold_budget_bytes=budget)
    treg = tapi.registry(transport=ttr, cold_budget_bytes=budget,
                         device="cpu")
    seq = ["e0", "e1", "e2", "e0", "e3", "e1", "e0", "e2"]
    for n in seq:
        jreg.get(n)
        treg.get(n)
        assert sorted(treg.store._lru) == sorted(jreg.store._lru)
    a, b = treg.store, jreg.store
    assert a.cold_evictions == b.cold_evictions > 0
    assert a.remote_totals()["fetches"] == b.remote_totals()["fetches"]
    assert a.cold_resident_bytes() == b.cold_resident_bytes()
    treg.device().fetch("e2")
    assert treg.device().stats.cold_evictions == jreg.store.cold_evictions
    assert_planes(treg.get("e3").packed, pairs[3][0].packed)


def test_remote_registry_overlay_publish_and_names():
    pairs, jtr, ttr = library(2)
    reg = tapi.registry(transport=ttr, device="cpu")
    assert sorted(reg.names()) == ["e0", "e1"] and len(reg) == 2
    assert "e1" in reg and "nope" not in reg
    local = pair("local-only", seed=9)[1]
    reg.add(local)                       # overlay: not uploaded
    assert "local-only" not in ttr and "local-only" in reg
    reg.publish(pair("shared", seed=8)[1], rep=PACKED)
    assert "shared" in ttr and "shared" in jtr
    reg.get("e0")
    assert reg.nbytes("e0") == len(jtr._blobs["e0"])   # bytes on the wire
    with pytest.raises(TypeError, match="transport"):
        tapi.registry(device="cpu").publish(local)
    assert_planes(rapi.fetch(jtr, "shared").packed,
                  pair("shared", seed=8)[1].packed)


def test_as_registry_wraps_a_store():
    from repro_torch.serve.expert_cache import ExpertStore, as_registry
    reg = tapi.registry(device="cpu")
    assert as_registry(reg) is reg
    store = ExpertStore()
    with pytest.warns(DeprecationWarning):
        wrapped = as_registry(store, device="cpu")
    assert wrapped.store is store and wrapped.dev.type == "cpu"
    with pytest.raises(TypeError):
        as_registry(object())


def test_local_overlay_invalidates_staged_prefetch():
    """``add`` of a name whose remote fetch is staged wins: the staged
    planes are dropped, and the overlay's are promoted."""
    _, jtr, ttr = library(1)
    slow = ttp.SimulatedNetworkTransport(bandwidth_bps=1e9,
                                         latency_s=0.05, inner=ttr)
    reg = tapi.registry(transport=slow, device="cpu")
    assert reg.prefetch(["e0"]) == 1
    overlay = pair("e0", seed=99)[1]
    reg.add(overlay)
    assert_planes(reg.device().fetch("e0"), overlay.packed)
    assert reg.device().stats.prefetch_hits == 0
    reg.close()


def test_prefetch_stages_on_the_host_only():
    """A staged promotion is a host tree, consumed by ``fetch``; an expert
    whose planes live on another device is not staged (a worker makes no
    device call), and a staged tree off the host is refused."""
    pairs, jtr, ttr = library(3)
    slow = ttp.SimulatedNetworkTransport(bandwidth_bps=1e9,
                                         latency_s=0.02, inner=ttr)
    reg = tapi.registry(transport=slow, device="cpu")
    cache = reg.device()
    assert reg.prefetch(["e0", "e1", "__base__"]) == 2
    staged = {n: f.result() for n, f in cache._pending.items()}
    for n, (tree, secs) in staged.items():
        assert secs > 0
        assert all(t.device.type == "cpu" for pt in tree.values()
                   for t in (pt.pos, pt.neg, pt.scale))
    for n in ("e0", "e1"):
        assert_planes(cache.fetch(n), pairs[int(n[1])][0].packed)
    st = cache.stats
    assert (st.prefetch_issued, st.prefetch_hits, st.prefetch_errors) == \
        (2, 2, 0)
    assert st.remote_fetches == 2 and st.remote_bytes == slow.stats.bytes_in
    assert reg.prefetch(["e0"]) == 0                 # resident
    # a card-resident expert (here: on the meta device) is not staged
    meta = pair("m", seed=5)[1]
    meta.device = torch.device("meta")
    reg.add(meta)
    assert cache._stage("m") == (None, 0.0)
    # a stage that left planes off the host is refused at fetch
    cache._pending["e2"] = cache._pool.submit(
        lambda: ({p: type(pt)(pos=pt.pos.to("meta"), neg=pt.neg,
                              scale=pt.scale, shape=pt.shape)
                  for p, pt in pairs[2][1].packed.items()}, 0.0))
    with pytest.raises(RuntimeError, match="CUDA call"):
        cache.fetch("e2")
    reg.close()


def test_prefetch_overlaps_the_link():
    """Four fetches over a 0.2 s link: staged on four workers they take
    about one link time, well under the 0.8 s of four in a row."""
    _, jtr, ttr = library(4)
    slow = ttp.SimulatedNetworkTransport(bandwidth_bps=1e9, latency_s=0.2,
                                         inner=ttr)
    reg = tapi.registry(transport=slow, device="cpu")
    t0 = time.perf_counter()
    assert reg.prefetch([f"e{i}" for i in range(4)]) == 4
    for i in range(4):
        reg.device().fetch(f"e{i}")
    assert time.perf_counter() - t0 < 0.6
    assert reg.device().stats.prefetch_hits == 4
    reg.close()


def test_missing_and_unreachable_are_told_apart(tmp_path):
    """Absence is terminal and never retried; a dead origin is
    ``ReplicaUnreachable``; both surface from the store as a typed
    ``ExpertUnavailable``, and only the dead origin counts against
    health."""
    tr = ttp.InMemoryTransport(retry=ttp.RetryPolicy(**FAST))
    with pytest.raises(ttp.ExpertNotFound):
        tr.fetch_bytes("missing")
    assert tr.stats.retries == 0
    reg = tapi.registry(transport=tr, device="cpu", quarantine_after=1)
    with pytest.raises(ExpertUnavailable) as ei:
        reg.get("missing")
    assert ei.value.terminal and reg.health()["quarantines"] == 0
    ttp.LocalTransport(str(tmp_path)).publish(pair()[1])
    server, url = ttp.serve_local_http(str(tmp_path))
    try:
        http = ttp.HTTPTransport(url)
        assert http.contains("wire") and not http.contains("missing")
    finally:
        server.shutdown()
    dead = ttp.HTTPTransport("http://127.0.0.1:9", timeout_s=0.2,
                             retry=ttp.RetryPolicy(max_attempts=1))
    with pytest.raises(ttp.ReplicaUnreachable):
        dead.contains("wire")
    dreg = tapi.registry(transport=dead, device="cpu", quarantine_after=1)
    with pytest.raises(ExpertUnavailable) as ei:
        dreg.get("wire")
    assert not ei.value.terminal
    assert dreg.health()["quarantines"] == 1


def test_concurrent_gets_under_a_cold_budget():
    """Sixteen threads get four remote experts at once under a cold budget
    of about two blobs, with a short switch interval: every get returns
    the publisher's planes, and the budget holds after the storm."""
    import sys
    import threading
    pairs, jtr, ttr = library(4)
    budget = 2 * len(jtr._blobs["e0"]) + 16
    reg = tapi.registry(transport=ttr, cold_budget_bytes=budget,
                        device="cpu")
    errors = []

    def work(k):
        try:
            for i in range(20):
                n = f"e{(k + i) % 4}"
                assert_planes(reg.get(n).packed, pairs[int(n[1])][0].packed)
        except Exception as e:          # reported below, with the others
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert reg.store.cold_resident_bytes() <= budget
    assert reg.store.cold_evictions > 0


def test_remote_names_over_a_transport_that_cannot_enumerate():
    """A transport without ``_names`` (the base raises
    ``NotImplementedError``): the remote store lists its local names, in
    the port as in the reference."""
    from repro.serve.expert_cache import RemoteExpertStore as JStore
    from repro_torch.serve import RemoteExpertStore

    class Bare(ttp.ExpertTransport):
        pass

    class JBare(jtp.ExpertTransport):
        pass

    j, p = pair("local")
    tstore, jstore = RemoteExpertStore(Bare()), JStore(JBare())
    assert tstore.names() == jstore.names() == []
    tstore.put(p)
    jstore.put(j)
    assert tstore.names() == jstore.names() == ["local"]


def test_uncompressed_baseline_bytes_equal_the_reference():
    from repro.serve import uncompressed_baseline_bytes as jbytes
    from repro_torch.serve import uncompressed_baseline_bytes as tbytes
    j, p = pair("base")
    assert tbytes(p) == jbytes(j) == 2 * (256 * 192 + 192 * 70)
    assert tbytes(p.packed) == jbytes(j.packed)
