"""The port's admission schedulers against the JAX package's: the same
random push / release / take_wave / candidates / remove / note_deferred
sequences through ``repro_torch.serve.scheduler`` and
``repro.serve.scheduler`` give the same uids in the same order, the same
expert tuples and the same stats, under FIFO, priority and affinity."""

import random

import pytest

from repro.serve import Request as JRequest
from repro.serve import scheduler as jsched
from repro_torch.serve import Request
from repro_torch.serve import scheduler as tsched

EXPERTS = ["e0", "e1", "e2", "e3", "__base__"]


def _requests(cls, rng_seed, n=40):
    """Requests with mixed priorities, deadlines (some None) and arrival
    times (some 0, some in the future, some tied)."""
    rng = random.Random(rng_seed)
    out = []
    for uid in range(n):
        arrival = rng.choice([0.0, 0.0, round(rng.uniform(0.01, 2.0), 2),
                              0.5])
        deadline = rng.choice([None, round(arrival + rng.uniform(0.1, 3), 2),
                               1.0])
        out.append(cls(uid=uid, expert=rng.choice(EXPERTS), prompt=[1, 2],
                       max_new_tokens=rng.randrange(1, 9),
                       priority=rng.choice([0, 1, 1, 2]),
                       deadline_s=deadline, arrival_s=arrival))
    return out


def _drive(mod, cls, name, seed):
    """One sequence of scheduler calls; returns everything observable."""
    rng = random.Random(1000 + seed)
    s = mod.make_scheduler(name)
    decisions = []
    s.on_decision = decisions.append
    reqs = _requests(cls, seed)
    uids = lambda rs: [r.uid for r in rs]             # noqa: E731
    seen = [s.name, s.strict_fifo]
    pushed, now = 0, 0.0
    for _ in range(60):
        op = rng.random()
        if op < 0.3 and pushed < len(reqs):
            for r in reqs[pushed:pushed + rng.randrange(1, 6)]:
                s.push(r)
                pushed += 1
        elif op < 0.45:
            now += rng.uniform(0.0, 0.6)
            s.release(now)
        elif op < 0.65:
            w, e = s.take_wave(rng.randrange(1, 5), rng.randrange(1, 4))
            seen.append(("wave", uids(w), list(e)))
        elif op < 0.85:
            slot = {x: i for i, x in enumerate(
                rng.sample(EXPERTS, rng.randrange(0, 3)))}
            cands = s.candidates(slot)
            seen.append(("cands", uids(cands)))
            if cands and rng.random() < 0.5:
                s.remove(cands[min(rng.randrange(0, 3), len(cands) - 1)])
        else:
            s.note_deferred(rng.choice(["stack", "kv_blocks", ""]))
        seen.append((s.pending(), s.ready_count(), s.next_arrival(),
                     uids(s.peek(6)), s.stats()))
    return seen, decisions


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["fifo", "priority", "affinity"])
def test_scheduler_sequences_equal_reference(name, seed):
    ours, our_dec = _drive(tsched, Request, name, seed)
    ref, ref_dec = _drive(jsched, JRequest, name, seed)
    assert ours == ref
    assert our_dec == ref_dec and our_dec
    assert any(x[0] == "wave" and x[1] for x in ours if isinstance(x, tuple)
               and isinstance(x[0], str))


def test_registry_and_flags_equal_reference():
    assert sorted(tsched.SCHEDULERS) == sorted(jsched.SCHEDULERS)
    for name in tsched.SCHEDULERS:
        ours, ref = tsched.make_scheduler(name), jsched.make_scheduler(name)
        assert (ours.name, ours.strict_fifo, ours.stats()) == \
            (ref.name, ref.strict_fifo, ref.stats())
        assert ours.on_decision is None
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match="unknown scheduler"):
            mod.make_scheduler("lottery")


def test_priority_key_orders_class_deadline_arrival_uid():
    mk = lambda uid, p, d, a: Request(uid=uid, expert="e0", prompt=[1],  # noqa
                                      priority=p, deadline_s=d, arrival_s=a)
    reqs = [mk(0, 1, None, 0.0), mk(1, 0, 5.0, 0.0), mk(2, 0, 2.0, 0.0),
            mk(3, 1, 3.0, 0.0), mk(4, 0, 2.0, 0.0)]
    s = tsched.PriorityScheduler()
    for r in reqs:
        s.push(r)
    assert [r.uid for r in s.candidates({})] == [2, 4, 1, 3, 0]


def test_affinity_is_sticky_and_sorts_its_tuple():
    s = tsched.AffinityScheduler()
    for uid, e in enumerate(["e2", "e1", "e2", "e3", "e1", "e2"]):
        s.push(Request(uid=uid, expert=e, prompt=[1]))
    w, e = s.take_wave(3, 2)
    assert e == sorted(e) and set(e) == {"e1", "e2"}
    assert [r.uid for r in w] == [0, 1, 2]
    assert s.deferred == 1                     # e3's request skipped
    s.push(Request(uid=9, expert="e0", prompt=[1], priority=0))
    w, e = s.take_wave(2, 1)                   # sticky e1/e2 over urgent e0
    assert e in (["e1"], ["e2"])
    cands = s.candidates({"e0": 0})
    assert cands[0].uid == 9                   # in-slot experts first
