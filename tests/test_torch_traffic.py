"""The port's seeded traffic generator against ``benchmarks/traffic.py``:
identical timelines (arrivals, experts, prompt tokens, budgets,
priorities, deadlines) for the same config, the Zipf weights and burst
windows, and equal ``summarize`` records on the same served lists,
among them a list the port's engine served open-loop."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import traffic as jtraffic
from repro_torch.serve import DONE, FAILED, Request
from repro_torch.serve import traffic as ttraffic

CONFIGS = [
    {},
    {"seed": 3, "n_requests": 40, "n_experts": 3, "zipf_alpha": 0.0},
    # chip_smoke.py phase 3p's closed traffic at qwen2.5-3b's vocabulary
    {"seed": 0, "n_requests": 24, "n_experts": 4, "prompt_len_short": 16,
     "prompt_len_long": 96, "max_new_short": 8, "max_new_long": 32,
     "vocab": 151936},
    {"seed": 9, "n_requests": 30, "burst_every_s": 0.0, "base_rate": 2.5,
     "priorities": ((0, 1.0), (1, 1.0), (2, 2.0)),
     "deadline_by_priority": ((0, 0.5),)},
]


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_generate_timelines_equal_reference(kw):
    ours = ttraffic.generate(ttraffic.TrafficConfig(**kw))
    ref = jtraffic.generate(jtraffic.TrafficConfig(**kw))
    assert len(ours) == len(ref) == ttraffic.TrafficConfig(**kw).n_requests
    for a, b in zip(ours, ref):
        assert isinstance(a, Request)
        assert (a.uid, a.expert, a.arrival_s, a.max_new_tokens, a.priority,
                a.deadline_s) == (b.uid, b.expert, b.arrival_s,
                                  b.max_new_tokens, b.priority, b.deadline_s)
        assert a.prompt.dtype == torch.int64
        np.testing.assert_array_equal(a.prompt.numpy(), np.asarray(b.prompt))


def test_config_fields_and_helpers_equal_reference():
    names = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa
    assert names(ttraffic.TrafficConfig) == names(jtraffic.TrafficConfig)
    for n, alpha in ((1, 1.1), (4, 1.1), (8, 0.0), (16, 2.5)):
        np.testing.assert_array_equal(ttraffic.zipf_weights(n, alpha),
                                      jtraffic.zipf_weights(n, alpha))
    for kw in ({}, {"burst_every_s": 0.0}, {"burst_duration_s": 2.5}):
        tc, jc = ttraffic.TrafficConfig(**kw), jtraffic.TrafficConfig(**kw)
        for t in np.linspace(0.0, 13.0, 131):
            assert ttraffic.in_burst(t, tc) == jtraffic.in_burst(t, jc)


def _served(seed, n=20):
    """A served list with every case ``summarize`` reads: done rows with
    and without deadline misses, a failed row and one never started."""
    rng = np.random.default_rng(seed)
    out = []
    for r in ttraffic.generate(ttraffic.TrafficConfig(seed=seed,
                                                      n_requests=n)):
        k = rng.random()
        if k < 0.1:
            r.status, r.error = FAILED, "unknown expert"
        elif k < 0.15:
            pass                                   # never got a token
        else:
            r.status = DONE
            r.t_admit_s = r.arrival_s + float(rng.exponential(0.2))
            r.t_first_s = r.t_admit_s + float(rng.exponential(0.05))
            r.t_done_s = r.t_first_s + float(rng.exponential(1.0))
            r.out_tokens = list(range(r.max_new_tokens))
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summarize_equal_on_the_same_served_list(seed):
    reqs = _served(seed)
    assert ttraffic.summarize(reqs) == jtraffic.summarize(reqs)
    assert ttraffic.summarize([]) == jtraffic.summarize([])


def test_summarize_equal_on_an_open_loop_engine_run():
    """A short open-loop timeline served by the port's paged engine (tiny
    random model on the CPU): both summaries agree on what was served."""
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    model = build(get_smoke_config("qwen2_5_3b", n_units=1))
    base = model.init(seed=0, device="cpu")
    eng = api.serve(model, base, api.registry(device="cpu"), max_batch=3,
                    cache_len=64, kv_layout="paged", kv_block_size=8,
                    decode_chunk=4, scheduler="priority")
    cfg = ttraffic.TrafficConfig(seed=5, n_requests=8, n_experts=1,
                                 base_rate=80.0,
                                 vocab=model.cfg.vocab)
    reqs = ttraffic.generate(cfg)
    for r in reqs:
        r.expert = "__base__"
    eng.run(reqs)
    assert all(r.status == DONE and len(r.out_tokens) == r.max_new_tokens
               for r in reqs)
    assert all(r.t_admit_s >= r.arrival_s for r in reqs)
    ours = ttraffic.summarize(reqs)
    assert ours == jtraffic.summarize(reqs)
    assert ours["n_served"] == 8 and ours["tokens_per_s"] > 0
