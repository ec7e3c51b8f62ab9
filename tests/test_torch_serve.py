"""Serving in the port: greedy token streams identical to the reference
``ServeEngine`` (mixed FIFO waves, ``continuous=False``) on the smoke
configs of qwen2.5-3b, llama-7b, gemma2-9b, qwen3-32b and qwen1.5-110b,
and by merge-on-swap on the MoE configs mixtral-8x7b and llama4-maverick
(whose FFNs no overlay covers), the
mixed-wave-equals-sequential contract, the options the port does not
serve yet, the durability options' checks, ``t_wall`` and
``run(scheduling=)``.  Slot refill and the eager loop are held in
``test_torch_admission.py``, sampled decoding in
``test_torch_sampling.py``."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from arch_cases import MOE_ARCHS, smoke_configs

from repro import api as rapi
from repro.models import Runtime, build
from repro.serve import Request as JRequest
from repro_torch import api as tapi
from repro_torch.convert import params_from_jax
from repro_torch.models import build as t_build
from repro_torch.expert import PACKED
from repro_torch.serve import BASE, ExpertUnavailable, Request
from repro_torch.transport import InMemoryTransport

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and six
    test workers each spinning a pool of every core's threads slow each
    other several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_SETUPS: dict = {}


def _setup(arch):
    if arch not in _SETUPS:
        _SETUPS[arch] = _build_setup(arch)
    return _SETUPS[arch]


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen2_5_3b")


def _build_setup(arch):
    cfg, tcfg = smoke_configs(arch, n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(3)]
    jreg = rapi.registry(experts=[
        rapi.compress(jax.tree_util.tree_map(jnp.asarray, t), name=f"e{i}",
                      density=0.2) for i, t in enumerate(taus)])
    treg = tapi.registry(device="cpu", experts=[
        tapi.compress(params_from_jax(t, device="cpu"), name=f"e{i}",
                      density=0.2, device="cpu") for i, t in enumerate(taus)])
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    model = t_build(tcfg)
    return cfg, api, base, jreg, model, tbase, treg


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, L) for L in lens]


# per arch: prompt lengths and cache length (gemma's prompts outrun its
# smoke window of 32, so the window binds in prefill and in decode)
LENGTHS = {"qwen2_5_3b": ((5, 9, 7, 12, 6, 8), 48),
           "llama_7b": ((5, 9, 7, 12, 6, 8), 48),
           "gemma2_9b": ((35, 41, 37, 44, 36, 40), 64),
           "qwen3_32b": ((5, 9, 7, 12, 6, 8), 48),
           "qwen1_5_110b": ((5, 9, 7, 12, 6, 8), 48),
           "mixtral_8x7b": ((35, 41, 37, 44, 36, 40), 64),
           "llama4_maverick_400b": ((5, 9, 7, 12, 6, 8), 48)}


@pytest.mark.parametrize("arch,chunk", [
    pytest.param("qwen2_5_3b", 3, id="3"),
    pytest.param("qwen2_5_3b", 8, id="8"),
    pytest.param("llama_7b", 3, id="llama_7b-3"),
    pytest.param("gemma2_9b", 8, id="gemma2_9b-8"),
    pytest.param("qwen3_32b", 3, id="qwen3_32b-3"),
    pytest.param("qwen1_5_110b", 8, id="qwen1_5_110b-8"),
    pytest.param("mixtral_8x7b", 3, id="mixtral_8x7b-3"),
    pytest.param("llama4_maverick_400b", 8, id="llama4_maverick_400b-8")])
def test_greedy_tokens_identical_to_reference_engine(arch, chunk):
    """The same tokens as the reference engine; the MoE configs have no
    overlay plan in either package, so both serve them by merge-on-swap
    (one merge per distinct expert, no mixed wave)."""
    cfg, api, base, jreg, model, tbase, treg = _setup(arch)
    lens, cache_len = LENGTHS[arch]
    prompts = _prompts(cfg, 1, lens)
    names = ["e0", "e1", BASE, "e2", "e0", "e1"]
    jr = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=3 + i)
          for i, (n, p) in enumerate(zip(names, prompts))]
    jeng = rapi.serve(api, RT, base, jreg, max_batch=4, cache_len=cache_len,
                      continuous=False, decode_chunk=chunk)
    jeng.run(jr)
    tr = [Request(uid=i, expert=n, prompt=p, max_new_tokens=3 + i)
          for i, (n, p) in enumerate(zip(names, prompts))]
    eng = tapi.serve(model, tbase, treg, max_batch=4, cache_len=cache_len,
                     continuous=False, decode_chunk=chunk)
    eng.run(tr)
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, b.uid
        assert b.status == "done"
    summary, jsummary = eng.swap_summary(), jeng.swap_summary()
    if arch in MOE_ARCHS:
        assert eng._plan is None and jeng._plan is None
        assert summary["n_waves"] == jsummary["n_waves"] == 0
        assert summary["n_swaps"] == jsummary["n_swaps"] == 3
    else:
        assert summary["n_waves"] == 2


@pytest.mark.parametrize("arch", ["qwen3_32b", "qwen1_5_110b"])
def test_paged_refill_tokens_identical_to_reference_engine(arch):
    """The overlay's q/k-norm (qwen3) and QKV-bias (qwen1.5) deltas on the
    paged path: paged KV (blocks of 8), slot refill and chunks of 2, the
    same tokens and admissions as the reference engine."""
    cfg, api, base, jreg, model, tbase, treg = _setup(arch)
    lens, cache_len = LENGTHS[arch]
    prompts = _prompts(cfg, 2, lens)
    names = ["e0", "e1", "e2", BASE, "e1", "e2"]
    kw = dict(max_batch=3, cache_len=cache_len, kv_layout="paged",
              kv_block_size=8, decode_chunk=2)
    jr = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=2 + i % 3)
          for i, (n, p) in enumerate(zip(names, prompts))]
    jeng = rapi.serve(api, RT, base, jreg, **kw)
    jeng.run(jr)
    tr = [Request(uid=i, expert=n, prompt=p, max_new_tokens=2 + i % 3)
          for i, (n, p) in enumerate(zip(names, prompts))]
    eng = tapi.serve(model, tbase, treg, **kw)
    eng.run(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert eng.swap_summary()["admitted"] == jeng.swap_summary()["admitted"]
    assert eng.swap_summary()["admitted"] >= 1


def test_mixed_wave_equals_sequential_and_solo(setup):
    """Every row of a mixed, ragged wave gets exactly the tokens it gets in
    a wave of its own expert and when served alone."""
    cfg, _, _, _, model, tbase, treg = setup
    prompts = _prompts(cfg, 2, (10, 10, 10, 10, 10, 10))
    names = ["e0", "e1", "e2", BASE, "e1", "e0"]

    def mk():
        return [Request(uid=i, expert=n, prompt=p, max_new_tokens=4)
                for i, (n, p) in enumerate(zip(names, prompts))]

    eng = tapi.serve(model, tbase, treg, max_batch=6,
                     cache_len=32, decode_chunk=3)
    mixed = mk()
    eng.run(mixed)
    seq = mk()
    for n in dict.fromkeys(names):
        eng.run([r for r in seq if r.expert == n])
    assert [r.out_tokens for r in mixed] == [r.out_tokens for r in seq]

    ragged = _prompts(cfg, 3, (6, 10, 8))
    wave = [Request(uid=i, expert=f"e{i}", prompt=p, max_new_tokens=3)
            for i, p in enumerate(ragged)]
    eng.run(wave)
    for r in wave:
        solo = Request(uid=10 + r.uid, expert=r.expert, prompt=r.prompt,
                       max_new_tokens=3)
        eng.run([solo])
        assert solo.out_tokens == r.out_tokens, r.uid


@pytest.mark.parametrize("store", ["local", "remote"])
def test_unknown_expert_fails_only_its_requests(setup, store):
    """On a local store an unknown expert raises ``KeyError``, in the port
    as in the reference.  On a remote store whose transport lacks the name
    the fetch ends in a terminal ``ExpertUnavailable``: only its request
    fails, and the others get the local registry's tokens."""
    cfg, api, base, jreg, model, tbase, treg = setup
    prompts = _prompts(cfg, 4, (6, 6, 6))
    names = ["e0", "nope", "e1"]

    def mk():
        return [Request(uid=i, expert=n, prompt=p, max_new_tokens=2)
                for i, (n, p) in enumerate(zip(names, prompts))]

    if store == "local":
        jr = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                       max_new_tokens=2)
              for i, (n, p) in enumerate(zip(names, prompts))]
        with pytest.raises(KeyError):
            rapi.serve(api, RT, base, jreg, max_batch=4,
                       cache_len=16).run(jr)
        for degrade in ("request", "raise"):
            with pytest.raises(KeyError):
                tapi.serve(model, tbase, treg, max_batch=4, cache_len=16,
                           degrade=degrade).run(mk())
        return
    tr = InMemoryTransport()
    for n in ("e0", "e1"):
        tapi.publish(treg.get(n), tr, rep=PACKED)
    rreg = tapi.registry(transport=tr, device="cpu")
    reqs = mk()
    eng = tapi.serve(model, tbase, rreg, max_batch=4, cache_len=16)
    eng.run(reqs)
    assert [r.status for r in reqs] == ["done", "failed", "done"]
    assert "nope" in reqs[1].error and "unavailable" in reqs[1].error
    assert reqs[1].out_tokens == []
    assert eng.swap_summary()["failed"] == 1
    want = mk()
    tapi.serve(model, tbase, treg, max_batch=4, cache_len=16).run(
        [want[0], want[2]])
    assert [reqs[0].out_tokens, reqs[2].out_tokens] == \
        [want[0].out_tokens, want[2].out_tokens]
    with pytest.raises(ExpertUnavailable, match="nope"):
        tapi.serve(model, tbase, rreg, degrade="raise").run(
            [Request(uid=9, expert="nope", prompt=prompts[0])])


@pytest.mark.parametrize("option", [
    {"kv_layout": "paged", "mesh": object()}, {"mesh": object()}])
def test_unported_options_raise(setup, option):
    """Serving meshes are ported (tests/test_torch_mesh_serve.py); a mesh
    without the ("expert", "model") axes raises the reference's error."""
    _, _, _, _, model, tbase, treg = setup
    with pytest.raises(ValueError, match=r"needs \('expert', 'model'\) axes"):
        tapi.serve(model, tbase, treg, **option)


@pytest.mark.parametrize("option,match", [
    ({"scheduler": "affinity", "snapshot_dir": "snapshots",
      "decode_chunk": 0}, "compiled decode loop"),
    ({"snapshot_every_chunks": 2}, "needs snapshot_dir"),
    ({"scheduler": "priority", "snapshot_dir": "snapshots",
      "snapshot_every_chunks": -1}, "must be >= 0")])
def test_snapshot_options_checked(setup, option, match):
    """The reference's own checks of the durability options, with its
    messages: a journal needs chunk boundaries, a cadence needs a
    directory and cannot be negative."""
    _, api, base, jreg, model, tbase, treg = setup
    with pytest.raises(ValueError, match=match):
        rapi.serve(api, RT, base, jreg, **option)
    with pytest.raises(ValueError, match=match):
        tapi.serve(model, tbase, treg, **option)


def test_serve_refuses_sampling_and_flat_knobs(setup):
    """``sampling=`` and flat ``temperature``/``top_k``/``seed`` together
    raise, in the port as in the reference."""
    from repro.serve import SamplingConfig as JSampling
    from repro_torch.serve import SamplingConfig
    _, api, base, jreg, model, tbase, treg = setup
    with pytest.raises(ValueError, match="not both"):
        rapi.serve(api, RT, base, jreg, sampling=JSampling(), seed=3)
    with pytest.raises(ValueError, match="not both"):
        tapi.serve(model, tbase, treg, sampling=SamplingConfig(), seed=3)


def test_run_stamps_t_wall(setup):
    """``run()`` stamps each request's ``t_wall`` (epoch seconds at its
    arrival) unless it carries one, as the reference does."""
    cfg, _, _, _, model, tbase, treg = setup
    p = _prompts(cfg, 6, (5, 5))
    reqs = [Request(uid=0, expert="e0", prompt=p[0], max_new_tokens=2,
                    arrival_s=0.25),
            Request(uid=1, expert="e1", prompt=p[1], max_new_tokens=2,
                    t_wall=123.0)]
    t0 = time.time()
    tapi.serve(model, tbase, treg, max_batch=2, cache_len=16).run(reqs)
    assert t0 + 0.25 <= reqs[0].t_wall <= time.time() + 0.25
    assert reqs[1].t_wall == 123.0


@pytest.mark.parametrize("cfg_mode,run_mode", [("mixed", "grouped"),
                                               ("grouped", "mixed")])
def test_run_scheduling_overrides_config(setup, cfg_mode, run_mode):
    """``run(requests, scheduling=)`` serves this run by the given mode
    whatever ``cfg.scheduling`` says: tokens equal to the reference
    engine's run in the same mode."""
    cfg, api, base, jreg, model, tbase, treg = setup
    prompts = _prompts(cfg, 7, (6, 8, 7, 6))
    names = ["e0", "e1", "e0", BASE]
    jr = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=3)
          for i, (n, p) in enumerate(zip(names, prompts))]
    rapi.serve(api, RT, base, jreg, max_batch=4, cache_len=24,
               scheduling=cfg_mode).run(jr, scheduling=run_mode)
    tr = [Request(uid=i, expert=n, prompt=p, max_new_tokens=3)
          for i, (n, p) in enumerate(zip(names, prompts))]
    eng = tapi.serve(model, tbase, treg, max_batch=4, cache_len=24,
                     scheduling=cfg_mode)
    eng.run(tr, scheduling=run_mode)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    s = eng.swap_summary()
    if run_mode == "grouped":
        assert s["n_waves"] == 0 and s["n_batches"] > 0
    else:
        assert s["n_waves"] > 0 and s["n_batches"] == 0
    with pytest.raises(ValueError, match="scheduling"):
        eng.run(tr, scheduling="nope")
