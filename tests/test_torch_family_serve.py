"""The merge-path engine on the model families outside the overlay
(rwkv6-3b, jamba-1.5-large, seamless-m4t-medium, internvl2-1b) at smoke
size, against the reference engine on the same compressed experts and
the same weights (``test_torch_families.py``'s setup): greedy tokens of
left-padded batches identical, one merge per distinct expert, no mixed
wave in either package; the engine's merge-path rules (``start`` only
for pure-attention decoder-only patterns, zero stub frames or mm
embeddings, slot refill only for pure-attention patterns), paged KV
refused, and ``resume()`` refused naming its ROADMAP item, as in the
reference; and on a (1, 2) serving mesh of two gloo ranks (rows, their
recurrent states and cross-KV cut over "model", the embedding and head
vocab-parallel) the tokens of ``mesh=None``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import FAMILIES, _one_torch_thread, _setup  # noqa: F401

from repro import api as rapi
from repro.models import Runtime
from repro.serve import Request as JRequest
from repro_torch import api as tapi
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build as t_build
from repro_torch.serve import BASE, Request
from repro_torch.serve.engine import _row_mask_ok

_ENGINES: dict = {}
# per arch: prompt lengths (left-padded in a batch) and cache length
PROMPTS = ((5, 9, 7, 12, 6, 8), 40)


def _engine_setup(arch):
    if arch not in _ENGINES:
        cfg, api, base, model, tbase = _setup(arch, n_units=1)
        rng = np.random.default_rng(0)
        taus = [jax.tree_util.tree_map(
            lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32),
            base) for _ in range(3)]
        jreg = rapi.registry(experts=[
            rapi.compress(jax.tree_util.tree_map(jnp.asarray, t),
                          name=f"e{i}", density=0.2)
            for i, t in enumerate(taus)])
        treg = tapi.registry(device="cpu", experts=[
            tapi.compress(params_from_jax(t, device="cpu"), name=f"e{i}",
                          density=0.2, device="cpu")
            for i, t in enumerate(taus)])
        _ENGINES[arch] = (cfg, api, base, jreg, model, tbase, treg)
    return _ENGINES[arch]


def _requests(cfg, cls, conv):
    rng = np.random.default_rng(1)
    lens, _ = PROMPTS
    names = ["e0", "e1", BASE, "e2", "e0", "e1"]
    return [cls(uid=i, expert=n,
                prompt=conv(rng.integers(1, cfg.vocab, L)),
                max_new_tokens=3 + i)
            for i, (n, L) in enumerate(zip(names, lens))]


@pytest.mark.parametrize("arch,chunk", [("rwkv6_3b", 3),
                                        ("jamba_1_5_large_398b", 4),
                                        ("seamless_m4t_medium", 3),
                                        ("internvl2_1b", 0)])
def test_merge_path_tokens_identical_to_reference_engine(arch, chunk):
    """Both engines serve these families by merge-on-swap (no plan): the
    same greedy tokens for left-padded batches (no ``start`` for these
    patterns, so a padded row sees its pads in both packages; zero stub
    frames or mm embeddings), one merge per distinct expert, the same
    batches."""
    cfg, api, base, jreg, model, tbase, treg = _engine_setup(arch)
    _, cache_len = PROMPTS
    rt = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
    jr = _requests(cfg, JRequest, lambda p: jnp.asarray(p, jnp.int32))
    jeng = rapi.serve(api, rt, base, jreg, max_batch=4, cache_len=cache_len,
                      continuous=False, decode_chunk=chunk)
    jeng.run(jr)
    tr = _requests(cfg, Request, lambda p: p)
    eng = tapi.serve(model, tbase, treg, max_batch=4, cache_len=cache_len,
                     continuous=False, decode_chunk=chunk)
    eng.run(tr)
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, b.uid
        assert b.status == "done"
    s, js = eng.swap_summary(), jeng.swap_summary()
    assert eng._plan is None and jeng._plan is None
    assert s["n_waves"] == js["n_waves"] == 0
    assert s["n_swaps"] == js["n_swaps"] == 3
    assert s["n_batches"] == len(eng.batch_log) == 4


@pytest.mark.parametrize("arch", FAMILIES + ("qwen2_5_3b",))
def test_merge_path_rules(arch):
    """``start`` only for a pure-attention decoder-only pattern with no
    frontend; slot refill only for a pure-attention pattern; the stub
    modality input of [rows, n_tokens, embed_dim] f32 zeros."""
    cfg = t_smoke(arch, n_units=1)
    model = t_build(cfg)
    base = model.init(seed=0, device="cpu")
    eng = tapi.serve(model, base, tapi.registry(device="cpu"), max_batch=2,
                     cache_len=32, continuous=True)
    assert _row_mask_ok(eng.api.cfg) == (arch == "qwen2_5_3b")
    assert eng._can_admit() == (arch in ("qwen2_5_3b",
                                         "seamless_m4t_medium",
                                         "internvl2_1b"))
    stub = eng._frontend_stub(3)
    if cfg.frontend is None:
        assert stub == {}
    else:
        (key, t), = stub.items()
        assert key == ("frames" if cfg.family == "audio" else "mm_embeds")
        assert tuple(t.shape) == (3, cfg.frontend.n_tokens,
                                  cfg.frontend.embed_dim)
        assert t.dtype == torch.float32 and not t.any()


def test_padded_rows_see_their_pads_in_both_packages():
    """The repair the merge-path rules make: a left-padded batch of a
    recurrent model is prefilled without ``start``, as the reference's
    engine does (jamba, whose attention block would otherwise mask the
    pads, so the first tokens differ for this batch)."""
    cfg, api, base, jreg, model, tbase, treg = _engine_setup(
        "jamba_1_5_large_398b")
    tr = [dataclasses.replace(r, expert=BASE)
          for r in _requests(cfg, Request, lambda p: p)[:2]]
    eng = tapi.serve(model, tbase, treg, max_batch=2, cache_len=40,
                     continuous=False, decode_chunk=0)
    eng.run(tr)
    width = max(len(r.prompt) for r in tr)
    toks = torch.stack([torch.cat([torch.ones(width - len(r.prompt),
                                              dtype=torch.int64),
                                   torch.as_tensor(r.prompt)])
                        for r in tr])
    start = torch.tensor([width - len(r.prompt) for r in tr],
                         dtype=torch.int32)
    with torch.no_grad():
        ln, _ = model.prefill(tbase, {"tokens": toks}, 40)
        ls, _ = model.prefill(tbase, {"tokens": toks}, 40, start=start)
    first = [r.out_tokens[0] for r in tr]
    assert first == ln[:, -1].argmax(-1).tolist()
    assert first != ls[:, -1].argmax(-1).tolist()


def test_resume_is_refused_naming_its_item(tmp_path):
    """The reference resumes only the mixed overlay path; a family with no
    plan journals its run and refuses ``resume()``, naming ROADMAP item 9."""
    model = t_build(t_smoke("rwkv6_3b", n_units=1))
    base = model.init(seed=0, device="cpu")
    eng = tapi.serve(model, base, tapi.registry(device="cpu"), max_batch=2,
                     cache_len=32, decode_chunk=2,
                     snapshot_dir=str(tmp_path))
    eng.run([Request(uid=0, expert=BASE, prompt=np.arange(1, 6),
                     max_new_tokens=3)])
    with pytest.raises(ValueError, match="item 9"):
        eng.resume()


def test_paged_kv_is_refused_for_these_families():
    for arch in FAMILIES:
        model = t_build(t_smoke(arch, n_units=1))
        with pytest.raises(ValueError, match="pure-attention"):
            tapi.serve(model, model.init(seed=0, device="cpu"),
                       tapi.registry(device="cpu"), kv_layout="paged",
                       decode_chunk=2)


def test_mesh_rows_cut_over_model_give_mesh_free_tokens(tmp_path):
    """The reference's serve rules cut a wave's 5-D cache leaves (KV rings,
    rwkv state, the cross-KV) by batch rows along "model"; the port cuts
    every cache leaf with its rows, recurrent states and the cross-KV
    included.  Batches of 4 rows on two experts, on two gloo ranks of a
    (1, 2) mesh: every rank's tokens equal ``mesh=None``'s."""
    import mesh_cases as mc
    cases = [{"kv": "dense", "arch": a} for a in mc.FAMILY_ARCHS]
    want = [mc.result(*mc.serve_case(mc.family_world(c["arch"]), c))
            for c in cases]
    res = mc.run_mesh((1, 2), str(tmp_path), cases, str(tmp_path))
    for rank, per_case in enumerate(res):
        for case, got, w in zip(cases, per_case, want):
            where = f"rank={rank} case={case}"
            assert got["tokens"] == w["tokens"], where
            assert all(st == "done" for st, _ in got["tokens"].values())
            assert got["summary"]["mesh"] == {"expert": 1, "model": 2}
            assert w["state_rows"]["4"] == 4
            assert got["state_rows"]["4"] == 2, where   # rows cut in two
