"""The port's expert artifact against the JAX package's: every lattice
transition (DENSE, TERNARY, PACKED, GOLOMB), the exact (sort-based)
compression, the Golomb codec, ``.npz`` and ``.cpft`` files crossing
between the two packages in both directions, the wire format's checks,
and a cold-Golomb registry serving the reference engine's greedy tokens.

Inputs are numpy arrays from a seeded generator, handed to both
packages.  Signs, planes, Golomb streams and files are compared
bitwise.  A scale computed by both packages is held within 1e-6
relative: ``jnp.std`` and ``torch.std`` sum in different orders.  A
scale carried by a file is compared bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.core import golomb as jgolomb
from repro.core.compeft import CompressionConfig as JConfig
from repro.core.compeft import compress as j_compress
from repro.expert import Expert as JExpert
from repro.expert import _flatten as j_flat
from repro.transport import wire as jwire
from repro_torch import api as tapi
from repro_torch import tree as tree_util
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core import golomb
from repro_torch.core.compeft import CompressionConfig, compress
from repro_torch.core.packing import pack_tree, unpack_tree
from repro_torch.expert import (DENSE, GOLOMB, PACKED, REPRESENTATIONS,
                                TERNARY, Expert)
from repro_torch.kernels import ops
from repro_torch.transport import wire

RTOL_SCALE = 1e-6


def _tau_np(seed=0):
    """Leaves with n % 32 != 0, a 3-D leaf, a bf16 leaf, ties, zeros and
    -0.0."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_t(3, (37, 45)) * 1e-3).astype(np.float32)
    a[0, :9] = a[1, 0]                              # ties
    a[2, :5] = -0.0
    a[3, :5] = 0.0
    return {
        "blk": {"w": a,
                "b": (rng.standard_t(3, (33,)) * 1e-3).astype(np.float32)},
        "conv": (rng.standard_t(3, (3, 7, 11)) * 1e-3).astype(np.float32),
        "emb": np.asarray(rng.standard_t(3, (16, 64)) * 1e-3,
                          dtype=jnp.bfloat16),
    }


def _jax_tree(tau_np):
    return jax.tree_util.tree_map(jnp.asarray, tau_np)


def _t(tau_np):
    return params_from_jax(tau_np, device="cpu")


def _i32(a):
    return np.asarray(a).view(np.int32)


def _assert_planes(got: dict, want: dict, scale_rtol=0.0):
    """Port ``{path: PackedTernary}`` vs the reference's, planes bitwise."""
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        np.testing.assert_array_equal(g.pos.numpy(), _i32(w.pos), path)
        np.testing.assert_array_equal(g.neg.numpy(), _i32(w.neg), path)
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.orig_dtype).replace("torch.", "") == str(
            jnp.dtype(w.orig_dtype)), path
        if scale_rtol:
            np.testing.assert_allclose(float(g.scale), float(w.scale),
                                       rtol=scale_rtol, err_msg=path)
        else:
            assert np.float32(g.scale) == np.float32(w.scale), path


def _cpu_expert(jex: JExpert, name=None) -> Expert:
    """The reference expert's planes and scales, carried into the port."""
    return Expert.from_packed(name or jex.name, jex.kind,
                              packed_from_jax(jex.as_(rapi.PACKED),
                                              device="cpu"),
                              density=jex.density, alpha=jex.alpha,
                              meta=jex.meta)


@pytest.mark.parametrize("n", [1, 33, 1000, 4097, (1 << 24) + 5])
def test_exact_threshold_bitwise_equals_jnp_quantile(n):
    """The reference's ``jnp.quantile`` to the bit: its f32 index (rounded
    above 2**24 elements) and XLA's fused interpolation; ties included."""
    from repro.core.compeft import _topk_threshold as j_threshold
    from repro_torch.core.compeft import _topk_threshold
    rng = np.random.default_rng(n)
    mag = np.abs(rng.standard_t(3, n).astype(np.float32))
    mag[:n // 10] = mag[0]
    densities = (0.1,) if n > 1 << 24 else (0.05, 0.1, 0.2, 0.3, 0.5, 1.0,
                                             1e-9)
    for density in densities:
        got = _topk_threshold(torch.from_numpy(mag), density)
        want = j_threshold(jnp.asarray(mag), density)
        assert np.float32(got).view(np.int32) == np.float32(want).view(
            np.int32), density


@pytest.mark.parametrize("per_tensor", [True, False])
@pytest.mark.parametrize("density", [0.1, 0.37])
def test_compress_ternary_signs_bitwise_equal_reference(per_tensor, density):
    tau = _tau_np(1)
    cfg = dict(density=density, alpha=2.0, per_tensor=per_tensor)
    want = j_flat(j_compress(_jax_tree(tau), JConfig(**cfg)),
                  is_leaf=lambda x: hasattr(x, "signs"))
    got = compress(_t(tau), CompressionConfig(**cfg))
    flat = dict(tree_util.flatten_with_paths(
        got, is_leaf=lambda x: hasattr(x, "signs")))
    assert flat.keys() == want.keys()
    for path, w in want.items():
        g = flat[path]
        np.testing.assert_array_equal(g.signs.numpy(), np.asarray(w.signs),
                                      path)
        assert g.signs.dtype == torch.int8 and g.orig_dtype == (
            torch.bfloat16 if path == "emb" else torch.float32)
        np.testing.assert_allclose(float(g.scale), float(w.scale),
                                   rtol=RTOL_SCALE)
    # the exact planes: the pack kernel (its plain version here) at the
    # exact thresholds equals pack_tree(compress(.)) in both packages
    tex = tapi.compress(_t(tau), method="exact", device="cpu", **cfg)
    jex = rapi.compress(_jax_tree(tau), method="exact", **cfg)
    _assert_planes(tex.packed, jex.packed, RTOL_SCALE)
    mine = dict(tree_util.flatten_with_paths(
        pack_tree(got), is_leaf=lambda x: hasattr(x, "pos")))
    for path, pt in tex.packed.items():
        assert torch.equal(pt.pos, mine[path].pos), path
        assert torch.equal(pt.neg, mine[path].neg), path
        assert torch.equal(pt.scale, mine[path].scale), path
    # in the exact path unpack(PACKED) is TERNARY, bitwise
    tern = tex.as_path_dict(TERNARY)
    for path, ct in Expert.from_packed("u", "full", tex.as_(
            PACKED)).as_path_dict(TERNARY).items():
        assert torch.equal(ct.signs, tern[path].signs), path


def test_exact_pack_runs_the_scalar_pack_kernel_once_per_leaf():
    tex = tapi.compress(_t(_tau_np(2)), density=0.2, method="exact",
                        device="cpu")
    ops.reset_launch_counts()
    calls = []
    real = ops.PLAIN["pack_ternary_planes"]
    ops.PLAIN["pack_ternary_planes"] = lambda *a: calls.append(1) or real(*a)
    try:
        with ops.plain_versions():
            tex.as_(PACKED)
    finally:
        ops.PLAIN["pack_ternary_planes"] = real
    assert len(calls) == 4
    assert ops.launch_counts()["pack_ternary_planes"] == 0   # CPU: plain


def test_every_lattice_transition_matches_reference():
    """Streaming expert: DENSE -> PACKED -> TERNARY -> DENSE and PACKED ->
    GOLOMB -> PACKED, against the reference expert's representations
    (planes bitwise; the scales of two independent compressions within
    1e-6; every form derived from the same planes exactly)."""
    tau = _tau_np(3)
    jex = rapi.compress(_jax_tree(tau), name="x", density=0.2)
    tex = tapi.compress(_t(tau), name="x", density=0.2, device="cpu")
    _assert_planes(tex.packed, jex.packed, 1e-5)
    # from here on both sides hold the same planes and scales
    tex = _cpu_expert(jex)
    tern, jtern = tex.as_path_dict(TERNARY), jex.as_path_dict(rapi.TERNARY)
    for path, w in jtern.items():
        np.testing.assert_array_equal(tern[path].signs.numpy(),
                                      np.asarray(w.signs), path)
        assert float(tern[path].scale) == float(w.scale)
    dense, recon = tex.as_path_dict(DENSE), j_flat(jex.to_dense_tau())
    assert dense.keys() == recon.keys()
    for path, w in recon.items():
        np.testing.assert_array_equal(
            dense[path].to(torch.float32).numpy(),
            np.asarray(w).astype(np.float32), path)
        assert dense[path].dtype == (torch.bfloat16 if path == "emb"
                                     else torch.float32)
    blobs = tex.as_(GOLOMB)
    assert blobs == jex.as_(rapi.GOLOMB)             # byte-identical
    back = Expert("y", density=0.2)
    back._leaf_meta = dict(tex._leaf_meta)
    back._reps[GOLOMB] = blobs
    _assert_planes(back.packed, jex.packed)
    for rep in REPRESENTATIONS:
        assert tex.nbytes(rep) == jex.nbytes(rep), rep
    s, js = tex.summary(), jex.summary()
    for k in ("n_params", "nnz", "density", "dense_bits", "golomb_bits"):
        assert s[k] == js[k], k
    assert s["bytes"] == js["bytes"]


def test_summary_with_dense_tau_matches_reference():
    tau = _tau_np(4)
    s = tapi.compress(_t(tau), density=0.1, method="exact",
                      device="cpu").summary()
    js = rapi.compress(_jax_tree(tau), density=0.1,
                       method="exact").summary()
    for k in ("n_params", "nnz", "density", "dense_bits", "bitplane_bits",
              "golomb_bits"):
        assert s[k] == js[k], k
    for k in ("entropy_bits", "compression_x_entropy", "rel_recon_err"):
        np.testing.assert_allclose(s[k], js[k], rtol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_golomb_bytes_identical_to_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    density = [0.0, 0.02, 0.1, 0.3, 0.6, 1.0][seed]
    signs = np.where(rng.random(n) < density, rng.choice([-1, 1], n),
                     0).astype(np.int8)
    scale = float(rng.uniform(1e-4, 3.0))
    blob = golomb.encode(signs, scale)
    assert blob == jgolomb.encode(signs, scale)
    assert blob == golomb.encode_ref(signs, scale)
    assert golomb.rice_parameter(density) == jgolomb.rice_parameter(density)
    for dec in (golomb.decode, golomb.decode_ref):
        out, s = dec(blob)
        np.testing.assert_array_equal(out, signs)
        assert s == jgolomb.decode(blob)[1]
    tree = golomb.decode_tree({"a": blob, "b": jgolomb.encode(-signs, 2.0)})
    np.testing.assert_array_equal(tree["b"][0], -signs)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_crosses_between_packages(tmp_path, writer):
    jex = rapi.compress(_jax_tree(_tau_np(5)), name="math", kind="lora",
                        density=0.1, alpha=3.0, meta={"task": "gsm8k"})
    path = str(tmp_path / "e.npz")
    if writer == "port":
        stats = _cpu_expert(jex).save(path)
        back = JExpert.load(path)
        _assert_planes(packed_from_jax(back.packed, device="cpu"),
                       jex.packed)
    else:
        stats = jex.save(path)
        back = tapi.load(path, device="cpu")
        _assert_planes(back.packed, jex.packed)
    assert (back.name, back.kind, back.density, back.alpha) == (
        "math", "lora", 0.1, 3.0)
    assert back.meta == {"task": "gsm8k"}
    assert stats == JExpert.load(path).save(str(tmp_path / "again.npz"))


def test_legacy_export_expert_file_loads_in_port(tmp_path):
    from repro.checkpoint.manager import export_expert
    rng = np.random.default_rng(6)
    init = {"w": jnp.asarray(rng.normal(0, 1, (64, 64)), jnp.float32)}
    ft = {"w": init["w"] + jnp.asarray(rng.normal(0, 1e-3, (64, 64)),
                                       jnp.float32)}
    with pytest.deprecated_call():
        export_expert(init, ft, str(tmp_path / "legacy.npz"), density=0.1)
    ex = tapi.load(str(tmp_path / "legacy.npz"), device="cpu")
    _assert_planes(ex.packed, JExpert.load(str(tmp_path /
                                                "legacy.npz")).packed)
    assert ex.density == 0.1 and ex.name == "legacy"


@pytest.mark.parametrize("rep", ["golomb", "packed", "dense"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cpft_crosses_between_packages(tmp_path, rep, writer):
    """A .cpft blob in each payload encoding, written by one package and
    decoded by the other: bit-identical planes and scales, and the very
    same bytes when re-encoded."""
    jex = rapi.compress(_jax_tree(_tau_np(7)), name="w", density=0.2)
    tex = _cpu_expert(jex)
    if writer == "port":
        blob = wire.encode_expert(tex, rep=rep)
        assert blob == jwire.encode_expert(jex, rep=rep)
        back = jwire.decode_expert(blob)
        _assert_planes(packed_from_jax(back.packed, device="cpu"),
                       jex.packed)
    else:
        blob = jwire.encode_expert(jex, rep=rep)
        back = wire.decode_expert(blob, device="cpu")
        _assert_planes(back.packed, jex.packed)
        assert wire.encode_expert(back, rep=rep) == blob
    assert wire.wire_nbytes(tex, rep) == jwire.wire_nbytes(jex, rep)
    if rep == "golomb":
        path = str(tmp_path / "w.cpft")
        stats = tapi.save(tex, path) if writer == "port" else rapi.save(
            jex, path)
        assert stats["compressed_bytes"] == len(blob)
        _assert_planes(tapi.load(path, device="cpu").packed, jex.packed)
        _assert_planes(packed_from_jax(rapi.load(path).packed,
                                       device="cpu"), jex.packed)


def test_wire_rejects_corruption():
    jex = rapi.compress(_jax_tree(_tau_np(8)), name="c", density=0.2)
    blob = wire.encode_expert(_cpu_expert(jex))
    head = wire.payload_offset(blob)
    flipped = bytearray(blob)
    flipped[head + 40] ^= 0x10
    with pytest.raises(wire.ChecksumError, match="CRC"):
        wire.decode_expert(bytes(flipped), device="cpu")
    with pytest.raises(wire.ChecksumError, match="truncated"):
        wire.decode_expert(blob[:-3], device="cpu")
    with pytest.raises(wire.WireFormatError, match="magic"):
        wire.decode_expert(b"XPFT" + blob[4:], device="cpu")
    newer = bytearray(blob)
    newer[4] = wire.VERSION + 1
    with pytest.raises(wire.WireFormatError, match="newer"):
        wire.peek_manifest(bytes(newer))
    with pytest.raises(wire.WireFormatError):
        wire.encode_expert(_cpu_expert(jex), rep=TERNARY)
    # per-leaf verification of a partial payload
    manifest = wire.peek_manifest(blob)
    assert manifest == jwire.peek_manifest(blob)
    assert wire.supports_resume(manifest)
    leaf = wire.decode_leaves(manifest)[1]
    raw = blob[head + leaf["offset"]:head + leaf["offset"] + leaf["nbytes"]]
    wire.verify_leaf(leaf, raw)
    bad = bytearray(raw)
    bad[0] ^= 1
    with pytest.raises(wire.ChecksumError, match="CRC"):
        wire.verify_leaf(leaf, bytes(bad))
    with pytest.raises(wire.ChecksumError, match="truncated"):
        wire.verify_leaf(leaf, raw[:-1])
    span = (leaf["offset"], leaf["offset"] + 1)
    assert wire.decode_leaves(manifest, span) == jwire.decode_leaves(
        manifest, span) == [leaf]
    assert wire.is_wire_blob(blob) and not wire.is_wire_blob(b"PK\x03\x04")


def test_lattice_round_trip_and_errors():
    tex = tapi.compress(_t(_tau_np(9)), density=0.3, device="cpu")
    t0 = tex.as_path_dict(TERNARY)
    again = Expert.from_packed("p", "full", pack_tree(unpack_tree(
        tex.as_(PACKED))))
    for path, ct in again.as_path_dict(TERNARY).items():
        assert torch.equal(ct.signs, t0[path].signs)
    with pytest.raises(ValueError, match="representation"):
        tex.as_("sparse")
    with pytest.raises(ValueError, match="density"):
        tapi.compress(_t(_tau_np(9)), density=0.0, device="cpu").as_(PACKED)
    with pytest.raises(ValueError, match="method"):
        tapi.compress(_t(_tau_np(9)), method="sorted", device="cpu")


# ---------------------------------------------------------------------------
# The cold-Golomb tier serving
# ---------------------------------------------------------------------------


def test_cold_golomb_registry_serves_reference_tokens():
    """A registry that keeps only Golomb streams decodes each expert on
    promotion and serves the reference engine's greedy tokens (smoke
    qwen2.5-3b, mixed FIFO waves)."""
    from repro.configs import get_smoke_config
    from repro.models import Runtime, build
    from repro.serve import Request as JRequest
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.models import build as t_build
    from repro_torch.serve import BASE, Request

    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    japi = build(cfg)
    base = japi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jexs = [rapi.compress(jax.tree_util.tree_map(
        lambda l: jnp.asarray(0.03 * rng.normal(size=l.shape), jnp.float32),
        base), name=f"e{i}", density=0.2) for i in range(2)]
    jreg = rapi.registry(cold_golomb=True, experts=jexs)
    treg = tapi.registry(cold_golomb=True, device="cpu",
                         experts=[_cpu_expert(e) for e in jexs])
    assert treg.store.names() == ["e0", "e1"]
    assert treg.store.nbytes("e0") == jreg.store.nbytes("e0")
    prompts = [np.random.default_rng(1).integers(1, cfg.vocab, L)
               for L in (5, 9, 7, 6)]
    names = ["e0", "e1", BASE, "e1"]
    jr = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=4) for i, (n, p) in enumerate(zip(names,
                                                                   prompts))]
    rapi.serve(japi, Runtime(attn_chunk_q=16, attn_chunk_k=16,
                             remat_policy="none"), base, jreg, max_batch=4,
               cache_len=32, continuous=False, decode_chunk=3).run(jr)
    tr = [Request(uid=i, expert=n, prompt=p, max_new_tokens=4)
          for i, (n, p) in enumerate(zip(names, prompts))]
    model = t_build(t_smoke("qwen2_5_3b", n_units=1))
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    eng = tapi.serve(model, tbase, treg, max_batch=4, cache_len=32,
                     decode_chunk=3)
    eng.run(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    stats = treg.device().stats
    assert stats.promotions == 2 and stats.golomb_decode_seconds > 0
    assert stats.store_to_host_bytes == sum(treg.store.nbytes(n)
                                            for n in ("e0", "e1"))
