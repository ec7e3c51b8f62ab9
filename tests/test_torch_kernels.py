"""The port's kernels on the CPU: each plain version held against the JAX
package's oracle and its Pallas kernel in interpret mode, on the same
numpy inputs.  (The CUDA kernels themselves are held against these plain
versions on the card: tests/test_torch_cuda.py and chip_smoke.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_bits as j_pack_bits
from repro.kernels import ref as jref
from repro.kernels.histogram_quantile import (_segment_absmax as j_absmax,
                                              _segment_hist_moments_jnp,
                                              segment_hist_moments_pallas,
                                              segmented_quantile_moments as
                                              j_sqm)
from repro.kernels.pack import (pack_ternary_planes_segmented as j_pack_seg,
                                pack_ternary_planes_segmented_ref as
                                j_pack_seg_ref)
from repro.kernels import ops as jops
from repro.kernels.pack import pack_ternary_planes as j_pack
from repro.kernels.popcount_dot import popcount_dot as j_popcount_dot
from repro.kernels.ternary_matmul import ternary_matmul as j_matmul
from repro.kernels.ternary_matmul import ternary_matmul_grouped as j_grouped
from hist_cases import edge_case
from repro_torch.core.compeft import _build_segment_buffer
from repro_torch.core.packing import pack_bits, stack_packed, unpack_bits
from repro_torch.kernels import histogram_quantile as hq
from repro_torch.kernels import ops
from repro_torch.kernels.pack import (pack_ternary_planes,
                                      pack_ternary_planes_plain,
                                      pack_ternary_planes_segmented,
                                      pack_ternary_planes_segmented_plain)
from repro_torch.kernels.popcount_dot import popcount_dot, popcount_dot_plain
from repro_torch.kernels.ternary_matmul import (H100_SMS, launch_cols,
                                                ternary_matmul,
                                                ternary_matmul_grouped,
                                                ternary_matmul_grouped_plain,
                                                ternary_matmul_plain)

LANE = 32


def _planes(rng, shape, k_valid=None):
    """Disjoint random uint32 planes (numpy); bits past k_valid cleared."""
    pos = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    neg = rng.integers(0, 2 ** 32, shape, dtype=np.uint32) & ~pos
    if k_valid is not None and k_valid % LANE:
        mask = np.uint32((1 << (k_valid % LANE)) - 1)
        pos[..., -1] &= mask
        neg[..., -1] &= mask
    return pos, neg


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


GROUPED_CASES = [  # M, K, N, E, transpose_rhs
    (8, 32, 32, 1, False), (13, 96, 64, 3, False), (33, 64, 128, 4, False),
    (7, 48, 64, 3, True), (16, 64, 96, 2, True)]


@pytest.mark.parametrize("M,K,N,E,tr", GROUPED_CASES)
def test_grouped_plain_matches_jax(M, K, N, E, tr):
    """Plain grouped matmul vs the JAX oracle and the Pallas kernel in
    interpret mode, -1 rows included.  Tolerance: f32, both sum K terms
    (different orders): rtol = atol = 1e-5."""
    rng = np.random.default_rng(M * 7 + K)
    shape = (E, N, -(-K // LANE)) if tr else (E, K, N // LANE)
    pos, neg = _planes(rng, shape, K if tr else None)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    scales = rng.normal(0, 0.5, E).astype(np.float32)
    eid = rng.integers(-1, E, M).astype(np.int32)
    eid[0] = -1
    got = ternary_matmul_grouped_plain(_t(x), _t(pos), _t(neg), _t(scales),
                                       _t(eid), transpose_rhs=tr).numpy()
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(neg),
            jnp.asarray(scales), jnp.asarray(eid))
    want = np.asarray(jref.ternary_matmul_grouped_ref(*args,
                                                      transpose_rhs=tr))
    pallas = np.asarray(j_grouped(*args, transpose_rhs=tr, bm=8, bk=32,
                                  bn=32, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    assert np.all(got[eid < 0] == 0.0)


@pytest.mark.parametrize("tr", [False, True])
def test_grouped_wrapper_on_cpu_is_plain_and_rows_independent(tr):
    """On CPU tensors the wrapper is the plain version, launches nothing,
    and a mixed batch is row-wise what each row gives alone, within
    rtol = atol = 1e-5 (the CPU matmul may block rows differently by M;
    the bitwise row independence is the CUDA kernel's, checked on the
    card)."""
    rng = np.random.default_rng(5)
    M, K, N, E = 12, 64, 96, 3
    shape = (E, N, K // LANE) if tr else (E, K, N // LANE)
    pos, neg = map(_t, _planes(rng, shape))
    x = _t(rng.normal(0, 1, (M, K)).astype(np.float32))
    scales = _t(np.asarray([0.3, -0.7, 1.1], np.float32))
    eid = _t(rng.integers(-1, E, M).astype(np.int32))
    ops.reset_launch_counts()
    mixed = ternary_matmul_grouped(x, pos, neg, scales, eid,
                                   transpose_rhs=tr)
    assert ops.launch_counts()["ternary_matmul_grouped"] == 0
    plain = ternary_matmul_grouped_plain(x, pos, neg, scales, eid,
                                         transpose_rhs=tr)
    assert torch.equal(mixed, plain)
    for m in range(M):
        alone = ternary_matmul_grouped(x[m:m + 1], pos, neg, scales,
                                       eid[m:m + 1], transpose_rhs=tr)
        torch.testing.assert_close(alone[0], mixed[m], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,C", [(5, 64), (17, 512), (3, 8192)])
def test_pack_plain_bitwise_equals_jax(R, C):
    rng = np.random.default_rng(R + C)
    tau = rng.normal(0, 1, (R, C)).astype(np.float32)
    tau[:, ::7] = 0.0
    thr = np.abs(rng.normal(0, 1, R)).astype(np.float32)
    got = pack_ternary_planes_segmented(_t(tau), _t(thr))
    want_ref = j_pack_seg_ref(jnp.asarray(tau), jnp.asarray(thr))
    want_pl = j_pack_seg(jnp.asarray(tau), jnp.asarray(thr), bm=8, bn=64,
                         interpret=True)
    for g, w, p in zip(got, want_ref, want_pl):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).view(np.int32))
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(p).view(np.int32))
    plain = pack_ternary_planes_segmented_plain(_t(tau), _t(thr))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_pack_bits_roundtrip_matches_jax():
    rng = np.random.default_rng(9)
    mask = rng.random(1000) < 0.3
    words = pack_bits(torch.from_numpy(mask))
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(j_pack_bits(jnp.asarray(mask))).view(
            np.int32))
    assert torch.equal(unpack_bits(words, 1000),
                       torch.from_numpy(mask.astype(np.int32)))


def test_stack_packed_zero_slot():
    from repro_torch.core.packing import PackedTernary
    pt = PackedTernary(pos=torch.tensor([5], dtype=torch.int32),
                       neg=torch.tensor([2], dtype=torch.int32),
                       scale=torch.tensor(0.5), shape=(32,))
    st = stack_packed([{}, {"w": pt}])["w"]
    assert st[0].tolist() == [[0], [5]] and st[1].tolist() == [[0], [2]]
    assert st[2].tolist() == [0.0, 0.5] and st[3] == (32,)


def _segbuf(rng, sizes, cols):
    arrays = [rng.standard_t(3, n).astype(np.float32) for n in sizes]
    arrays[0][:50] = 0.0
    leaves = [torch.from_numpy(a) for a in arrays]
    return arrays, _build_segment_buffer(leaves, cols, "cpu")


@pytest.mark.parametrize("sizes,cols", [((4321, 777), 512),
                                        ((20000, 9000, 31), 2048)])
def test_hist_plain_matches_jnp_2048_bins(sizes, cols):
    """Counts bitwise equal to the reference's jnp sweep at 2048 bins, in
    both the coarse and a refine-like window; moments within rtol 1e-5,
    atol 1e-3 (f32 sums in different orders), as the reference's own
    Pallas-vs-jnp test states."""
    rng = np.random.default_rng(len(sizes))
    arrays, (buf, seg, valid, _, _) = _segbuf(rng, sizes, cols)
    S = len(sizes)
    jargs = [jnp.asarray(t.numpy()) for t in (buf, seg, valid)]
    width = np.asarray([np.abs(a).max() for a in arrays], np.float32)
    for lo, w in ((np.zeros(S, np.float32), width),
                  (width * 0.01, width * 0.05)):
        got = hq.segment_hist_moments(buf, seg, valid, _t(lo), _t(w),
                                      n_seg=S)
        want = _segment_hist_moments_jnp(*jargs, jnp.asarray(lo),
                                         jnp.asarray(w), n_seg=S,
                                         nbins=hq.NBINS)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, wv in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv),
                                       rtol=1e-5, atol=1e-3)


def test_hist_plain_matches_pallas_256_bins():
    rng = np.random.default_rng(3)
    arrays, (buf, seg, valid, _, _) = _segbuf(rng, (4100, 1500), 256)
    assert buf.shape[0] % 8 != 0       # the Pallas kernel pads rows
    S = 2
    lo = np.zeros(S, np.float32)
    width = np.asarray([np.abs(a).max() for a in arrays], np.float32)
    got = hq.segment_hist_moments_plain(buf, seg, valid, _t(lo), _t(width),
                                        n_seg=S, nbins=256)
    want = segment_hist_moments_pallas(
        *[jnp.asarray(t.numpy()) for t in (buf, seg, valid)],
        jnp.asarray(lo), jnp.asarray(width), n_seg=S, nbins=256,
        interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("density", [0.05, 0.1, 0.5])
def test_threshold_matches_jax_jnp_backend(density):
    """The whole two-pass selection: thresholds bitwise equal to the
    reference's jnp backend (same binning), scales within rtol 1e-5."""
    rng = np.random.default_rng(11)
    _, (buf, seg, valid, count, _) = _segbuf(rng, (6000, 3333), 512)
    got = hq.segmented_quantile_moments(buf, seg, valid, count, density,
                                        n_seg=2)
    want = j_sqm(*[jnp.asarray(t.numpy()) for t in (buf, seg, valid, count)],
                 density, n_seg=2, backend="jnp")
    np.testing.assert_array_equal(got["threshold"].numpy(),
                                  np.asarray(want["threshold"]))
    np.testing.assert_array_equal(got["keep"].numpy(),
                                  np.asarray(want["keep"]))
    for k in ("std", "mean_abs", "max"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("nbins", [256, 2048, 8192])
@pytest.mark.parametrize("layout", ["segments", "single"])
def test_hist_plain_edge_cases_match_jnp(nbins, layout):
    """Skewed and edge inputs (an all-zero segment, a window of width 0,
    magnitudes at lo, at lo + w, one ulp past them and at bin edges,
    90% equal magnitudes, ragged and empty rows, padding that is not
    zero; one segment over all rows): counts bitwise the reference's jnp
    sweep, moments within rtol 1e-5, atol 1e-3 (f32 sums in other
    orders)."""
    buf, seg, valid, lo, width, S = edge_case(nbins, nbins, layout=layout)
    got = hq.segment_hist_moments_plain(
        *[torch.from_numpy(a) for a in (buf, seg, valid, lo, width)],
        n_seg=S, nbins=nbins)
    want = _segment_hist_moments_jnp(
        *[jnp.asarray(a) for a in (buf, seg, valid, lo, width)], n_seg=S,
        nbins=nbins)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[0].sum()) > 0
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("layout", ["segments", "single", "interleaved"])
def test_segment_absmax_plain_bitwise_equals_jax(layout):
    """The pre-pass bitwise the reference's, padding (7.0) skipped; the
    CPU wrapper is the plain version and counts no launch."""
    buf, seg, valid, _, _, S = edge_case(5, 2048, layout=layout)
    args = [torch.from_numpy(a) for a in (buf, seg, valid)]
    ops.reset_launch_counts()
    got = hq.segment_absmax(*args, n_seg=S)
    assert ops.launch_counts()["segment_absmax"] == 0
    assert torch.equal(got, hq._segment_absmax(*args, n_seg=S))
    want = j_absmax(*[jnp.asarray(a) for a in (buf, seg, valid)], n_seg=S)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    if layout != "single":        # the all-zero segment's padding is 7.0
        assert float(got[0]) == 0.0


@pytest.mark.parametrize("per_tensor", [True, False])
def test_threshold_skewed_leaves_match_jax_jnp_backend(per_tensor):
    """The two-pass selection over a frozen (all-zero) leaf, a leaf of 90%
    equal magnitudes and a Gaussian one, per leaf or as one segment:
    thresholds and keep bitwise the reference's jnp backend, scales within
    rtol 1e-5."""
    rng = np.random.default_rng(21)
    eq = np.where(rng.random(5000) < 0.9,
                  np.where(rng.random(5000) < 0.5, -0.01, 0.01),
                  0.01 * rng.standard_normal(5000)).astype(np.float32)
    arrays = [np.zeros(3000, np.float32), eq,
              rng.standard_normal(2500).astype(np.float32)]
    buf, seg, valid, count, _ = _build_segment_buffer(
        [torch.from_numpy(a) for a in arrays], 512, "cpu")
    S = len(arrays)
    if not per_tensor:
        seg = torch.zeros_like(seg)
        count = count.sum(dtype=torch.int32, dim=0, keepdim=True)
        S = 1
    got = hq.segmented_quantile_moments(buf, seg, valid, count, 0.1,
                                        n_seg=S)
    want = j_sqm(*[jnp.asarray(t.numpy()) for t in (buf, seg, valid, count)],
                 0.1, n_seg=S, backend="jnp")
    for k in ("threshold", "keep"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("std", "mean_abs", "max"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Single-expert matmul, scalar pack, popcount dot (kernels 6-8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(1, 32, 32), (4, 100, 64), (9, 64, 160)])
def test_ternary_matmul_plain_matches_jax(M, K, N):
    """Plain single-expert matmul vs the JAX oracle and the Pallas kernel
    in interpret mode.  Tolerance: f32, both sum K terms (different
    orders): rtol = atol = 1e-5."""
    rng = np.random.default_rng(M + K + N)
    pos, neg = _planes(rng, (K, N // LANE))
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    scale = np.float32(-0.37)
    got = ternary_matmul(_t(x), _t(pos), _t(neg), torch.tensor(scale))
    assert torch.equal(got, ternary_matmul_plain(_t(x), _t(pos), _t(neg),
                                                 torch.tensor(scale)))
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(neg),
            jnp.asarray(scale))
    want = np.asarray(jref.ternary_matmul_ref(*args))
    pallas = np.asarray(j_matmul(*args, bm=8, bn=32, bk=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)


def test_grouped_rows_match_single_expert_plain():
    """The grouped contract on the CPU: each row of a grouped product
    equals the single-expert product of that row on its expert, within
    rtol = atol = 1e-5 (the plain versions use the CPU matmul; bitwise
    equality between the two CUDA kernels is checked on the card)."""
    rng = np.random.default_rng(4)
    M, K, N, E = 6, 96, 64, 3
    pos, neg = map(_t, _planes(rng, (E, K, N // LANE)))
    x = _t(rng.normal(0, 1, (M, K)).astype(np.float32))
    scales = _t(np.asarray([0.5, -1.25, 0.75], np.float32))
    eid = _t(np.asarray([2, 0, 1, 1, 0, 2], np.int32))
    grouped = ternary_matmul_grouped(x, pos, neg, scales, eid)
    for m in range(M):
        e = int(eid[m])
        single = ternary_matmul(x[m:m + 1], pos[e], neg[e], scales[e])
        torch.testing.assert_close(single[0], grouped[m], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("M,N", [(1, 1), (3, 31), (5, 64), (2, 100),
                                 (1, 4133), (7, 513)])
def test_pack_scalar_plain_bitwise_equals_jax(M, N):
    """Any N (a ragged last word per row), -0.0 and 0.0, and elements equal
    to the threshold: bitwise the JAX oracle's and the Pallas kernel's
    planes, and pack_ternary(compress_leaf(.)) of the reference."""
    from repro.core.compeft import CompressionConfig as JConfig
    from repro.core.compeft import compress_leaf as j_compress_leaf
    from repro.core.packing import pack_ternary as j_pack_ternary
    rng = np.random.default_rng(M * N)
    tau = rng.normal(0, 1, (M, N)).astype(np.float32)
    tau.reshape(-1)[::5] = -0.0
    tau.reshape(-1)[1::7] = 0.0
    thr = np.float32(np.quantile(np.abs(tau), 0.7))
    tau.reshape(-1)[2::11] = -thr
    tau.reshape(-1)[3::13] = thr
    got = pack_ternary_planes(_t(tau), torch.tensor(thr))
    plain = pack_ternary_planes_plain(_t(tau), torch.tensor(thr))
    want = jref.pack_ternary_planes_ref(jnp.asarray(tau), jnp.asarray(thr))
    pallas = j_pack(jnp.asarray(tau), jnp.asarray(thr), bm=8, bn=64,
                    interpret=True)
    for g, p, w, pl in zip(got, plain, want, pallas):
        assert g.shape == (M, -(-N // LANE))
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32))
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(pl).view(np.int32))
    # a leaf's flat packing is its [1, n] view
    flat = pack_ternary_planes(_t(tau).reshape(1, -1), torch.tensor(thr))
    ct = j_compress_leaf(jnp.asarray(tau), JConfig(density=0.3),
                         threshold=jnp.asarray(thr))
    pt = j_pack_ternary(ct)
    np.testing.assert_array_equal(flat[0].numpy()[0],
                                  np.asarray(pt.pos).view(np.int32))
    np.testing.assert_array_equal(flat[1].numpy()[0],
                                  np.asarray(pt.neg).view(np.int32))


@pytest.mark.parametrize("W", [1, 5, 2048, 3000])
def test_popcount_dot_plain_bitwise_equals_jax(W):
    """Integer dots: bitwise the Pallas kernel's (interpret mode, blocks
    of 512 words, a padded last block) and the JAX oracle's."""
    rng = np.random.default_rng(W)
    ap, an = _planes(rng, (W,))
    bp, bn = _planes(rng, (W,))
    got = popcount_dot(*map(_t, (ap, an, bp, bn)))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert torch.equal(got, popcount_dot_plain(*map(_t, (ap, an, bp, bn))))
    jargs = [jnp.asarray(a) for a in (ap, an, bp, bn)]
    assert int(got) == int(j_popcount_dot(*jargs, bw=512, interpret=True))
    assert int(got) == int(jref.popcount_dot_ref(*jargs))
    self_dot = popcount_dot(*map(_t, (ap, an, ap, an)))
    assert int(self_dot) == int(np.unpackbits(ap.view(np.uint8)).sum()
                                + np.unpackbits(an.view(np.uint8)).sum())


def test_single_expert_entry_points_match_jax_ops():
    """ops.ternary_matvec / compress_to_planes / expert_dot against the
    reference's ops (its jnp mirrors off the TPU), on the CPU: the planes
    and the integer dot bitwise, the f32 products within 1e-5."""
    from repro.core.packing import PackedTernary as JPacked
    from repro_torch.convert import packed_from_jax
    rng = np.random.default_rng(12)
    K, N = 40, 96
    pos, neg = _planes(rng, (K * N // LANE,))
    jpt = JPacked(pos=jnp.asarray(pos), neg=jnp.asarray(neg),
                  scale=jnp.float32(0.3), shape=(K, N),
                  orig_dtype=jnp.float32)
    tpt = packed_from_jax(jpt, device="cpu")
    for x in (rng.normal(0, 1, (K,)), rng.normal(0, 1, (3, K))):
        x = x.astype(np.float32)
        np.testing.assert_allclose(
            ops.ternary_matvec(torch.from_numpy(x), tpt).numpy(),
            np.asarray(jops.ternary_matvec(jnp.asarray(x), jpt)), rtol=1e-5,
            atol=1e-5)
    tau = rng.normal(0, 1, (7, 45)).astype(np.float32)
    for g, w in zip(ops.compress_to_planes(torch.from_numpy(tau), 0.5),
                    jops.compress_to_planes(jnp.asarray(tau),
                                            jnp.float32(0.5))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32))
    np.testing.assert_allclose(float(ops.expert_dot(tpt, tpt)),
                               float(jops.expert_dot(jpt, jpt)), rtol=1e-6)
    with pytest.raises(ValueError, match="N % 32"):
        ops.ternary_matvec(torch.zeros(3), _zero_packed(3, 40))


def _zero_packed(K, N):
    from repro_torch.core.packing import PackedTernary
    w = torch.zeros(-(-K * N // LANE), dtype=torch.int32)
    return PackedTernary(pos=w, neg=w, scale=torch.tensor(1.0), shape=(K, N))


def test_matmul_geometry_takes_no_m():
    """The launch geometry that kernels 1 and 6 take from Python (the
    plane-word columns per block) is a pure function of N and the form:
    no M, so it cannot follow the batch, and it never moves the K
    partition, which the CUDA source fixes by K alone.  The normal form
    gives a launch one block per SM where the width allows it."""
    import inspect
    assert list(inspect.signature(launch_cols).parameters) == [
        "N", "transpose_rhs"]
    widths = [2048, 256, 11008, 151936, 33, 262 * 32, 263 * 32]
    for N in widths:
        assert launch_cols(N, True) == 1
        cols = launch_cols(N, False)
        assert cols == launch_cols(N, False) and cols in (1, 2)
        W = -(-N // LANE)
        if W >= H100_SMS:
            assert -(-W // cols) >= H100_SMS
    assert [launch_cols(N, False) for N in widths] == [1, 1, 2, 2, 1, 1, 2]
