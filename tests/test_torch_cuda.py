"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where torch finds no CUDA device.  On a machine
with a card and nvcc: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py`` (the kernels are built at first use).
"""

import pytest
import torch

from hist_cases import edge_case
from repro_torch.kernels import histogram_quantile as hq
from repro_torch.kernels import ops
from repro_torch.kernels.pack import (pack_ternary_planes,
                                      pack_ternary_planes_plain,
                                      pack_ternary_planes_segmented,
                                      pack_ternary_planes_segmented_plain)
from repro_torch.kernels.popcount_dot import popcount_dot, popcount_dot_plain
from repro_torch.kernels.sample import (sample_gumbel_argmax,
                                        sample_gumbel_argmax_plain,
                                        sample_tokens, sample_tokens_plain)
from repro_torch.kernels.ternary_matmul import (ternary_matmul,
                                                ternary_matmul_grouped,
                                                ternary_matmul_grouped_plain,
                                                ternary_matmul_plain)
from repro_torch.kernels.unpack_add import (unpack_add, unpack_add_many,
                                            unpack_add_many_plain,
                                            unpack_add_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _planes(shape, gen, dev):
    def rnd():
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             generator=gen, device=dev)
    pos = rnd() & rnd()
    return pos, rnd() & rnd() & ~pos


def _grouped_inputs(dev, M, K, N, tr, E, seed):
    """Planes [E, K, ceil(N/32)] ([E, N, ceil(K/32)] transposed, the bits
    past K of the last word cleared), x [M, K] and scales with a zero
    slot (the last)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (E, N, -(-K // 32)) if tr else (E, K, -(-N // 32))
    pos, neg = _planes(shape, gen, dev)
    if tr and K % 32:
        mask = (1 << (K % 32)) - 1
        pos[..., -1] &= mask
        neg[..., -1] &= mask
    x = torch.randn((M, K), generator=gen, device=dev)
    scales = torch.tensor(([0.5, -0.25, 0.013][:E - 1] + [0.0]) if E > 1
                          else [0.5], device=dev)
    return gen, x, pos, neg, scales


def _check_grouped(x, pos, neg, scales, eid, tr):
    """f32 tolerance: |kernel - plain| <= 1e-4 * max |plain| (both f32,
    summed in other orders); -1 rows exactly 0; each row bitwise equals
    itself launched alone."""
    before = ternary_matmul_grouped.launches
    got = ternary_matmul_grouped(x, pos, neg, scales, eid, transpose_rhs=tr)
    assert ternary_matmul_grouped.launches == before + 1
    want = ternary_matmul_grouped_plain(x, pos, neg, scales, eid,
                                        transpose_rhs=tr)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max()) + 1e-30
    assert bool((got[eid < 0] == 0).all())
    for m in range(x.shape[0]):
        alone = ternary_matmul_grouped(x[m:m + 1], pos, neg, scales,
                                       eid[m:m + 1], transpose_rhs=tr)
        assert torch.equal(alone[0], got[m])


@pytest.mark.parametrize("M,K,N,tr", [
    (1, 64, 96, False), (9, 300, 64, False), (33, 2048, 256, False),
    (5, 48, 70, True), (17, 2048, 300, True),
    # K below, at and just above one 32-k subtile and one round of the
    # 16 phases (512 k), and K not a multiple of either
    (6, 31, 64, False), (6, 32, 64, False), (6, 33, 64, False),
    (5, 511, 128, False), (5, 513, 128, False), (5, 2047, 128, False),
    (5, 2049, 128, False), (4, 4133, 96, False),
    # plane-word columns: 2 per block with a ragged last pair (scalar
    # loads), and with aligned vector loads
    (4, 100, 265 * 32, False), (4, 100, 528 * 32, False),
    # transposed: K % 32 != 0 (ragged last word), N % 32 != 0
    (6, 31, 33, True), (6, 33, 65, True), (3, 1000, 1001, True)])
def test_grouped_kernel_matches_plain_and_rows_are_independent(dev, M, K, N,
                                                               tr):
    gen, x, pos, neg, scales = _grouped_inputs(dev, M, K, N, tr, 3, M + K)
    eid = torch.randint(-1, 3, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    _check_grouped(x, pos, neg, scales, eid, tr)


@pytest.mark.parametrize("case", ["all_minus_one", "one_expert",
                                  "zero_scale_slot", "m300_four_experts"])
@pytest.mark.parametrize("tr", [False, True])
def test_grouped_kernel_special_batches(dev, case, tr):
    """An all -1 batch (every row exactly 0), E = 1, a row on a slot whose
    scale is 0 (like BASE), and M = 300 rows over 4 distinct experts
    (tiles of 8 rows holding several groups, and a ragged last tile)."""
    M, K, N = (300, 2048, 512) if case == "m300_four_experts" else (
        12, 2048, 2048)
    E = {"one_expert": 1, "m300_four_experts": 4}.get(case, 3)
    gen, x, pos, neg, scales = _grouped_inputs(dev, M, K, N, tr, E, 11)
    if case == "all_minus_one":
        eid = torch.full((M,), -1, dtype=torch.int32, device=dev)
    elif case == "zero_scale_slot":
        eid = torch.tensor([2, 0, 2, 1, -1, 2] * 2, dtype=torch.int32,
                           device=dev)
    else:
        eid = torch.randint(-1, E, (M,), generator=gen, device=dev,
                            dtype=torch.int32)
        eid[:E] = torch.arange(E, dtype=torch.int32, device=dev)
    _check_grouped(x, pos, neg, scales, eid, tr)
    if case == "zero_scale_slot":
        got = ternary_matmul_grouped(x, pos, neg, scales, eid,
                                     transpose_rhs=tr)
        assert bool((got[eid == 2] == 0).all())


def test_grouped_kernel_rejects_bad_inputs(dev):
    x = torch.randn((2, 64), device=dev)
    pos = torch.zeros((1, 64, 2), dtype=torch.int32, device=dev)
    s = torch.ones(1, device=dev)
    eid = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ternary_matmul_grouped(x.to(torch.bfloat16), pos, pos, s, eid)
    with pytest.raises(ValueError):
        ternary_matmul_grouped(x[:, :32], pos, pos, s, eid)


@pytest.mark.parametrize("R,C", [(3, 32), (37, 1024), (100, 8192)])
def test_pack_kernel_bitwise_equals_plain(dev, R, C):
    gen = torch.Generator(device=dev).manual_seed(R)
    tau = torch.randn((R, C), generator=gen, device=dev)
    tau[:, ::5] = 0.0
    thr = torch.rand((R,), generator=gen, device=dev)
    got = pack_ternary_planes_segmented(tau, thr)
    want = pack_ternary_planes_segmented_plain(tau, thr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nbins", [256, 2048])
def test_hist_kernel_counts_bitwise_and_deterministic(dev, nbins):
    gen = torch.Generator(device=dev).manual_seed(nbins)
    R, C, S = 45, 512, 3
    buf = torch.randn((R, C), generator=gen, device=dev) * 3
    seg = torch.repeat_interleave(torch.arange(S, device=dev),
                                  torch.tensor([20, 1, 24], device=dev)
                                  ).to(torch.int32)
    valid = torch.full((R,), C, dtype=torch.int32, device=dev)
    valid[19], valid[20], valid[44] = 100, 7, 0
    lo = torch.tensor([0.0, 0.5, 1.0], device=dev)
    width = torch.tensor([10.0, 2.0, 0.25], device=dev)
    got = hq.segment_hist_moments(buf, seg, valid, lo, width, n_seg=S,
                                  nbins=nbins)
    again = hq.segment_hist_moments(buf, seg, valid, lo, width, n_seg=S,
                                    nbins=nbins)
    want = hq.segment_hist_moments_plain(buf, seg, valid, lo, width,
                                         n_seg=S, nbins=nbins)
    assert torch.equal(got[0], want[0])
    for g, a, w in zip(got[1:], again[1:], want[1:]):
        assert torch.equal(g, a)                     # no float atomics
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)


def _edge_on(dev, nbins, layout, form="vec4"):
    """hist_cases.edge_case on the card at cols 8192 (several row blocks
    per segment); form "cols_97" (C % 4 != 0) and "offset" (a buffer 4
    bytes past a 16-byte boundary) take the kernels' 4-byte loads."""
    buf, seg, valid, lo, width, S = edge_case(
        nbins, nbins, layout=layout, cols=97 if form == "cols_97" else 8192,
        big=True)
    b = torch.from_numpy(buf).to(dev)
    if form == "offset":
        store = torch.empty(b.numel() + 1, device=dev)
        b = store[1:].view(b.shape)
        b.copy_(torch.from_numpy(buf))
        assert b.data_ptr() % 16 == 4
    return (b, *[torch.from_numpy(a).to(dev) for a in (seg, valid, lo,
                                                        width)], S)


@pytest.mark.parametrize("nbins", [256, 2048, 8192])
@pytest.mark.parametrize("layout", ["segments", "single", "interleaved"])
def test_hist_kernel_edge_cases_bitwise_and_deterministic(dev, nbins,
                                                          layout):
    """An all-zero segment, a window of width 0, magnitudes at lo, lo + w,
    one ulp past them and at bin edges, 90% equal magnitudes, ragged and
    empty rows, padding of 7.0, segments over several row blocks, one
    segment over all rows, and segments whose rows interleave: counts
    bitwise the plain version's in both sweeps, moments bitwise equal
    across two launches and within rtol 1e-5, atol 1e-3 of the plain
    version (f32 sums in other orders)."""
    buf, seg, valid, lo, width, S = _edge_on(dev, nbins, layout)
    for with_moments in (True, False):
        kw = dict(n_seg=S, nbins=nbins, with_moments=with_moments)
        before = hq.segment_hist_moments.launches
        got = hq.segment_hist_moments(buf, seg, valid, lo, width, **kw)
        again = hq.segment_hist_moments(buf, seg, valid, lo, width, **kw)
        assert hq.segment_hist_moments.launches == before + 2
        want = hq.segment_hist_moments_plain(buf, seg, valid, lo, width,
                                             **kw)
        assert torch.equal(got[0], want[0])
        assert torch.equal(again[0], want[0])
        for g, a, w in zip(got[1:], again[1:], want[1:]):
            assert torch.equal(g, a)                 # no float atomics
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("form", ["cols_97", "offset"])
def test_hist_kernel_scalar_loads_bitwise(dev, form):
    buf, seg, valid, lo, width, S = _edge_on(dev, 2048, "segments", form)
    got = hq.segment_hist_moments(buf, seg, valid, lo, width, n_seg=S)
    want = hq.segment_hist_moments_plain(buf, seg, valid, lo, width,
                                         n_seg=S)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("layout,form", [
    ("segments", "vec4"), ("single", "vec4"), ("interleaved", "vec4"),
    ("segments", "cols_97"), ("segments", "offset")])
def test_segment_absmax_kernel_bitwise_equals_plain(dev, layout, form):
    buf, seg, valid, _, _, S = _edge_on(dev, 2048, layout, form)
    before = hq.segment_absmax.launches
    got = hq.segment_absmax(buf, seg, valid, n_seg=S)
    assert hq.segment_absmax.launches == before + 1
    want = hq._segment_absmax(buf, seg, valid, n_seg=S)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_hist_kernels_reject_bad_inputs(dev):
    """A CUDA tensor the kernels cannot take raises; nothing falls back
    to the plain versions."""
    buf, seg, valid, lo, width, S = _edge_on(dev, 256, "segments")
    before = (hq.segment_hist_moments.launches, hq.segment_absmax.launches)
    for bad in (dict(nbins=0), dict(nbins=hq.MAX_NBINS + 1)):
        with pytest.raises(ValueError):
            hq.segment_hist_moments(buf, seg, valid, lo, width, n_seg=S,
                                    **bad)
    with pytest.raises(ValueError):
        hq.segment_hist_moments(buf.double(), seg, valid, lo, width,
                                n_seg=S)
    with pytest.raises(ValueError):
        hq.segment_absmax(buf, seg.long(), valid, n_seg=S)
    with pytest.raises(ValueError):
        hq.segment_absmax(buf[:, ::2], seg, valid, n_seg=S)
    assert (hq.segment_hist_moments.launches,
            hq.segment_absmax.launches) == before


def test_quantile_moments_on_card_equal_plain_versions(dev):
    """The two-pass selection through both kernels: thresholds, keep and
    max bitwise the plain versions', the other statistics within rtol
    1e-5; one absmax and two sweep launches."""
    buf, seg, valid, _, _, S = _edge_on(dev, 2048, "segments")
    count = torch.bincount(seg.long(), weights=valid.double(),
                           minlength=S).to(torch.int32)
    ops.reset_launch_counts()
    got = hq.segmented_quantile_moments(buf, seg, valid, count, 0.1,
                                        n_seg=S)
    counts = ops.launch_counts()
    assert counts["segment_absmax"] == 1
    assert counts["segment_hist_moments"] == 2
    with ops.plain_versions():
        want = hq.segmented_quantile_moments(buf, seg, valid, count, 0.1,
                                             n_seg=S)
    for k in ("threshold", "keep", "max"):
        assert torch.equal(got[k], want[k]), k
    for k in ("mean", "std", "mean_abs", "sum", "sumsq"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _merge_inputs(dev, M, N, dtype, seed):
    """A base with -0.0 entries, and planes with overlapping bits and
    padding bits beyond N set."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn((M, N), generator=gen, device=dev).to(dtype)
    base[0, :5] = -0.0
    pos, neg = _planes((3, M, -(-N // 32)), gen, dev)
    pos[0, 0, 0], neg[0, 0, 0] = -1, 0xFFFF
    pos[..., -1] |= -2 ** 31
    return base, pos, neg


@pytest.mark.parametrize("M,N,dtype", [(1, 4096, torch.bfloat16),
                                       (7, 100, torch.bfloat16),
                                       (5, 70, torch.float32),
                                       (64, 2048, torch.float32)])
def test_unpack_add_kernel_bitwise_equals_plain(dev, M, N, dtype):
    """Vector (N % 8 == 0) and element-wise paths, positive and negative
    scales, one expert of a stack, and transposed plane strides."""
    base, pos, neg = _merge_inputs(dev, M, N, dtype, M + N)
    # the same planes with a word stride of M and a row stride of 1
    p_t, n_t = (p[1].t().contiguous().t() for p in (pos, neg))
    for s in (0.37, -0.21):
        scale = torch.tensor(s, device=dev)
        before = unpack_add.launches
        got = unpack_add(base, pos[1], neg[1], scale)
        assert unpack_add.launches == before + 1
        want = unpack_add_plain(base, pos[1], neg[1], scale)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(unpack_add(base, p_t, n_t, scale)),
                           _bits(want))


@pytest.mark.parametrize("M,N,dtype", [(1, 4096, torch.bfloat16),
                                       (9, 100, torch.bfloat16),
                                       (33, 96, torch.float32)])
def test_unpack_add_many_kernel_bitwise_equals_plain_and_loop(dev, M, N,
                                                              dtype):
    base, pos, neg = _merge_inputs(dev, M, N, dtype, 7 * M + N)
    scales = torch.tensor([0.5, -0.25, 0.125], device=dev)
    got = unpack_add_many(base, pos, neg, scales)
    want = unpack_add_many_plain(base, pos, neg, scales)
    assert torch.equal(_bits(got), _bits(want))
    loop = base
    for e in range(3):
        loop = unpack_add(loop, pos[e], neg[e], scales[e])
    assert torch.equal(_bits(got), _bits(loop))
    with pytest.raises(ValueError):
        unpack_add_many(base.to(torch.float16), pos, neg, scales)


@pytest.mark.parametrize("M,N", [(1, 1), (3, 31), (1, 100003), (17, 2048),
                                 (5, 4133)])
def test_pack_scalar_kernel_bitwise_equals_plain(dev, M, N):
    """Ragged rows, -0.0 and 0.0, elements at the threshold; the [1, n]
    view of the same tensor too."""
    gen = torch.Generator(device=dev).manual_seed(M + N)
    tau = torch.randn((M, N), generator=gen, device=dev)
    flat = tau.view(-1)
    flat[::5], flat[1::7] = -0.0, 0.0
    thr = flat.abs().quantile(0.7) if flat.numel() < 2 ** 24 else \
        torch.tensor(0.5, device=dev)
    flat[2::11], flat[3::13] = -thr, thr
    for t in (tau, tau.reshape(1, -1)):
        before = pack_ternary_planes.launches
        got = pack_ternary_planes(t, thr)
        assert pack_ternary_planes.launches == before + 1
        want = pack_ternary_planes_plain(t, thr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = pack_ternary_planes(tau.to(torch.bfloat16), thr)
    want = pack_ternary_planes_plain(tau.to(torch.bfloat16), thr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("W,offset", [(1, 0), (7, 0), (4096, 0),
                                      (300001, 0), (4099, 1)])
def test_popcount_dot_kernel_bitwise_equals_plain(dev, W, offset):
    """16-byte loads when aligned, scalar loads at an offset of one word;
    dot(a, a) is nnz(a)."""
    gen = torch.Generator(device=dev).manual_seed(W)
    a = _planes((2, W + offset), gen, dev)
    b = _planes((2, W + offset), gen, dev)
    ap, an, bp, bn = (p[0, offset:] for p in a + b)
    before = popcount_dot.launches
    got = popcount_dot(ap, an, bp, bn)
    assert popcount_dot.launches == before + 1
    assert torch.equal(got, popcount_dot_plain(ap, an, bp, bn))
    assert torch.equal(popcount_dot(ap, an, ap, an),
                       popcount_dot_plain(ap, an, ap, an))


@pytest.mark.parametrize("M,K,N", [(1, 64, 32), (4, 300, 96),
                                   (4, 11008, 2048), (4, 2048, 2048),
                                   (4, 2048, 11008), (9, 33, 265 * 32)])
def test_ternary_matmul_kernel_matches_plain_and_grouped_rows(dev, M, K, N):
    """Within |kernel - plain| <= 1e-4 * max |plain| (f32, other
    summation orders); each row bitwise equal to the grouped kernel's row
    on the same expert (the same summation order, two kernels)."""
    gen = torch.Generator(device=dev).manual_seed(K)
    E = 3
    pos, neg = _planes((E, K, N // 32), gen, dev)
    x = torch.randn((M, K), generator=gen, device=dev)
    scales = torch.tensor([0.5, -0.25, 0.013], device=dev)
    for e in range(E):
        got = ternary_matmul(x, pos[e], neg[e], scales[e])
        want = ternary_matmul_plain(x, pos[e], neg[e], scales[e])
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max()) + 1e-30
        eid = torch.full((M,), e, dtype=torch.int32, device=dev)
        grouped = ternary_matmul_grouped(x, pos, neg, scales, eid)
        assert torch.equal(got, grouped)


def _sample_inputs(dev, B, V, temperature, top_k, seed):
    """Scaled, top-k masked logits as ``select_tokens`` makes them, keys
    from (seed, uid) and stream positions up to 2**31."""
    from repro_torch.serve import sampling
    gen_t = torch.Generator(device=dev).manual_seed(seed)
    logits = 4.0 * torch.randn((B, V), generator=gen_t, device=dev)
    scaled = logits / logits.new_full((1, 1), temperature)
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    keys = sampling.row_keys(seed, [7, 2014, 2 ** 31, 2 ** 32 - 1][:B]).to(dev)
    gen = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31][:B], device=dev)
    return scaled.contiguous(), keys, gen


@pytest.mark.parametrize("V", [512, 32000, 151936, 256000])
@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (1.0, 40)])
def test_sample_kernel_bitwise_equals_plain(dev, V, temperature, top_k):
    """Tokens and gumbel noise bitwise the plain version's on the card;
    a row's token does not depend on the batch."""
    x, keys, gen = _sample_inputs(dev, 4, V, temperature, top_k, seed=V)
    before = sample_tokens.launches
    tok, noise = sample_gumbel_argmax(x, keys, gen, noise=True)
    assert sample_tokens.launches == before + 1
    want_tok, want_noise = sample_gumbel_argmax_plain(x, keys, gen,
                                                      noise=True)
    assert torch.equal(noise, want_noise)
    assert torch.equal(tok, want_tok)
    assert torch.equal(sample_gumbel_argmax(x, keys, gen), tok)
    for b in range(4):
        assert torch.equal(sample_gumbel_argmax(
            x[b:b + 1], keys[b:b + 1], gen[b:b + 1]), tok[b:b + 1])


def test_sample_kernel_masked_rows_and_bad_inputs(dev):
    """-inf is never drawn over a finite value, a row of all -inf gives
    index 0 (as argmax), and inputs the kernel does not take raise."""
    from repro_torch.serve import sampling
    keys = sampling.row_keys(0, [1, 2]).to(dev)
    gen = torch.tensor([0, 3], device=dev)
    x = torch.full((2, 1000), float("-inf"), device=dev)
    x[0, 917] = -50.0
    assert sample_gumbel_argmax(x, keys, gen).tolist() == [917, 0]
    with pytest.raises(ValueError):
        sample_gumbel_argmax(x.double(), keys, gen)
    with pytest.raises(ValueError):
        sample_gumbel_argmax(x, keys.to(torch.int32), gen)
    with pytest.raises(ValueError):
        sample_gumbel_argmax(x[:, ::2], keys, gen)


def _logits(dev, B, V, dtype, seed, grid=None):
    """Logits [B, V] from a seed; with ``grid``, rounded to multiples of
    it first, so that the k-th value is tied many times."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 4.0 * torch.randn((B, V), generator=g, device=dev)
    if grid:
        x = torch.round(x / grid) * grid
    return x.to(dtype).contiguous()


def _sample_keys(dev, B, seed):
    from repro_torch.serve import sampling
    uids = [7, 2014, 2 ** 31, 2 ** 32 - 1, 5, 6][:B]
    gens = [0, 1, 2 ** 31 - 1, 2 ** 31, 77, 2 ** 20][:B]
    return (sampling.row_keys(seed, uids).to(dev),
            torch.tensor(gens, device=dev))


def _check_fused(x, keys, gen, T, top_k, alone=True):
    """Tokens and noise bitwise the plain version's, one launch a call,
    the noise-free launch the same tokens, and each row equal alone."""
    before = sample_tokens.launches
    tok, noise = sample_tokens(x, keys, gen, T, top_k, noise=True)
    assert sample_tokens.launches == before + 1
    want, want_noise = sample_tokens_plain(x, keys, gen, T, top_k,
                                           noise=True)
    assert torch.equal(noise, want_noise)
    assert torch.equal(tok, want), (T, top_k, tok.tolist(), want.tolist())
    assert torch.equal(sample_tokens(x, keys, gen, T, top_k), tok)
    if alone:
        for b in range(x.shape[0]):
            assert torch.equal(sample_tokens(
                x[b:b + 1], keys[b:b + 1], gen[b:b + 1], T, top_k),
                tok[b:b + 1])


@pytest.mark.parametrize("V", [512, 32000, 151936])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_tokens_kernel_bitwise_equals_plain(dev, V, dtype):
    """The fused sampler (scale, top-k cut, draw) against its plain
    version at T 0.7 / 1.0 and every kind of cut, stream positions up to
    2**31."""
    x = _logits(dev, 4, V, dtype, seed=V)
    keys, gen = _sample_keys(dev, 4, seed=V)
    for T in (0.7, 1.0):
        for top_k in (0, 1, 40, 1000, V - 1, V):
            _check_fused(x, keys, gen, T, top_k, alone=top_k in (0, 40))


@pytest.mark.parametrize("V", [512, 32000])
def test_sample_tokens_kernel_tied_thresholds(dev, V):
    """bf16 logits on a coarse grid (the k-th value tied many times), and
    rows whose k-th value is -0.0 or +0.0 with both zeros at the
    boundary: every tie survives, as in the plain version (several stream
    positions, so that zeros of both signs win draws)."""
    x = _logits(dev, 6, V, torch.float32, seed=3, grid=0.5)
    x[4] = -1.0 - torch.rand(V, device=dev)
    x[4, :10] = 0.5
    x[4, 10:30] = 0.0
    x[4, 30:50] = -0.0
    x[5] = x[4].flip(0)
    x = x.to(torch.bfloat16)
    keys, gen = _sample_keys(dev, 6, seed=4)
    for step in range(4):
        for T in (0.7, 1.0):
            for top_k in (1, 10, 11, 40, 41, V - 1):
                _check_fused(x, keys, gen + step, T, top_k, alone=False)
    from repro_torch.kernels.sample import scale_and_mask
    kept = torch.isfinite(scale_and_mask(x, 1.0, 40)[4:])
    assert kept.sum(dim=-1).tolist() == [50, 50]


@pytest.mark.parametrize("V,dtype", [(1001, torch.float32),
                                     (1001, torch.bfloat16),
                                     (600000, torch.bfloat16)])
def test_sample_tokens_kernel_odd_and_uncached_rows(dev, V, dtype):
    """A V that no 16-byte word divides (scalar loads), and a row too
    long for shared memory (read again at each pass)."""
    x = _logits(dev, 2, V, dtype, seed=V)
    keys, gen = _sample_keys(dev, 2, seed=1)
    for top_k in (1, 40, V - 1, 0):
        _check_fused(x, keys, gen, 0.8, top_k, alone=False)


def test_sample_tokens_concurrent_streams_agree(dev):
    """Launches that overlap on two streams give each its own tokens: the
    no-cut kernel's tickets are each launch's own scratch."""
    x = _logits(dev, 4, 151936, torch.bfloat16, seed=9)
    y = _logits(dev, 4, 151936, torch.bfloat16, seed=10)
    keys, gen = _sample_keys(dev, 4, seed=9)
    want = [sample_tokens_plain(z, keys, gen, 0.8, k)
            for z in (x, y) for k in (0, 40)]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize(dev)
    for _ in range(20):
        got = []
        for s, z in zip(streams, (x, y)):
            with torch.cuda.stream(s):
                got.append([sample_tokens(z, keys, gen, 0.8, k)
                            for k in (0, 40)])
        torch.cuda.synchronize(dev)
        assert all(torch.equal(g, w) for g, w in
                   zip(got[0] + got[1], want))


def test_sample_tokens_rejects_bad_inputs(dev):
    x = _logits(dev, 2, 1000, torch.float32, seed=0)
    keys, gen = _sample_keys(dev, 2, seed=0)
    for bad in (x.half(), x.double(), x[0], x[:, ::2]):
        with pytest.raises(ValueError):
            sample_tokens(bad, keys, gen, 0.8, 40)
    with pytest.raises(ValueError):
        sample_tokens(x, keys, gen, 0.8, -1)
    with pytest.raises(ValueError):
        sample_tokens(x, keys[:1], gen, 0.8, 40)
    with pytest.raises(ValueError):
        sample_tokens(x, keys, gen.to(torch.int32), 0.8, 40)
    wide = torch.zeros(1, dtype=torch.bfloat16, device=dev).expand(1, 2 ** 31)
    with pytest.raises(ValueError):
        sample_tokens(wide, keys[:1], gen[:1], 0.8, 40)


def test_launch_counts_reset(dev):
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# The decode chunk as a CUDA graph (serving on a two-unit smoke config)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    from repro_torch import api, tree as tree_util
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    model = build(get_smoke_config("qwen2_5_3b", n_units=2))
    base = model.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    experts = [api.compress(tree_util.tree_map(
        lambda l: 0.03 * torch.randn(l.shape, generator=gen, device="cuda"),
        base), name=f"e{i}", density=0.2) for i in range(3)]
    reg = api.registry(experts=experts)
    return model, base, reg


def _requests(names, budgets, lens, seed=0):
    from repro_torch.serve import Request
    g = torch.Generator().manual_seed(seed)
    return [Request(uid=i, expert=n, max_new_tokens=b,
                    prompt=torch.randint(2, 500, (L,), generator=g))
            for i, (n, b, L) in enumerate(zip(names, budgets, lens))]


def _serve(serving, reqs, **kw):
    from repro_torch import api
    model, base, reg = serving
    eng = api.serve(model, base, reg, **dict(dict(max_batch=3, cache_len=64),
                                            **kw))
    eng.run(reqs)
    return eng, [r.out_tokens for r in reqs]


REFILL = (["e0", "e1", "__base__", "e2", "e0", "e1", "e2"],
          (2, 3, 4, 2, 3, 4, 2), (6, 8, 10, 6, 8, 10, 6))


@pytest.mark.parametrize("K", [1, 4, 8])
def test_graph_chunk_equals_eager_loop_with_admissions(serving, K):
    _, eager = _serve(serving, _requests(*REFILL), decode_chunk=0)
    eng, toks = _serve(serving, _requests(*REFILL), decode_chunk=K)
    assert toks == eager
    s = eng.swap_summary()
    assert s["admitted"] >= 1
    assert s["graph_captures"] >= 1 and s["graph_replays"] >= s["graphs"]


@pytest.mark.parametrize("K,top_k", [(1, 5), (4, 0), (8, 5)])
def test_sampled_graph_chunk_equals_eager_loop(serving, K, top_k):
    """Sampled (f32 smoke model): the graphed chunks draw the eager loop's
    streams, admissions included; the sampler kernel runs in the graphs
    and a warm engine captures nothing new."""
    from repro_torch.kernels import ops
    kw = dict(temperature=0.8, top_k=top_k, seed=3)
    _, eager = _serve(serving, _requests(*REFILL), decode_chunk=0, **kw)
    eng, toks = _serve(serving, _requests(*REFILL), decode_chunk=K, **kw)
    assert toks == eager
    assert eng.swap_summary()["admitted"] >= 1
    before = eng.swap_summary()["graph_captures"]
    ops.reset_launch_counts()
    reqs = _requests(*REFILL)
    eng.run(reqs)
    torch.cuda.synchronize()
    assert [r.out_tokens for r in reqs] == eager
    assert eng.swap_summary()["graph_captures"] == before
    assert ops.launch_counts()["sample_tokens"] > len(reqs)


def test_sampled_decode_runs_one_sampler_launch_a_step(serving,
                                                      monkeypatch):
    """A sampled serve on the card runs the fused sampler, once a step
    (the same count graphed as eager), and never torch.topk."""
    def no_topk(*args, **kwargs):
        raise AssertionError("torch.topk ran on the sampled path")

    monkeypatch.setattr(torch, "topk", no_topk)
    kw = dict(temperature=0.8, top_k=5, seed=3)
    names, budgets, lens = ["e0", "e1", "__base__"], (5, 3, 4), (6, 9, 7)
    counts, toks = [], []
    for K in (0, 4):
        eng, _ = _serve(serving, _requests(names, budgets, lens),
                        decode_chunk=K, **kw)
        ops.reset_launch_counts()
        reqs = _requests(names, budgets, lens)
        eng.run(reqs)
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        toks.append([r.out_tokens for r in reqs])
    assert counts[0] == counts[1] and toks[0] == toks[1]
    # one launch selects the first tokens of a wave, then one a step
    assert counts[1]["sample_tokens"] == max(budgets)


def test_warm_engine_serves_new_expert_sets_without_capture(serving):
    """Waves of other expert sets of the same size, an admission and a
    merge-path swap reuse the graphs; tokens repeat a fresh engine's."""
    names_b = ["e2", "__base__", "e1", "e0"]
    budgets, lens = (3, 3, 3, 2), (8, 8, 8, 6)
    eng, _ = _serve(serving, _requests(["e0", "e1", "e2", "e1"], budgets,
                                       lens), decode_chunk=4)
    before = eng.swap_summary()["graph_captures"]
    reqs = _requests(names_b, budgets, lens, seed=1)
    eng.run(reqs)
    assert eng.swap_summary()["graph_captures"] == before
    _, fresh = _serve(serving, _requests(names_b, budgets, lens, seed=1),
                      decode_chunk=4)
    assert [r.out_tokens for r in reqs] == fresh
    g, _ = _serve(serving, _requests(["e0", "e0"], (4, 4), (8, 8)),
                  scheduling="grouped", max_batch=2, decode_chunk=4)
    before = g.swap_summary()["graph_captures"]
    g.run(_requests(["e1", "e1"], (4, 4), (8, 8), seed=2))
    s = g.swap_summary()
    assert s["n_swaps"] == 2 and s["graph_captures"] == before


def test_launch_counts_after_replays_equal_eager_loop(serving):
    from repro_torch.kernels import ops
    names, budgets, lens = ["e0", "e1", "__base__"], (5, 3, 4), (6, 9, 7)
    counts = []
    for K in (0, 4):
        eng, _ = _serve(serving, _requests(names, budgets, lens),
                        decode_chunk=K)
        ops.reset_launch_counts()
        eng.run(_requests(names, budgets, lens))
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        if K:
            assert eng.swap_summary()["graph_replays"] >= 2
    assert counts[0] == counts[1]
    assert counts[1]["ternary_matmul_grouped"] > 0


def test_failing_capture_raises(serving, monkeypatch):
    """A host read inside the chunk breaks the capture: the engine raises,
    and no chunk runs as the Python loop instead."""
    from repro_torch.serve import decode_loop

    def reads_host(logits, keys, gen, sampling, comm=None):
        int(logits.sum())
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)

    monkeypatch.setattr(decode_loop, "select_tokens", reads_host)
    from repro_torch import api
    model, base, reg = serving
    eng = api.serve(model, base, reg, max_batch=3, cache_len=64,
                    decode_chunk=4)
    reqs = _requests(["e0", "e1"], (4, 4), (6, 6))
    with pytest.raises(RuntimeError):
        eng.run(reqs)
    torch.cuda.synchronize()
    assert eng._chunker.replays == 0
    assert all(len(r.out_tokens) == 0 for r in reqs)


# ---------------------------------------------------------------------------
# Paged KV under the graphed decode chunk
# ---------------------------------------------------------------------------


PAGED = dict(kv_layout="paged", kv_block_size=8)


def _eager_chunks(eng, K):
    """``eng`` with each decode chunk computed by the chunk's own loop,
    without its graph (the same kernels, shapes and admission points)."""
    from repro_torch.serve.decode_loop import host_decode_steps
    chunk = eng._chunker
    eng._chunk_fn = lambda p, o, e, tok, cache, rem, gen, keys: (
        tok, cache, chunk._run(p, o, e, tok, cache, torch.as_tensor(
            rem, dtype=torch.int32, device=tok.device), gen, keys,
            host_decode_steps(max(rem), K)))
    return eng


@pytest.mark.parametrize("K,sampled", [(1, False), (4, False), (8, True)])
def test_paged_graph_chunk_equals_eager_chunks(serving, K, sampled):
    from repro_torch import api
    model, base, reg = serving
    kw = dict(temperature=0.8, top_k=5, seed=3) if sampled else {}
    eng, toks = _serve(serving, _requests(*REFILL), decode_chunk=K,
                       scheduler="priority", **PAGED, **kw)
    s = eng.swap_summary()
    assert s["admitted"] >= 1 and s["graph_captures"] >= 1
    assert s["graph_replays"] >= s["graphs"]
    eager = _eager_chunks(api.serve(model, base, reg, max_batch=3,
                                    cache_len=64, decode_chunk=K,
                                    scheduler="priority", **PAGED, **kw), K)
    reqs = _requests(*REFILL)
    eager.run(reqs)
    assert [r.out_tokens for r in reqs] == toks
    assert eager.swap_summary()["graph_captures"] == 0


@pytest.mark.parametrize("sched", ["fifo", "priority", "affinity"])
def test_warm_paged_engine_captures_nothing_and_leaks_no_blocks(serving,
                                                                sched):
    eng, toks = _serve(serving, _requests(*REFILL), decode_chunk=4,
                       scheduler=sched, **PAGED)
    before = eng.swap_summary()["graph_captures"]
    reqs = _requests(*REFILL)
    eng.run(reqs)
    torch.cuda.synchronize()
    s = eng.swap_summary()
    assert [r.out_tokens for r in reqs] == toks
    assert s["graph_captures"] == before
    assert s["kv"]["blocks_in_use"] == 0
    assert 1 <= s["kv"]["blocks_peak"] <= s["kv"]["blocks_total"]
    # a pool of 7 blocks re-queues the overflow and gives the same tokens
    small, small_toks = _serve(serving, _requests(*REFILL), decode_chunk=4,
                               scheduler=sched, kv_blocks=7, **PAGED)
    assert small_toks == toks
    kv = small.swap_summary()["kv"]
    assert kv["blocks_in_use"] == 0 and kv["blocks_peak"] <= 6


def test_paged_launch_counts_match_dense_per_step(serving):
    """One decode step launches the grouped kernel as often on block pools
    as on the dense ring (every projection and the head)."""
    from repro_torch import api
    from repro_torch.serve import paged_kv
    model, base, reg = serving
    eng = api.serve(model, base, reg, max_batch=3, cache_len=64)
    overlay = eng._overlay_for(("e0", "e1"))
    eid = torch.tensor([eng.slot_of(n) for n in ("e0", "e1", "e0")],
                       dtype=torch.int32, device="cuda")
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(2, 500, (3, 8), generator=g).cuda()
    _, dense = model.prefill(base, {"tokens": toks}, 64, delta=overlay,
                             eid=eid)
    _, rows = model.prefill(base, {"tokens": toks}, 8, delta=overlay,
                            eid=eid)
    paged = paged_kv.init_paged_cache(model.cfg, 3, 25, 8, 8,
                                      device="cuda")
    blocks = torch.tensor([[1, 2], [3, 4], [5, 6]], device="cuda")
    tables = torch.full((3, 8), -1, dtype=torch.int32, device="cuda")
    tables[:, :2] = blocks.to(torch.int32)
    paged_kv.insert_prefill_rows(
        paged, rows["layers"], torch.arange(3, device="cuda"), blocks[:, :1],
        tables, torch.full((3,), 8, dtype=torch.int32, device="cuda"),
        torch.zeros(3, dtype=torch.int32, device="cuda"))
    tok = torch.full((3, 1), 7, dtype=torch.int32, device="cuda")
    counts = []
    for cache in (dense, paged):
        ops.reset_launch_counts()
        logits, _ = model.decode_step(base, tok, cache, delta=overlay,
                                      eid=eid)
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        assert torch.isfinite(logits).all()
    assert counts[0] == counts[1]
    assert counts[1]["ternary_matmul_grouped"] > 0
    assert paged["lens"].tolist() == [9, 9, 9]


# ---------------------------------------------------------------------------
# Remote expert tiers under the graphed decode chunk
# ---------------------------------------------------------------------------


def _spans(obj, attr, spans):
    """Record each call's (start, end) of the method ``attr`` of ``obj``."""
    import time
    inner = getattr(obj, attr)

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return inner(*args, **kwargs)
        finally:
            spans.append((t0, time.monotonic()))
    setattr(obj, attr, timed)


def test_prefetch_stages_while_a_graph_captures(serving):
    """e2 sits behind a slow simulated link: a fresh engine captures its
    first wave's decode graphs while e2's prefetch stage is in flight on
    a worker thread.  Captures run in the global error mode, where a
    worker's CUDA call would break them: none breaks, the stage is on the
    host, the prefetch hits and the tokens are a local registry's."""
    from repro_torch import api
    from repro_torch.expert import PACKED
    from repro_torch.transport import (InMemoryTransport,
                                       SimulatedNetworkTransport)
    model, base, reg = serving
    link = SimulatedNetworkTransport(latency_s=1.5, inner=InMemoryTransport())
    api.publish(reg.get("e2"), link, rep=PACKED)
    rreg = api.registry(transport=link)
    rreg.add(reg.get("e0"), reg.get("e1"))      # local, on the card
    gets, caps = [], []
    _spans(link, "_get", gets)
    names, budgets, lens = (["e0", "e1", "e0", "e2", "e2", "e2"], (4,) * 6,
                            (8,) * 6)
    eng = api.serve(model, base, rreg, max_batch=3, cache_len=64,
                    decode_chunk=4)
    _spans(eng._chunker, "_capture", caps)
    reqs = _requests(names, budgets, lens)
    eng.run(reqs)
    assert caps and any(g0 < c0 and c1 < g1 for c0, c1 in caps
                        for g0, g1 in gets)
    s = eng.swap_summary()
    assert s["prefetch_hits"] >= 1 and s["prefetch_errors"] == 0
    _, local = _serve(serving, _requests(names, budgets, lens),
                      decode_chunk=4)
    assert [r.out_tokens for r in reqs] == local
    rreg.close()


@pytest.mark.parametrize("kind", ["local", "http"])
def test_remote_registry_tokens_equal_local(serving, tmp_path, kind):
    """The same experts fetched from a directory (Golomb blobs, decoded on
    the host) or over loopback HTTP (PACKED blobs) serve a local
    registry's tokens bitwise, admissions included, with the published
    planes on the card."""
    from repro_torch import api
    from repro_torch.expert import GOLOMB, PACKED
    from repro_torch.transport import (HTTPTransport, LocalTransport,
                                       serve_local_http)
    model, base, reg = serving
    root = LocalTransport(str(tmp_path))
    for n in ("e0", "e1", "e2"):
        api.publish(reg.get(n), root, rep=GOLOMB if kind == "local"
                    else PACKED)
    server = None
    tr = root
    if kind == "http":
        server, url = serve_local_http(str(tmp_path))
        tr = HTTPTransport(url)
    try:
        rreg = api.registry(transport=tr)
        eng, toks = _serve((model, base, rreg), _requests(*REFILL),
                           decode_chunk=4)
        _, want = _serve(serving, _requests(*REFILL), decode_chunk=4)
        assert toks == want
        for n in ("e0", "e1", "e2"):
            got, pub = rreg.fetch_packed(n), reg.get(n).packed
            for p, pt in pub.items():
                assert torch.equal(got[p].pos, pt.pos)
                assert torch.equal(got[p].neg, pt.neg)
                assert got[p].pos.device.type == "cuda"
        s = eng.swap_summary()
        assert s["remote_fetches"] == 3 and s["prefetch_errors"] == 0
        rreg.close()
    finally:
        if server is not None:
            server.shutdown()


def test_capture_survives_cyclic_garbage_holding_graphs(serving):
    """Graphs of an old engine that become cyclic garbage inside another
    engine's capture: a collection there would destroy them, a CUDA call
    that invalidates the capture in the global error mode.  Captures run
    with the collector paused, so the capture holds and the garbage goes
    afterwards."""
    import gc
    import weakref
    from repro_torch import api

    class Box:
        pass

    names, budgets, lens = ["e0", "e1", "e2"], (3, 3, 3), (8, 8, 8)
    old, _ = _serve(serving, _requests(names, budgets, lens),
                    decode_chunk=4)
    holder = [old._chunker._graphs]
    assert holder[0]
    old._chunker._graphs = {}
    del old
    gone = []
    model, base, reg = serving
    eng = api.serve(model, base, reg, max_batch=3, cache_len=64,
                    decode_chunk=4)
    run = eng._chunker._run

    def drop_then_run(*args, **kwargs):
        if holder:                  # first call: inside the first capture
            box = Box()
            box.graphs, box.cycle = holder.pop(), box
            gone.append(weakref.ref(box))
            del box                 # a young cycle only the collector frees
            _ = [[] for _ in range(5000)]   # allocations that would run it
        return run(*args, **kwargs)

    eng._chunker._run = drop_then_run
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        reqs = _requests(names, budgets, lens)
        eng.run(reqs)
    finally:
        gc.set_threshold(*thresholds)
    assert gone and eng.swap_summary()["graph_captures"] >= 1
    _, want = _serve(serving, _requests(names, budgets, lens),
                     decode_chunk=4)
    assert [r.out_tokens for r in reqs] == want
    gc.collect()
    assert gone[0]() is None


# ---------------------------------------------------------------------------
# Durability: a resume restores into the kept buffers
# ---------------------------------------------------------------------------

# budgets such that a row ends at chunk 2 (decode_chunk 2): its slot is
# refilled after the last snapshot before a crash at chunk 3
DURABLE = (REFILL[0], (4, 8, 6, 5, 7, 6, 4), REFILL[2])


def _kept_ptrs(eng):
    from repro_torch import tree as tree_util
    return {f"{kind}{rows}/{path}": t.data_ptr()
            for kind, states in (("dense", eng._states),
                                 ("paged", eng._paged_states))
            for rows, st in states.items()
            for path, t in tree_util.flatten_with_paths(st)}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_warm_resume_restores_in_place_without_capture(serving, tmp_path,
                                                       layout):
    """A crash at the third chunk of a run, then ``resume()`` on the same
    warm engine: every kept buffer keeps its address, no graph is
    captured, kernel 1 (and the sampler, paged and sampled) runs, the f32
    tokens equal the uninterrupted run's and no block is left in use; a
    fresh engine resumes to the same tokens."""
    from repro_torch import api
    model, base, reg = serving
    kw = dict(max_batch=3, cache_len=64, decode_chunk=2,
              snapshot_dir=str(tmp_path / "snap"), snapshot_every_chunks=1)
    if layout == "paged":
        kw.update(PAGED, scheduler="affinity", temperature=0.8, top_k=5,
                  seed=3)
    eng = api.serve(model, base, reg, **kw)
    clean = _requests(*DURABLE)
    eng.run(clean)
    want = {r.uid: r.out_tokens for r in clean}
    kill = eng._chunk_idx + 3

    def crash(i):
        if i == kill:
            raise RuntimeError("injected crash")

    eng.chunk_hooks.append(crash)
    with pytest.raises(RuntimeError, match="injected crash"):
        eng.run(_requests(*DURABLE))
    eng.chunk_hooks.clear()
    ptrs = _kept_ptrs(eng)
    before = eng.swap_summary()["graph_captures"]
    ops.reset_launch_counts()
    out = eng.resume()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert {r.uid: r.out_tokens for r in out} == want
    after = _kept_ptrs(eng)
    assert {k: after[k] for k in ptrs} == ptrs
    s = eng.swap_summary()
    assert s["graph_captures"] == before
    assert s["kv"]["blocks_in_use"] == 0
    assert launches["ternary_matmul_grouped"] > 0
    if layout == "paged":
        assert launches["sample_tokens"] > 0
    plan = eng.recovery_stats["plan"]
    assert plan.snapshot_step == kill - 1
    assert plan.replayed_rows > 0 and plan.reprefilled_rows > 0
    fresh = api.serve(model, base, reg, **kw)
    assert {r.uid: r.out_tokens for r in fresh.resume()} == want
    assert fresh.swap_summary()["kv"]["blocks_in_use"] == 0


# ---------------------------------------------------------------------------
# Training on the card: a deterministic step, gradient compression
# ---------------------------------------------------------------------------


def _train_setup(dev, opt):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    from repro_torch.train import TrainConfig, init_train_state
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b", n_units=2),
                              dtype="bfloat16")
    api = build(cfg)
    tcfg = TrainConfig(optimizer=opt, peak_lr=1e-2, warmup_steps=1,
                       total_steps=10)
    return cfg, api, tcfg, init_train_state(api.init(seed=0, device=dev),
                                            tcfg)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_steps_replay_bitwise(dev, opt):
    """Three bf16 train steps twice from the same state on the card (the
    embedding and gather backwards under deterministic algorithms): every
    parameter and optimizer leaf bitwise equal, the loss finite, and the
    deterministic mode restored after each step."""
    from repro_torch import tree as tree_util
    from repro_torch.data.pipeline import make_batch_for
    from repro_torch.train import make_train_step
    cfg, api, tcfg, state0 = _train_setup(dev, opt)
    step = make_train_step(api, tcfg)
    runs = []
    for _ in range(2):
        state = state0
        for s in range(3):
            state, m = step(state, make_batch_for(cfg, s, 32, 8, 1,
                                                  device=dev))
            assert torch.isfinite(m["loss"])
        runs.append(state)
    assert not torch.are_deterministic_algorithms_enabled()
    for a, b in zip(tree_util.leaves(runs[0]), tree_util.leaves(runs[1])):
        assert torch.equal(a, b)


def test_compress_leaf_for_allgather_on_the_card(dev):
    """``compress_leaf_for_allgather`` on a CUDA gradient: planes bitwise
    the CPU's (exact threshold, bitwise on both), scale within 1e-6
    relative, the error feedback ``g - s * signs`` bitwise its own planes'
    reconstruction, and the plane density within 0.5 points of 0.05."""
    from repro_torch.core import gradient_compression as gc
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((64, 2048), generator=gen, device=dev)
    e = 0.1 * torch.randn((64, 2048), generator=gen, device=dev)
    cfg = gc.GradCompressionConfig(density=0.05, exact_threshold=True)
    pos, neg, scale, err = gc.compress_leaf_for_allgather(g, e, cfg)
    cpos, cneg, cscale, _ = gc.compress_leaf_for_allgather(g.cpu(), e.cpu(),
                                                           cfg)
    assert torch.equal(pos.cpu(), cpos) and torch.equal(neg.cpu(), cneg)
    assert abs(float(scale) - float(cscale)) <= 1e-6 * float(cscale)
    signs = gc._unpack_planes(pos, neg, 2048)
    assert torch.equal(err, (g + e) - signs * scale)
    density = float((signs != 0).float().mean())
    assert abs(density - 0.05) <= 0.005


# ---------------------------------------------------------------------------
# The MoE configs by merge-on-swap, and qwen3's q/k norms under the overlay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 256, 448), torch.bfloat16),     # an expert stack [U, E, d, f]
    ((2, 4096, 8), torch.float32)])         # mixtral's router, f32
def test_unpack_add_many_on_moe_leaves(dev, shape, dtype):
    """Kernel 4 through ``ops.apply_ternary_delta_many_flat`` on planes
    from the compression kernels, one expert and two: bitwise the plain
    merge (``unpack_add_many_ref``)."""
    from repro_torch.core.compeft import CompressionConfig, compress_packed
    gen = torch.Generator(device=dev).manual_seed(21)
    base = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pts = [compress_packed({"w": 0.01 * torch.randn(
        shape, generator=gen, device=dev)}, CompressionConfig(
            density=0.1))["w"] for _ in range(2)]
    for sel in (pts[:1], pts):
        before = ops.launch_counts()["unpack_add_many"]
        got = ops.apply_ternary_delta_many_flat(base, sel)
        assert ops.launch_counts()["unpack_add_many"] == before + 1
        with ops.plain_versions():
            want = ops.apply_ternary_delta_many_flat(base, sel)
        assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
        assert not torch.equal(got, base)


def _smoke_serving(arch, head_dim_32=False):
    from arch_cases import head_dim_32 as widen
    from repro_torch import api, tree as tree_util
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    cfg = get_smoke_config(arch, n_units=2)
    model = build(widen(cfg) if head_dim_32 else cfg)
    base = model.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    experts = [api.compress(base, tree_util.tree_map(
        lambda l: (l.float() + 0.03 * torch.randn(
            l.shape, generator=gen, device="cuda")).to(l.dtype), base),
        name=f"e{i}", density=0.2) for i in range(3)]
    return model, base, api.registry(experts=experts)


@pytest.fixture(scope="module")
def moe_serving():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return _smoke_serving("mixtral_8x7b")


# prompts past mixtral's smoke window of 32
MOE_REQS = (["e0", "e1", "__base__", "e2", "e0", "e1"], (3, 5, 4, 6, 2, 5),
            (34, 40, 36, 44, 35, 38))


@pytest.mark.parametrize("K", [1, 4])
def test_moe_graph_chunk_equals_eager_chunks(moe_serving, K):
    """mixtral (no overlay plan) served with mixed scheduling falls back
    to merge-on-swap: one kernel-4 merge per leaf per distinct expert, its
    decode chunks CUDA graphs whose tokens equal the same chunks run
    eagerly and the eager per-token loop."""
    from repro_torch import api
    model, base, reg = moe_serving
    n0 = ops.launch_counts()["unpack_add_many"]
    eng, toks = _serve(moe_serving, _requests(*MOE_REQS), decode_chunk=K)
    s = eng.swap_summary()
    assert eng._plan is None and s["n_waves"] == 0 and s["n_swaps"] == 3
    assert ops.launch_counts()["unpack_add_many"] > n0
    assert s["graph_captures"] >= 1 and s["graph_replays"] >= s["graphs"]
    eager = _eager_chunks(api.serve(model, base, reg, max_batch=3,
                                    cache_len=64, decode_chunk=K), K)
    reqs = _requests(*MOE_REQS)
    eager.run(reqs)
    assert [r.out_tokens for r in reqs] == toks
    assert eager.swap_summary()["graph_captures"] == 0
    assert _serve(moe_serving, _requests(*MOE_REQS), decode_chunk=0)[1] == \
        toks


@pytest.mark.parametrize("paged", [False, True])
def test_qk_norm_overlay_graph_chunk_equals_eager_chunks(dev, paged):
    """qwen3's q/k norms (heads of 32, so the overlay covers them) with
    their per-row deltas inside the graphed decode chunk, dense and paged:
    tokens equal the same chunks run eagerly (the CPU tests hold the
    deltas against the reference)."""
    from repro_torch import api
    model, base, reg = _smoke_serving("qwen3_32b", head_dim_32=True)
    kw = dict(max_batch=3, cache_len=64, decode_chunk=4)
    if paged:
        kw.update(PAGED)
    reqs = _requests(*REFILL)
    eng = api.serve(model, base, reg, **kw)
    assert eng._plan is not None
    eng.run(reqs)
    toks = [r.out_tokens for r in reqs]
    assert eng.swap_summary()["graph_captures"] >= 1
    eager = _eager_chunks(api.serve(model, base, reg, **kw), 4)
    again = _requests(*REFILL)
    eager.run(again)
    assert [r.out_tokens for r in again] == toks


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) serving mesh under NCCL (a one-rank world on a free
    localhost port), torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serve_mesh
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    started = not dist.is_initialized()
    mesh = make_serve_mesh((1, 1), device="cuda")
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("layout,sampled", [("dense", False),
                                            ("paged", False),
                                            ("dense", True)])
def test_one_rank_nccl_mesh_tokens_equal_mesh_free(serving, one_rank_mesh,
                                                   layout, sampled):
    """The mesh code path on the card: a (1, 1) NCCL mesh captures its
    decode chunks and gives the mesh-free engine's tokens bitwise."""
    kw = dict(decode_chunk=4, kv_layout=layout)
    if sampled:
        kw.update(temperature=0.8, top_k=5, seed=7)
    _, want = _serve(serving, _requests(*REFILL), **kw)
    eng, got = _serve(serving, _requests(*REFILL), mesh=one_rank_mesh, **kw)
    assert got == want
    s = eng.swap_summary()
    assert s["mesh"] == {"expert": 1, "model": 1}
    assert s["graph_captures"] > 0 and s["kv"]["blocks_in_use"] == 0
    assert [x["capacity_bytes"] for x in s["shards"]] == [
        eng.cache.capacity]
    # the shared registry was made without a mesh: the engine's tier, on
    # its mesh, stays the registry's through the run
    assert eng.cache is eng.registry.device()
