"""The port's EF-ternary gradient compression against the JAX package:
thresholds, packed planes, scales and error feedback of
``compress_leaf_for_allgather``, the reference's own invariants on the
port, and ``compressed_cross_pod_mean`` over 4 gloo processes against the
reference's ``shard_map`` over 4 forced CPU devices on the same
gradients.  Each test states its tolerance."""

import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradient_compression as J
from repro_torch.core import gradient_compression as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and six
    test workers each spinning a pool of every core's threads slow each
    other several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(density, exact):
    return (J.GradCompressionConfig(density=density, exact_threshold=exact),
            T.GradCompressionConfig(density=density, exact_threshold=exact))


def _words(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("density", [0.05, 0.1, 0.3])
def test_thresholds_match_reference(density):
    """Exact: the quantile bitwise.  Gaussian: within 1e-6 relative (std
    sums in other orders; erfinv may round an ulp apart), and keeping
    ~density of Gaussian entries (the reference's own test, 0.02)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, (50_000,)).astype(np.float32)
    jc, tc = _cfgs(density, True)
    assert float(T._threshold(torch.from_numpy(x), tc)) == \
        float(J._threshold(jnp.asarray(x), jc))
    want = float(J.gaussian_topk_threshold(jnp.asarray(x), density))
    got = T.gaussian_topk_threshold(torch.from_numpy(x), density)
    assert float(got) == pytest.approx(want, rel=1e-6)
    frac = float((torch.from_numpy(x).abs() >= got).float().mean())
    assert abs(frac - density) < 0.02


@pytest.mark.parametrize("shape", [(1000,), (1024,), (3, 70), (2, 5, 33)])
def test_planes_bitwise_and_roundtrip(shape):
    """Planes packed along the last axis only, bitwise the reference's
    uint32 words, and unpacked back to the signs."""
    rng = np.random.default_rng(1)
    signs = rng.integers(-1, 2, shape).astype(np.int8)
    jp, jn = J._pack_planes(jnp.asarray(signs))
    tp, tn = T._pack_planes(torch.from_numpy(signs))
    assert tuple(tp.shape) == tuple(jp.shape) == shape[:-1] + (
        -(-shape[-1] // 32),)
    np.testing.assert_array_equal(_words(jp), tp.numpy())
    np.testing.assert_array_equal(_words(jn), tn.numpy())
    back = T._unpack_planes(tp, tn, shape[-1])
    np.testing.assert_array_equal(back.numpy().astype(np.int8), signs)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", [(4096,), (3, 70), (2, 5, 33)])
def test_compress_leaf_matches_reference(shape, exact):
    """Planes bitwise (the test first checks that no |g + e| lies within
    1e-5 relative of either threshold, where an ulp of the threshold
    could flip a plane), scale within 1e-6 relative, error feedback
    within 1e-6 absolute (exact threshold: bitwise thresholds, so the
    planes agree without the check)."""
    rng = np.random.default_rng(2)
    g = rng.normal(0, 1, shape).astype(np.float32)
    e = (0.1 * rng.normal(0, 1, shape)).astype(np.float32)
    jc, tc = _cfgs(0.1, exact)
    jt = float(J._threshold(jnp.asarray(g + e), jc))
    tt = float(T._threshold(torch.from_numpy(g) + torch.from_numpy(e), tc))
    if not exact:
        mag = np.abs(g + e)
        assert not (np.abs(mag - jt) <= 1e-5 * jt).any()
        assert not (np.abs(mag - tt) <= 1e-5 * tt).any()
    jp, jn, js, je = J.compress_leaf_for_allgather(jnp.asarray(g),
                                                   jnp.asarray(e), jc)
    tp, tn, ts, te = T.compress_leaf_for_allgather(torch.from_numpy(g),
                                                   torch.from_numpy(e), tc)
    np.testing.assert_array_equal(_words(jp), tp.numpy())
    np.testing.assert_array_equal(_words(jn), tn.numpy())
    assert float(ts) == pytest.approx(float(js), rel=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6, rtol=0)
    # the error feedback is the residual of the port's own reconstruction
    signs = T._unpack_planes(tp, tn, shape[-1])
    assert torch.equal(te, (torch.from_numpy(g) + torch.from_numpy(e))
                       - signs * ts)


def test_error_feedback_reduces_bias():
    """The reference's EF test on the port: the mean of 120 repeated
    reconstructions of a constant gradient is within 12% of it, and closer
    than the first 10's."""
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.normal(0, 1, (8_192,)).astype(np.float32))
    cfg = T.GradCompressionConfig(density=0.1)
    err = torch.zeros_like(g)
    recons = []
    for _ in range(120):
        pos, neg, scale, err = T.compress_leaf_for_allgather(g, err, cfg)
        recons.append((T._unpack_planes(pos, neg, g.numel()) * scale).numpy())
    early = np.linalg.norm(np.mean(recons[:10], axis=0) - g.numpy())
    late = np.linalg.norm(np.mean(recons, axis=0) - g.numpy())
    assert late / np.linalg.norm(g.numpy()) < 0.12
    assert late < early


def test_init_error_state_and_ratio():
    params = {"a": torch.ones((3, 4), dtype=torch.bfloat16),
              "b": torch.ones((7,))}
    e = T.init_error_state(params)
    assert e["a"].shape == (3, 4) and e["a"].dtype == torch.float32
    assert float(e["b"].sum()) == 0.0
    assert T.compression_ratio(T.GradCompressionConfig()) == 16.0
    assert T.compression_ratio(T.GradCompressionConfig(enabled=False)) == 1.0


# the gradients of both runs: two leaves per pod, one 2-D (its last axis
# padded to a word), one 1-D
REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core.gradient_compression import (
        GradCompressionConfig, compressed_cross_pod_mean)
    data = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("pod",))
    out = {}
    for exact in (False, True):
        cfg = GradCompressionConfig(density=0.25, exact_threshold=exact)

        def f(w, v, ew):
            g = {"w": w[0], "v": v[0]}
            e = {"w": ew[0], "v": jnp.zeros_like(v[0])}
            mean, err = compressed_cross_pod_mean(g, e, cfg, axis_name="pod")
            return (mean["w"][None], mean["v"][None], err["w"][None],
                    err["v"][None])

        fm = shard_map(f, mesh=mesh, in_specs=P("pod"),
                       out_specs=(P("pod"),) * 4)
        res = jax.jit(fm)(jnp.asarray(data["w"]), jnp.asarray(data["v"]),
                          jnp.asarray(data["ew"]))
        for k, r in zip(("mean_w", "mean_v", "err_w", "err_v"), res):
            out[f"{k}_{int(exact)}"] = np.asarray(r)
    np.savez(sys.argv[2], **out)
""")

CHILD_SCRIPT = textwrap.dedent("""
    import datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.core.gradient_compression import (
        GradCompressionConfig, compressed_cross_pod_mean)
    rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=60))
    data = np.load(src)
    out = {}
    for exact in (False, True):
        cfg = GradCompressionConfig(density=0.25, exact_threshold=exact)
        g = {"w": torch.from_numpy(data["w"][rank]),
             "v": torch.from_numpy(data["v"][rank])}
        e = {"w": torch.from_numpy(data["ew"][rank]),
             "v": torch.zeros_like(g["v"])}
        mean, err = compressed_cross_pod_mean(g, e, cfg)
        for k in ("w", "v"):
            out[f"mean_{k}_{int(exact)}"] = mean[k].numpy()
            out[f"err_{k}_{int(exact)}"] = err[k].numpy()
    np.savez(dst, **out)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cross_pod_mean_over_gloo_matches_shard_map(tmp_path):
    """4 gloo processes against the reference's shard_map over 4 forced
    CPU devices: every rank's mean within 1e-6 absolute of the
    reference's (each rank's reconstructions summed in rank order, the
    scales an ulp apart at most), all ranks bitwise agreeing, the error
    feedback within 1e-6; Gaussian and exact thresholds.  Each child has
    a 120 s limit and its own free port."""
    rng = np.random.default_rng(0)
    src = str(tmp_path / "grads.npz")
    np.savez(src, w=rng.normal(0, 1, (4, 3, 70)).astype(np.float32),
             v=rng.normal(0, 1, (4, 2048)).astype(np.float32),
             ew=(0.1 * rng.normal(0, 1, (4, 3, 70))).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    ref_out = str(tmp_path / "ref.npz")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, src, ref_out],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port = _free_port()
    kids = [subprocess.Popen(
        [sys.executable, "-c", CHILD_SCRIPT, str(r), str(port), src,
         str(tmp_path / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for p in kids + [ref]:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in kids + [ref]:
            if p.poll() is None:
                p.kill()
    want = np.load(ref_out)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    for exact in (0, 1):
        for k in ("w", "v"):
            for r in range(4):
                m = got[r][f"mean_{k}_{exact}"]
                np.testing.assert_array_equal(m, got[0][f"mean_{k}_{exact}"])
                np.testing.assert_allclose(m, want[f"mean_{k}_{exact}"][r],
                                           atol=1e-6, rtol=0)
                np.testing.assert_allclose(got[r][f"err_{k}_{exact}"],
                                           want[f"err_{k}_{exact}"][r],
                                           atol=1e-6, rtol=0)
