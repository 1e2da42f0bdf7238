"""The port's clustering (pbnet_torch/ops/cluster.py) against the JAX
package's binary_cluster and against the numpy oracle of test_cluster.py.

Every ClusterResult field must be EXACTLY equal to JAX's — cluster ids,
density, sems, batches, sizes, validity, num_clusters, band_overflow,
nn_overflow and prop_rounds — except ``centers``, a float segment mean,
held to rtol 1e-5 / atol 1e-6 (f32 sums of a few hundred points).  Inputs
are made with numpy from a seed.  On the CPU the port's four banded passes
run their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.ops import cluster as jcl
from pbnet_torch.ops import cluster as tcl
from tests.test_cluster import COUNT_MEAN, make_scene, oracle

INT_FIELDS = ("cluster_id", "num_clusters", "density", "cluster_sem", "cluster_batch",
              "cluster_size", "cluster_valid", "band_overflow", "nn_overflow",
              "prop_rounds")


def run_both(args, **kw):
    """args: numpy (shifted, orig, sem, batch, valid)."""
    ref = jcl.binary_cluster(*(jnp.asarray(a) for a in args),
                             count_mean=jnp.asarray(COUNT_MEAN), **kw)
    got = tcl.binary_cluster(*(torch.from_numpy(a) for a in args),
                             count_mean=torch.from_numpy(COUNT_MEAN), **kw)
    return ref, got


def assert_same(ref, got, centers_tol=(1e-5, 1e-6)):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               rtol=centers_tol[0], atol=centers_tol[1])


def padded_scene(rng, pad=37):
    shifted, orig, sem, batch = make_scene(rng)
    n = len(sem)

    def padv(x, fill):
        out = np.full((n + pad,) + x.shape[1:], fill, x.dtype)
        out[:n] = x
        return out

    valid = np.arange(n + pad) < n
    return (padv(shifted, 0), padv(orig, 0), padv(sem, 0), padv(batch, 0), valid), n


def test_matches_jax_and_oracle(rng):
    args, n = padded_scene(rng)
    ref, got = run_both(args, radius=0.1, min_pts=10, para_f=0.05,
                        cluster_cap=32, band=2048, chunk=128)
    assert_same(ref, got)
    ocid, onum, odens, octr, _ = oracle(
        args[0][:n], args[1][:n], args[2][:n], args[3][:n], np.ones(n, bool),
        0.1, 10, COUNT_MEAN)
    np.testing.assert_array_equal(got.cluster_id.numpy()[:n], ocid)
    np.testing.assert_array_equal(got.density.numpy()[:n], odens)
    assert int(got.num_clusters) == onum
    np.testing.assert_allclose(got.centers.numpy()[:onum], octr, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("band,chunk,nn_exact_cap,prop_iters", [
    (64, 32, 64, 10),    # narrow dual windows: band overflow + exact 1-NN pass
    (256, 64, 4, 10),    # exact-pass cap below the unproven rows: nn_overflow
    (2048, 128, None, 1),  # propagation cut at one round
])
def test_matches_jax_caps(rng, band, chunk, nn_exact_cap, prop_iters):
    args, _ = padded_scene(rng)
    ref, got = run_both(args, radius=0.1, min_pts=10, para_f=0.05, cluster_cap=32,
                        band=band, chunk=chunk, nn_exact_cap=nn_exact_cap,
                        prop_iters=prop_iters)
    assert_same(ref, got)


def test_exact_pass_row_blocks_match_jax(rng, monkeypatch):
    """The exact 1-NN pass one row per block (the block size ScanNet caps
    need on the card, taken to its limit) gives JAX's result."""
    monkeypatch.setattr(tcl, "EXACT_BLOCK_ELEMS", 1)
    blocks = []
    sq_dist = tcl.wk.sq_dist

    def spy(*a):
        blocks.append(tuple(a[0].shape))
        return sq_dist(*a)

    monkeypatch.setattr(tcl.wk, "sq_dist", spy)
    args, _ = padded_scene(rng)
    ref, got = run_both(args, radius=0.1, min_pts=10, para_f=0.05, cluster_cap=32,
                        band=64, chunk=32, nn_exact_cap=64, prop_iters=10)
    assert_same(ref, got)
    assert blocks.count((1, 1)) > 1  # the exact pass ran, one row per block


@pytest.mark.parametrize("nn_exact_cap", [None, 8])
def test_needy_heavy_matches_jax(rng, monkeypatch, nn_exact_cap):
    """Offsets with 6 cm of noise and many scattered noise points leave a
    large share of the rows without a cluster: the one-launch B4 answers
    needy rows spread over most chunks (and, at a small exact-pass cap, the
    rest overflow).  Every field equals JAX's."""
    masks = []
    window_1nn = tcl.wk.window_1nn

    def spy(*a):
        masks.append(a[2].clone())
        return window_1nn(*a)

    monkeypatch.setattr(tcl.wk, "window_1nn", spy)
    shifted, orig, sem, batch = make_scene(rng, n_noise=300)
    shifted = (shifted + rng.randn(*shifted.shape) * 0.06).astype(np.float32)
    args = (shifted, orig, sem, batch, np.ones(len(sem), bool))
    ref, got = run_both(args, radius=0.1, min_pts=10, para_f=0.05, cluster_cap=32,
                        band=256, chunk=64, nn_exact_cap=nn_exact_cap)
    assert_same(ref, got)
    (need,) = masks  # one B4 call per binary_cluster
    assert int(need.sum()) > len(sem) // 4
    assert int(need.any(1).sum()) >= need.shape[0] - 1 and int(got.num_clusters) > 0
    assert (int(got.nn_overflow) > 0) == (nn_exact_cap is not None)


def test_no_clusters_when_sparse(rng):
    n = 64
    shifted = (rng.rand(n, 3) * 10).astype(np.float32)
    args = (shifted, shifted, np.full(n, 2, np.int32), np.zeros(n, np.int32), np.ones(n, bool))
    ref, got = run_both(args, radius=0.05, min_pts=10, cluster_cap=8, band=256, chunk=32)
    assert_same(ref, got)
    assert int(got.num_clusters) == 0


def test_class_separation(rng):
    blob = (rng.randn(60, 3) * 0.01).astype(np.float32)
    shifted = np.concatenate([blob, blob])
    sem = np.array([2] * 60 + [3] * 60, np.int32)
    args = (shifted, shifted, sem, np.zeros(120, np.int32), np.ones(120, bool))
    ref, got = run_both(args, radius=0.1, min_pts=5, cluster_cap=8, band=512, chunk=64)
    assert_same(ref, got)
    assert int(got.num_clusters) == 2
