"""The port on the card: each CUDA kernel against its plain version, and the
clustering on CUDA against the CPU path.  Needs a CUDA device (``cuda``
marker; each test skips without one).

This file imports neither JAX nor pbnet_tpu, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX for the parity tests.)
"""

import numpy as np
import pytest
import torch

from pbnet_torch.models.pbnet import COUNT_MEAN
from pbnet_torch.ops import cluster as cl
from pbnet_torch.ops import window_kernels as wk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiles(rng, dev, nchunks=5, chunk=96, W=2080):
    """Rows and two windows over a small cube on a 1/8 grid (exact ties)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rows_f = t((rng.randint(0, 6, (nchunks, 3, chunk)) / 8.0).astype(np.float32))
    rows_i = t(np.stack([rng.randint(0, 3, (nchunks, chunk)), rng.rand(nchunks, chunk) < 0.9,
                         np.arange(nchunks * chunk).reshape(nchunks, chunk)], 1).astype(np.int32))
    wins = []
    for _ in range(2):
        wins.append(t((rng.randint(0, 6, (nchunks, 3, W)) / 8.0).astype(np.float32)))
        wins.append(t(np.stack([rng.randint(0, 3, (nchunks, W)), rng.rand(nchunks, W) < 0.8,
                                rng.randint(0, nchunks * chunk, (nchunks, W))],
                               1).astype(np.int32)))
    return t, rows_f, rows_i, wins


def test_kernels_match_plain(dev):
    rng = np.random.RandomState(0)
    t, rows_f, rows_i, wins = tiles(rng, dev)
    before = dict(wk.LAUNCHES)
    got = wk.neighbor_pack(0.140625, rows_f, rows_i, *wins)
    for g, w in zip(got, wk.neighbor_pack_plain(0.140625, rows_f, rows_i, *wins)):
        assert torch.equal(g, w)
    b1, b2 = got[0], got[1]
    nchunks, W = wins[0].shape[0], wins[0].shape[2]
    v = [t(rng.randint(-1, 10_000, (nchunks, W)).astype(np.int32)) for _ in range(4)]
    for minimize in (True, False):
        assert torch.equal(wk.masked_window_reduce(b1, b2, v[0], v[1], minimize),
                           wk.masked_window_reduce_plain(b1, b2, v[0], v[1], minimize))
    f = [x % 5 for x in v[:2]]
    for g, w in zip(wk.masked_window_border(b1, b2, *f, v[2], v[3]),
                    wk.masked_window_border_plain(b1, b2, *f, v[2], v[3])):
        assert torch.equal(g, w)
    wi = t(np.stack([rng.randint(0, 3, (nchunks, W)), rng.rand(nchunks, W) < 0.3],
                    1).astype(np.int32))
    need = t(np.array([3, 0, 1, 2, 0], np.int32))
    rg = rows_i[:, 0].contiguous()
    for g, w in zip(wk.window_1nn(rows_f, rg, wins[0], wi, need),
                    wk.window_1nn_plain(rows_f, rg, wins[0], wi, need)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    after = wk.LAUNCHES
    assert after["neighbor_pack"] == before["neighbor_pack"] + 1
    assert after["masked_window_reduce"] == before["masked_window_reduce"] + 2
    assert after["window_1nn"] == before["window_1nn"] + 1


def test_wrapper_rejects_bad_input(dev):
    rng = np.random.RandomState(1)
    _, rows_f, rows_i, wins = tiles(rng, dev)
    with pytest.raises(TypeError):
        wk.neighbor_pack(0.1, rows_f.double(), rows_i, *wins)
    with pytest.raises(ValueError):
        wk.neighbor_pack(0.1, rows_f[:, :, ::2], rows_i[:, :, ::2], *wins)


def test_cluster_cuda_matches_cpu(dev):
    rng = np.random.RandomState(2)
    blobs = [np.array(c) + rng.randn(400, 3) * 0.01
             for c in ([0, 0, 0], [1, 1, 0.5], [0.5, 0.2, 0.1], [2, 0.5, 0.3])]
    shifted = np.concatenate(blobs + [rng.rand(200, 3) * 2.5]).astype(np.float32)
    orig = (shifted + rng.randn(*shifted.shape) * 0.3).astype(np.float32)
    sem = np.repeat(np.array([2, 2, 3, 3, 2], np.int32), [400, 400, 400, 400, 200])
    batch = np.zeros(len(sem), np.int32)
    valid = np.ones(len(sem), bool)
    kw = dict(radius=0.05, min_pts=10, cluster_cap=16, band=512, chunk=256)
    args = (shifted, orig, sem, batch, valid)
    got = cl.binary_cluster(*(torch.from_numpy(a).to(dev) for a in args),
                            count_mean=torch.from_numpy(COUNT_MEAN).to(dev), **kw)
    want = cl.binary_cluster(*(torch.from_numpy(a) for a in args),
                             count_mean=torch.from_numpy(COUNT_MEAN), **kw)
    for f in want._fields:
        g, w = getattr(got, f).cpu(), getattr(want, f)
        if f == "centers":
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        else:
            assert torch.equal(g, w), f
    assert int(want.num_clusters) > 0
