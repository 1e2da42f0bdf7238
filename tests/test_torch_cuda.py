"""The port on the card: each CUDA kernel against its plain version, and the
clustering on CUDA against the CPU path.  Needs a CUDA device (``cuda``
marker; each test skips without one).

The banded conv (B6) is held within 1e-4 of the plain version's largest
output magnitude: both multiply the same bf16-rounded operands in f32, only
the order of the sums differs (tensor cores against a full-f32 matmul,
TF32 off); two launches on the same inputs must equal bit for bit (the slot
split adds its partial tiles in a fixed order).  Every other kernel must
equal its plain version exactly.

This file imports neither JAX nor pbnet_tpu, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX for the parity tests.)
"""

import numpy as np
import pytest
import torch

from pbnet_torch.models.pbnet import COUNT_MEAN
from pbnet_torch.nn import onehot_conv as oc
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


def test_match_pick_matches_plain(dev):
    rng = np.random.RandomState(3)
    t, rows_f, rows_i, wins = tiles(rng, dev)
    b1, b2, _ = wk.neighbor_pack(0.140625, rows_f, rows_i, *wins)
    b1[:, :7] = 0  # empty rows
    b2[:, :7] = 0
    nchunks, chunk, W = b1.shape[0], b1.shape[1], b1.shape[2] * 32
    fw = [t(rng.randint(-1, 5, (nchunks, W)).astype(np.int32)) for _ in range(2)]
    lw = [t(rng.randint(0, 500, (nchunks, W)).astype(np.int32)) for _ in range(2)]
    # targets 9 match no column: no hit
    target = t(rng.randint(-1, 10, (nchunks, chunk)).astype(np.int32))
    before = wk.LAUNCHES["masked_window_match_pick"]
    got = wk.masked_window_match_pick(b1, b2, *fw, *lw, target)
    want = wk.masked_window_match_pick_plain(b1, b2, *fw, *lw, target)
    assert torch.equal(got, want)
    assert wk.LAUNCHES["masked_window_match_pick"] == before + 1
    assert (got[:, :7] == -1).all() and (got >= 0).any()
    best, root = wk.masked_window_border(b1, b2, *fw, *lw)
    assert torch.equal(wk.masked_window_match_pick(b1, b2, *fw, *lw, best), root)


def banded_map(rng, m_out, m_in, K, kz, jitter, present=0.7):
    """Monotone kernel map with key-sorted locality (tests/test_onehot.py)."""
    kmap = np.full((m_out, K), -1, np.int32)
    for g in range(K // kz):
        base = np.clip(np.arange(m_out) * m_in // m_out + rng.randint(-jitter, jitter),
                       0, m_in - kz)
        for k in range(kz):
            mask = rng.rand(m_out) < present
            kmap[mask, g * kz + k] = base[mask] + k
    return kmap


# 320 rows in 64-row plan tiles; the tight spans drop entries (rel == span
# slots)
@pytest.mark.parametrize("K,kz,cin,span", [(27, 3, 64, 192), (27, 3, 96, 48),
                                           (8, 2, 192, 256), (8, 2, 64, 32)])
def test_onehot_conv_matches_plain(dev, K, kz, cin, span):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(cin + span)
    m_out, m_in, cout = 320, 400, 96
    km = torch.from_numpy(banded_map(rng, m_out, m_in, K, kz, 60)).to(dev)
    plan = oc.build_onehot_plan(km, kz, m_in, tm=64, span=span)
    assert (int(plan.overflow) > 0) == (span < 64)
    feats = torch.from_numpy(rng.randn(m_in, cin).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(K, cin, cout) * 0.1).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.rand(m_out) < 0.9).to(dev)
    before = oc.LAUNCHES["onehot_conv"]
    got = oc.onehot_conv(feats, plan, w, valid)
    want = oc.onehot_conv_plain(feats, plan, w, valid)
    torch.cuda.synchronize()
    assert oc.LAUNCHES["onehot_conv"] == before + 1
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))
    with pytest.raises(ValueError):
        oc.onehot_conv(feats, plan, w, valid, torch.float32)


def b6_check(feats, plan, w, valid):
    """One B6 launch against the plain version (1e-4 of the largest plain
    magnitude), exact zeros where valid_out is false, one counted launch,
    and a second launch equal bit for bit."""
    before = oc.LAUNCHES["onehot_conv"]
    got = oc.onehot_conv(feats, plan, w, valid)
    want = oc.onehot_conv_plain(feats, plan, w, valid)
    again = oc.onehot_conv(feats, plan, w, valid)
    torch.cuda.synchronize()
    assert oc.LAUNCHES["onehot_conv"] == before + 2
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got


# sms: the SM count the wrapper plans for (None: the card's).  At these row
# counts the card's count gives 64-row blocks with the slots split across
# blocks; sms=1 gives 128-row blocks with no split, 16 a split in two.
# Cout 45 and 200 take the odd-column and the column-strip edges, Cin 80 a
# zero-padded channel step; span 48 drops entries (overflow > 0).
@pytest.mark.parametrize("sms,m_out,K,kz,cin,cout,span", [
    (None, 256, 27, 3, 64, 64, 192),      # one 256-row tile
    (None, 1536, 8, 2, 64, 64, 512),      # local down L3's rows
    (None, 1536, 27, 3, 128, 96, 192),
    (None, 1536, 27, 3, 192, 128, 192),
    (1, 1536, 27, 3, 128, 128, 192),
    (1, 1536, 27, 3, 96, 96, 48),
    (None, 1536, 27, 3, 64, 96, 48),
    (16, 1536, 8, 2, 192, 64, 256),
    (None, 512, 27, 3, 80, 200, 192),
    (1, 256, 8, 2, 64, 45, 128),
    (1, 320, 27, 3, 96, 96, 192),         # 128-row blocks, the last one ragged
])
def test_onehot_conv_tilings(dev, monkeypatch, sms, m_out, K, kz, cin, cout, span):
    torch.backends.cuda.matmul.allow_tf32 = False
    if sms is not None:
        monkeypatch.setattr(oc, "_sm_count", lambda _: sms)
    rng = np.random.RandomState(m_out + cin + cout + span)
    m_in = max(m_out * 2 if K == 8 else m_out, span + 64)
    km = banded_map(rng, m_out, m_in, K, kz, 60 if span >= 128 else 40)
    km[:128, 4:10] = -1  # slots no row of the first 128-row tile uses
    km[:, K - 1] = -1    # a slot no row uses at all
    tm = 256 if m_out % 256 == 0 else 64
    plan = oc.build_onehot_plan(torch.from_numpy(km).to(dev), kz, m_in, tm=tm, span=span)
    if span < 64:
        assert int(plan.overflow) > 0
    feats = torch.from_numpy(rng.randn(m_in, cin).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(K, cin, cout) * 0.1).astype(np.float32)).to(dev)
    valid = rng.rand(m_out) < 0.9
    valid[64:192] = False  # an all-false 64-row tile (and half a 128-row one)
    valid = torch.from_numpy(valid).to(dev)
    t = oc.tiling(m_out, K, cin, cout, oc._sm_count(dev))
    if sms == 1:
        assert (t.bm, t.nsplit) == (128, 1)
    elif sms == 16:
        assert (t.bm, t.nsplit) == (64, 2)
    else:
        assert t.bm == 64 and t.nsplit > 1
    got = b6_check(feats, plan, w, valid)
    assert float(got.abs().max()) > 0


def test_border_edge_rows(dev):
    """B3 and B5 exact at the bench window W = 4096 (64 KB of staged pairs)
    on all-ones words, all-zero rows, rows whose set columns all have
    first = -1, and ties in first with different labels."""
    rng = np.random.RandomState(4)
    nchunks, chunk, W = 3, 96, 4096
    nw = W // 32
    b = rng.randint(0, 2**32, (2, nchunks, chunk, nw), dtype=np.uint64).astype(np.uint32)
    b[:, :, :, ::3] = 0                         # empty words inside rows
    b[:, :, :8] = 0xFFFFFFFF                    # all-ones rows
    b[:, :, 8:16] = 0                           # empty rows
    fw = rng.randint(0, 3, (2, nchunks, W)).astype(np.int32)  # few values: ties
    lw = rng.randint(0, 1000, (2, nchunks, W)).astype(np.int32)
    fw[:, :, :64] = -1                          # rows 16..23 set only these
    b[:, :, 16:24] = 0
    b[:, :, 16:24, :2] = rng.randint(1, 2**32, (2, nchunks, 8, 2), dtype=np.uint64)
    fw[0, 1, 64:] = 2                           # one first value elsewhere: all ties

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b1, b2 = t(b[0].view(np.int32)), t(b[1].view(np.int32))
    args = (b1, b2, t(fw[0]), t(fw[1]), t(lw[0]), t(lw[1]))
    best, root = wk.masked_window_border(*args)
    want_best, want_root = wk.masked_window_border_plain(*args)
    assert torch.equal(best, want_best) and torch.equal(root, want_root)
    assert (best[:, 8:16] == -1).all() and (root[:, 8:16] == -1).all()
    assert (best[:, 16:24] == -1).all() and (root[:, 16:24] >= 0).all()
    assert (best[:, :8] == 2).all()
    pick = wk.masked_window_match_pick(*args, best)
    assert torch.equal(pick, wk.masked_window_match_pick_plain(*args, best))
    assert torch.equal(pick, root)
