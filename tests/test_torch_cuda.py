"""The port on the card: each CUDA kernel against its plain version, and the
clustering on CUDA against the CPU path.  Needs a CUDA device (``cuda``
marker; each test skips without one).

The banded conv (B6) is held within 1e-4 of the plain version's largest
output magnitude: both multiply the same bf16-rounded operands in f32, only
the order of the sums differs (tensor cores against a full-f32 matmul,
TF32 off); two launches on the same inputs must equal bit for bit (the slot
split adds its partial tiles in a fixed order).  Every other kernel must
equal its plain version exactly.

The data path on the card: ``vertex_normals`` within 1e-6 of the CPU's,
and ``engine.evaluate`` over decoded ScanNet-layout scenes (colour-oracle
weights, the Mini_Unet trio at small caps) equal to the CPU's: mIoU, mAcc,
allAcc and per-scene proposal counts exactly, the AP keys within 1e-6.

Training on the card: the gather conv's backward (the transposed-map gather
and its GEMMs) and train-mode BN against the same code on the CPU, within
1e-3 of each gradient's largest magnitude (the index backwards on the card
add with atomics, in another order), and a banding plan refused where a
gradient is wanted.

This file imports neither JAX nor pbnet_tpu, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX for the parity tests.)
"""

import os

import numpy as np
import pytest
import torch

from pbnet_torch import engine, synthetic
from pbnet_torch.config import Config, StaticShapes
from pbnet_torch.data import decode_scannet
from pbnet_torch.data.dataset import Dataset
from pbnet_torch.models.pbnet import COUNT_MEAN
from pbnet_torch.nn import modules as nm
from pbnet_torch.nn import onehot_conv as oc
from pbnet_torch.nn import sparse_ops as so
from pbnet_torch.ops import cluster as cl
from pbnet_torch.ops import normals
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


def np_tiles(rng, nchunks, chunk, W):
    """numpy rows and windows on a 1/8 grid, as :func:`tiles` makes them."""
    rows_f = (rng.randint(0, 6, (nchunks, 3, chunk)) / 8.0).astype(np.float32)
    rows_i = np.stack([rng.randint(0, 3, (nchunks, chunk)), rng.rand(nchunks, chunk) < 0.9,
                       np.arange(nchunks * chunk).reshape(nchunks, chunk)], 1).astype(np.int32)
    wins = []
    for _ in range(2):
        wins.append((rng.randint(0, 6, (nchunks, 3, W)) / 8.0).astype(np.float32))
        wins.append(np.stack([rng.randint(0, 3, (nchunks, W)), rng.rand(nchunks, W) < 0.8,
                              rng.randint(0, nchunks * chunk, (nchunks, W))],
                             1).astype(np.int32))
    return rows_f, rows_i, wins


# B1 skips words with no valid column and blocks with no valid row, and
# folds validity into the distance test (NaN x).  chunk 300 leaves a ragged
# last 128-row block, W 2080 a partial 1024-column tile; (1024, 4096) is the
# bench tile.  Window-2 prefixes are invalid, as ops/cluster.py's `fresh2`
# makes them.
@pytest.mark.parametrize("case,nchunks,chunk,W,prefixes", [
    ("w2_prefix", 6, 300, 2080, (0, 32, 1024, 1056, 2048, 2080)),
    ("w2_invalid", 3, 300, 2080, (2080,) * 3),
    ("rows_invalid", 3, 300, 2080, (0, 0, 0)),
    ("invalid_on_row", 3, 300, 2080, (0, 0, 0)),
    ("bench_tile", 2, 1024, 4096, (3040, 4064)),
])
def test_neighbor_pack_edges(dev, case, nchunks, chunk, W, prefixes):
    rng = np.random.RandomState(W + len(case))
    rows_f, rows_i, wins = np_tiles(rng, nchunks, chunk, W)
    for c, p in enumerate(prefixes):
        wins[3][c, 1, :p] = 0
    hits = []
    if case == "rows_invalid":
        rows_i[0, 1] = 0          # a chunk with no valid row
        rows_i[1, 1, 128:256] = 0  # one whole 128-row block
    elif case == "invalid_on_row":
        # invalid columns on a valid row's coords, in its group: bit stays 0
        for c in range(nchunks):
            for wf, wi in (wins[0:2], wins[2:4]):
                for j in rng.choice(W, 16, replace=False):
                    r = rng.choice(np.nonzero(rows_i[c, 1])[0])
                    wf[c, :, j] = rows_f[c, :, r]
                    wi[c, 0, j] = rows_i[c, 0, r]
                    wi[c, 1, j] = 0
                    wi[c, 2, j] = -7
                    hits.append((wi is wins[3], c, r, j))
    elif case == "bench_tile":
        rows_i[-1, 1, 704:] = 0   # the bench's padding rows
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (t(rows_f), t(rows_i), *(t(w) for w in wins))
    before = wk.LAUNCHES["neighbor_pack"]
    got = wk.neighbor_pack(0.140625, *args)
    want = wk.neighbor_pack_plain(0.140625, *args)
    assert wk.LAUNCHES["neighbor_pack"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) > 0
    m = [wk.unpack_bits(b).cpu().numpy() for b in got[:2]]
    for c, p in enumerate(prefixes):
        assert not m[1][c, :, :p].any()
    if case == "rows_invalid":
        assert not m[0][0].any() and not m[0][1, 128:256].any()
        assert int(got[2][0].abs().sum()) == 0
    for win2, c, r, j in hits:
        assert not m[win2][c, r, j]


# B2 (both modes) at the bench window W = 4096 with a ragged last block:
# all-ones words and all-zero rows; values at the identities INT32_MAX and
# -1 (rows 40..59 set only such columns); a window 2 of zero words
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("case", ["ones_zero", "identity", "w2_zero"])
def test_masked_window_reduce_edges(dev, case, minimize):
    nchunks, chunk, W = 3, 300, 4096
    rng = np.random.RandomState(5)
    b = rng.randint(0, 2**32, (2, nchunks, chunk, W // 32), dtype=np.uint64).astype(np.uint32)
    b[rng.rand(*b.shape) < 0.5] = 0
    b[:, :, :, ::3] = 0
    v = rng.randint(-1, 10_000, (2, nchunks, W)).astype(np.int32)
    if case == "ones_zero":
        b[:, :, :16] = 0xFFFFFFFF
        b[:, :, 16:40] = 0
    elif case == "identity":
        low = (np.arange(W) % 32) < 8  # bit positions 0..7 of every word
        v[:, :, low & (np.arange(W) % 2 == 0)] = 2**31 - 1
        v[:, :, low & (np.arange(W) % 2 == 1)] = -1
        b[:, :, 40:60] &= np.uint32(0xFF)
    else:
        b[1] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (t(b[0].view(np.int32)), t(b[1].view(np.int32)), t(v[0]), t(v[1]))
    before = wk.LAUNCHES["masked_window_reduce"]
    got = wk.masked_window_reduce(*args, minimize)
    assert torch.equal(got, wk.masked_window_reduce_plain(*args, minimize))
    assert wk.LAUNCHES["masked_window_reduce"] == before + 1
    ident = 2**31 - 1 if minimize else -1
    if case == "ones_zero":
        assert (got[:, 16:40] == ident).all()
        full = v.min((0, 2)) if minimize else v.max((0, 2))  # every column set
        assert (got[:, :16] == t(full)[:, None]).all()
    elif case == "identity":
        assert ((got[:, 40:60] == -1) | (got[:, 40:60] == 2**31 - 1)).all()


def grad_close(got, want):
    got, want = got.detach().cpu(), want.detach().cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("kind", ["k3", "down", "up"])
def test_conv_backward_matches_cpu(dev, kind):
    """The transposed-map backward on the card against the CPU plain
    autograd (a scatter-add) on maps with -1 entries and padding rows, with
    f32 operands; with bf16 operands against the same backward on the CPU
    (the plain autograd rounds dx to bf16 where this backward rounds dy)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(len(kind))
    m_fine, m_coarse = 600, 200
    K = 27 if kind == "k3" else 8
    m_in, m_out = {"k3": (m_fine, m_fine), "down": (m_fine, m_coarse),
                   "up": (m_coarse, m_fine)}[kind]
    km = banded_map(rng, m_out, m_in, K, 3 if K == 27 else 2, 30)
    for k in range(K):  # a kernel map reads each input at most once per offset
        _, first = np.unique(km[:, k], return_index=True)
        dup = np.ones(m_out, bool)
        dup[first] = False
        km[dup, k] = -1
    # the transpose: kb[j, k] is the output row reading input j at offset k
    kb = np.full((m_in, K), -1, np.int32)
    rows, cols = np.nonzero(km >= 0)
    kb[km[rows, cols], cols] = rows
    valid = rng.rand(m_out) < 0.9
    feats = rng.randn(m_in, 32).astype(np.float32)
    w = rng.randn(K, 32, 48).astype(np.float32)
    dy = rng.randn(m_out, 48).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        old = so.COMPUTE_DTYPE
        so.COMPUTE_DTYPE = dtype
        try:
            out = []
            for device, bwd in ((dev, kb), ("cpu", None if dtype == torch.float32 else kb)):
                f = torch.from_numpy(feats).to(device).requires_grad_(True)
                ww = torch.from_numpy(w).to(device).requires_grad_(True)
                t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
                y = so.gather_conv(f, t(km), ww, t(valid),
                                   kmap_bwd=None if bwd is None else t(bwd))
                y.backward(t(dy))
                out.append((y, f.grad, ww.grad))
        finally:
            so.COMPUTE_DTYPE = old
        for g, c in zip(*out):
            grad_close(g, c)


def test_batchnorm_train_matches_cpu(dev):
    rng = np.random.RandomState(9)
    feats = rng.randn(5000, 64).astype(np.float32) * 3 + 1
    valid = rng.rand(5000) < 0.8
    r = rng.randn(5000, 64).astype(np.float32)
    outs = []
    for device in (dev, "cpu"):
        bn = nm.MaskedBatchNorm(64, device=device).train()
        x = torch.from_numpy(feats).to(device).requires_grad_(True)
        y = bn(x, torch.from_numpy(valid).to(device))
        (y * torch.from_numpy(r).to(device)).sum().backward()
        outs.append((y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var))
    for g, c in zip(*outs):
        grad_close(g, c)


def test_plan_refused_under_grad(dev):
    rng = np.random.RandomState(6)
    km = torch.from_numpy(banded_map(rng, 256, 256, 27, 3, 20)).to(dev)
    plan = oc.build_onehot_plan(km, 3, 256, tm=64, span=128)
    feats = torch.from_numpy(rng.randn(256, 64).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(27, 64, 32).astype(np.float32)).to(dev).requires_grad_(True)
    valid = torch.ones(256, dtype=torch.bool, device=dev)
    before = oc.LAUNCHES["onehot_conv"]
    with pytest.raises(RuntimeError, match="no backward"):
        so.gather_conv(feats, km, w, valid, plan=plan)
    assert oc.LAUNCHES["onehot_conv"] == before
    with torch.no_grad():
        so.gather_conv(feats, km, w, valid, plan=plan)
    assert oc.LAUNCHES["onehot_conv"] == before + 1


def test_vertex_normals_match_cpu(dev):
    rng = np.random.RandomState(7)
    a, b = np.meshgrid(np.arange(40), np.arange(30), indexing="ij")
    xyz = np.stack([a.ravel() * 0.01, b.ravel() * 0.01,
                    0.05 * np.sin(a.ravel() * 0.3)], 1).astype(np.float32)
    xyz += rng.randn(*xyz.shape).astype(np.float32) * 1e-3
    q = (a[:-1, :-1] * 30 + b[:-1, :-1]).ravel()
    faces = np.concatenate([np.stack([q, q + 30, q + 1], 1), np.stack([q + 1, q + 30, q + 31], 1)])
    x, f = torch.from_numpy(xyz), torch.from_numpy(faces)
    want = normals.vertex_normals(x, f)
    got = normals.vertex_normals(x.to(dev), f.to(dev))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(want.numpy(), normals.vertex_normals_np(xyz, faces), rtol=0,
                               atol=1e-6)


def test_evaluate_on_card_equals_cpu(dev, tmp_path):
    root = str(tmp_path)
    scans, npy = os.path.join(root, "scans"), os.path.join(root, "npy")
    os.makedirs(npy)
    names = ["scene0000_00", "scene0001_00"]
    for i, name in enumerate(names):
        synthetic.write_scannet_scene(scans, name, np.random.RandomState(i), 3000 + 600 * i,
                                      n_objects=1, wall_height=0.1, object_labels=(3,))
        decode_scannet.decode_scene(os.path.join(scans, name + "_vh_clean_2.ply"), npy, None)
    with open(os.path.join(root, "scannetv2_val.txt"), "w") as fh:
        fh.write("".join(n + "\n" for n in names))
    decode_scannet.write_val_gt(npy, names, os.path.join(root, "val_gt"))
    shapes = StaticShapes(point_cap=12288, voxel_caps=(4096, 2048), cluster_cap=16,
                          local_point_cap=16384, local_voxel_caps=(6144, 3072),
                          score_voxel_caps=(6144, 3072), instance_cap=16, cluster_band=2048)
    cfg = Config(shapes=shapes, data_root=root, num_works=0, eval_bucket_scales=(1.0,),
                 cluster_epoch=-1, backbone_arch="Mini_Unet", dunet_arch="Mini_Unet",
                 score_arch="Mini_Unet")
    model = engine.build_model(cfg, "cpu")
    synthetic.color_oracle(model, 2)  # NYU40 'cabinet', every object's class
    out = {}
    for d in ("cpu", dev):
        m = engine.build_model(cfg, d)
        m.load_state_dict(model.state_dict())
        timing = {}
        res = engine.evaluate(cfg, m, Dataset(cfg), epoch=1, timing=timing)
        out[str(d)] = (res, [r["proposals"] for r in timing["per_scene"]])
    (rg, pg), (rc, pc) = out[str(dev)], out["cpu"]
    assert pg == pc and sum(pc) > 0
    assert rg.keys() == rc.keys() and "mAP" in rc
    for k in rc:
        if k in ("mIoU", "mAcc", "allAcc"):
            assert rg[k] == rc[k], k
        else:
            assert abs(rg[k] - rc[k]) <= 1e-6, k
