"""The port's four banded-window passes (pbnet_torch/ops/window_kernels.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

The plain PyTorch versions must equal the Pallas kernels EXACTLY: bits,
density, labels and columns, and the 1-NN squared distance bit for bit.
Inputs are made with numpy from a seed; coordinates sit on a 1/8 grid so
that many squared distances equal the radius or each other exactly, which
exercises the `d2 <= r2` boundary and the 1-NN tie rule.  The Pallas side
takes the same data in its bit-lane-major (nchunks, 32, NW) window layout.

The CUDA kernels themselves are compared with these plain versions on the
card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.ops import pallas_kernels as pk
from pbnet_torch.ops import window_kernels as wk


@pytest.fixture
def interpret():
    old = pk.INTERPRET
    pk.INTERPRET = True
    yield
    pk.INTERPRET = old


def lane(x):
    """(..., W) -> (..., 32, NW) bit-lane-major, as the Pallas kernels take it."""
    nw = x.shape[-1] // 32
    return np.swapaxes(x.reshape(x.shape[:-1] + (nw, 32)), -1, -2)


def u32(t):
    return np.asarray(t).astype(np.int32).view(np.uint32)


def rows_and_windows(rng, nchunks=3, chunk=64, W=128, groups=3):
    """Row tiles and two windows over a small cube on a 1/8 grid."""
    npad = nchunks * chunk

    def coords(*shape):
        return (rng.randint(0, 6, shape) / 8.0).astype(np.float32)

    rows_f = coords(nchunks, 3, chunk)
    rows_i = np.stack([
        rng.randint(0, groups, (nchunks, chunk)),
        (rng.rand(nchunks, chunk) < 0.9).astype(np.int64),
        np.arange(npad).reshape(nchunks, chunk),
    ], 1).astype(np.int32)
    wins = []
    for _ in range(2):
        # window source indices overlap the rows, so self pairs occur
        idx = rng.randint(0, npad, (nchunks, W))
        wf = coords(nchunks, 3, W)
        wi = np.stack([
            rng.randint(0, groups, (nchunks, W)),
            (rng.rand(nchunks, W) < 0.8).astype(np.int64),
            idx,
        ], 1).astype(np.int32)
        # plant exact self pairs: a row's own index with its own coords
        for c in range(nchunks):
            for j in rng.choice(W, 8, replace=False):
                r = rng.randint(chunk)
                wf[c, :, j] = rows_f[c, :, r]
                wi[c, 0, j] = rows_i[c, 0, r]
                wi[c, 2, j] = rows_i[c, 2, r]
        wins.append((wf, wi))
    return rows_f, rows_i, wins


def invalid_on_rows(rng, rows_f, rows_i, wf, wi, n=6):
    """Make n columns per chunk invalid copies of a valid row: its coords
    and group, another index.  Returns the (chunk, row, column) triples."""
    hits = []
    for c in range(rows_f.shape[0]):
        for j in rng.choice(wf.shape[2], n, replace=False):
            r = rng.choice(np.nonzero(rows_i[c, 1])[0])
            wf[c, :, j] = rows_f[c, :, r]
            wi[c, 0, j] = rows_i[c, 0, r]
            wi[c, 1, j] = 0
            wi[c, 2, j] = -7
            hits.append((c, r, j))
    return hits


# edge cases the CUDA design relies on (an invalid column or row never sets
# a bit, whatever its coordinates):
#   w2_prefix       window 2 valid only on a suffix, as ops/cluster.py's
#                   `fresh2` makes it (prefix lengths 0, 32, 96 and W)
#   invalid_on_row  invalid columns on a valid row's own coords and group
#   w2_invalid      an all-invalid window 2
@pytest.mark.parametrize("r2,case", [
    pytest.param(0.0625, None, id="0.0625"),
    pytest.param(0.140625, None, id="0.140625"),
    pytest.param(0.140625, "w2_prefix", id="w2_prefix"),
    pytest.param(0.140625, "invalid_on_row", id="invalid_on_row"),
    pytest.param(0.140625, "w2_invalid", id="w2_invalid"),
])
def test_neighbor_pack_matches_pallas(rng, interpret, r2, case):
    rows_f, rows_i, ((w1f, w1i), (w2f, w2i)) = rows_and_windows(rng, nchunks=4)
    hits = []
    if case == "w2_prefix":
        for c, p in enumerate((0, 32, 96, w2i.shape[2])):
            w2i[c, 1, :p] = 0
    elif case == "invalid_on_row":
        hits = invalid_on_rows(rng, rows_f, rows_i, w1f, w1i)
        hits2 = invalid_on_rows(rng, rows_f, rows_i, w2f, w2i)
    elif case == "w2_invalid":
        w2i[:, 1] = 0
    b1, b2, dens = pk.neighbor_pack(
        jnp.float32(r2), jnp.asarray(rows_f), jnp.asarray(rows_i),
        jnp.asarray(lane(w1f)), jnp.asarray(lane(w1i)),
        jnp.asarray(lane(w2f)), jnp.asarray(lane(w2i)))
    t = torch.from_numpy
    g1, g2, gd = wk.neighbor_pack(r2, t(rows_f), t(rows_i), t(w1f), t(w1i), t(w2f), t(w2i))
    np.testing.assert_array_equal(u32(g1), np.asarray(b1))
    np.testing.assert_array_equal(u32(g2), np.asarray(b2))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(dens))
    assert gd.sum() > 0 and (gd == 0).any()  # both full and empty rows
    if case in ("w2_prefix", "w2_invalid"):
        m2 = wk.unpack_bits(g2).numpy()
        assert not m2[3].any() and (m2.any() == (case == "w2_prefix"))
        if case == "w2_prefix":
            assert not m2[1, :, :32].any() and not m2[2, :, :96].any()
    if case == "invalid_on_row":
        for g, hs in ((g1, hits), (g2, hits2)):
            m = wk.unpack_bits(g).numpy()
            assert not any(m[c, r, j] for c, r, j in hs)


def random_bits(rng, nchunks=3, chunk=64, nw=4):
    """int32 words holding random uint32 patterns; many rows/words empty."""
    b = rng.randint(0, 2**32, (2, nchunks, chunk, nw), dtype=np.uint64).astype(np.uint32)
    b[0][rng.rand(nchunks, chunk, nw) < 0.5] = 0
    b[1][rng.rand(nchunks, chunk, nw) < 0.8] = 0
    b[:, :, :5] = 0  # whole empty rows
    return b[0], b[1]


# all_ones: all-ones words (every column set) in a third of the rows;
# identity: values at the identities INT32_MAX and -1 (rows 10..19 set only
# such columns, so their result is the identity or the other extreme)
@pytest.mark.parametrize("minimize,case", [
    pytest.param(True, None, id="True"),
    pytest.param(False, None, id="False"),
    pytest.param(True, "all_ones", id="all_ones-min"),
    pytest.param(False, "all_ones", id="all_ones-max"),
    pytest.param(True, "identity", id="identity-min"),
    pytest.param(False, "identity", id="identity-max"),
])
def test_masked_window_reduce_matches_pallas(rng, interpret, minimize, case):
    b1, b2 = random_bits(rng)
    w = b1.shape[2] * 32
    vw1 = rng.randint(-1, 10_000, (b1.shape[0], w)).astype(np.int32)
    vw2 = rng.randint(-1, 10_000, (b1.shape[0], w)).astype(np.int32)
    if case == "all_ones":
        b1[:, ::3] = 0xFFFFFFFF
        b2[:, 1::3] = 0xFFFFFFFF
    elif case == "identity":
        for vw in (vw1, vw2):
            vw[:, ::4] = 2**31 - 1
            vw[:, 1::4] = -1
        for b in (b1, b2):  # set only columns 32w + {0, 1, 4, 5}
            b[:, 10:20] &= np.uint32(0x33)
    want = pk.masked_window_reduce(jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(vw1),
                                   jnp.asarray(vw2), minimize=minimize)
    t = torch.from_numpy
    got = wk.masked_window_reduce(t(b1.view(np.int32)), t(b2.view(np.int32)),
                                  t(vw1), t(vw2), minimize=minimize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("label_of_first", [True, False])
def test_masked_window_border_matches_pallas(rng, interpret, label_of_first):
    b1, b2 = random_bits(rng)
    nchunks, w = b1.shape[0], b1.shape[2] * 32
    # few distinct first-orig values (incl. -1) -> real multi-hit matches
    fw1 = rng.randint(-1, 6, (nchunks, w)).astype(np.int32)
    fw2 = rng.randint(-1, 6, (nchunks, w)).astype(np.int32)
    if label_of_first:  # the pipeline invariant: label is a function of first
        lw1, lw2 = fw1 * 3 + 1, fw2 * 3 + 1
    else:
        lw1 = rng.randint(0, 500, (nchunks, w)).astype(np.int32)
        lw2 = rng.randint(0, 500, (nchunks, w)).astype(np.int32)
    best, root = pk.masked_window_border(*(jnp.asarray(a) for a in (b1, b2, fw1, fw2, lw1, lw2)))
    t = torch.from_numpy
    gb, gr = wk.masked_window_border(t(b1.view(np.int32)), t(b2.view(np.int32)),
                                     t(fw1), t(fw2), t(lw1), t(lw2))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(best))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(root))


def test_window_1nn_matches_pallas(rng, interpret):
    nchunks, chunk, W = 4, 64, 128
    rows_f = (rng.randint(0, 6, (nchunks, 3, chunk)) / 8.0).astype(np.float32)
    rows_g = rng.randint(0, 4, (nchunks, chunk)).astype(np.int32)
    rows_g[:, :3] = 9  # a group no candidate has: empty rows -> (inf, W-1)
    wf = (rng.randint(0, 6, (nchunks, 3, W)) / 8.0).astype(np.float32)
    wi = np.stack([rng.randint(0, 4, (nchunks, W)),
                   (rng.rand(nchunks, W) < 0.3).astype(np.int64)], 1).astype(np.int32)
    need = np.array([5, 0, 1, 0], np.int32)  # chunks 1 and 3 skip: (inf, -1)

    wi3 = np.concatenate([wi, wi[:, :1]], 1)  # Pallas takes (group, cand, unused)
    rows_i3 = np.stack([rows_g] * 3, 1)
    d2, col = pk.window_1nn(jnp.asarray(rows_f), jnp.asarray(rows_i3),
                            jnp.asarray(lane(wf)), jnp.asarray(lane(wi3)),
                            need=jnp.asarray(need))
    t = torch.from_numpy
    gd, gc = wk.window_1nn(t(rows_f), t(rows_g), t(wf), t(wi), t(need))
    np.testing.assert_array_equal(gd.numpy().view(np.int32), np.asarray(d2).view(np.int32))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(col))
    assert (gc.numpy()[[1, 3]] == -1).all()
    assert (gc.numpy()[0, :3] == W - 1).all() and np.isinf(gd.numpy()[0, :3]).all()


def test_pack_unpack_roundtrip(rng):
    m = rng.rand(5, 7, 96) < 0.5
    words = wk.pack_bits(torch.from_numpy(m))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(wk.unpack_bits(words).numpy(), m)
    ref = (m.reshape(5, 7, 3, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    np.testing.assert_array_equal(u32(words), ref.astype(np.uint32))


@pytest.mark.parametrize("label_of_first", [True, False])
def test_masked_window_match_pick_matches_pallas(rng, interpret, label_of_first):
    b1, b2 = random_bits(rng)
    nchunks, chunk, w = b1.shape[0], b1.shape[1], b1.shape[2] * 32
    fw1 = rng.randint(-1, 6, (nchunks, w)).astype(np.int32)
    fw2 = rng.randint(-1, 6, (nchunks, w)).astype(np.int32)
    if label_of_first:
        lw1, lw2 = fw1 * 3 + 1, fw2 * 3 + 1
    else:
        lw1 = rng.randint(0, 500, (nchunks, w)).astype(np.int32)
        lw2 = rng.randint(0, 500, (nchunks, w)).astype(np.int32)
    # targets: hits, values no column holds (7: no hit), and -1
    target = rng.randint(-1, 8, (nchunks, chunk)).astype(np.int32)
    want = pk.masked_window_match_pick(*(jnp.asarray(a) for a in (b1, b2, fw1, fw2, lw1, lw2,
                                                                  target)))
    t = torch.from_numpy
    got = wk.masked_window_match_pick(t(b1.view(np.int32)), t(b2.view(np.int32)), t(fw1),
                                      t(fw2), t(lw1), t(lw2), t(target))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()


def test_border_is_reduce_max_then_match_pick(rng):
    """masked_window_border == masked_window_reduce(max) + match_pick of
    its result, whatever the labels (tests/test_cluster.py pins the same
    identity for the Pallas kernels under the pipeline invariant)."""
    b1, b2 = (torch.from_numpy(b.view(np.int32)) for b in random_bits(rng))
    nchunks, w = b1.shape[0], b1.shape[2] * 32
    fw1, fw2 = (torch.from_numpy(rng.randint(-1, 6, (nchunks, w)).astype(np.int32))
                for _ in range(2))
    lw1, lw2 = (torch.from_numpy(rng.randint(0, 500, (nchunks, w)).astype(np.int32))
                for _ in range(2))
    best, root = wk.masked_window_border(b1, b2, fw1, fw2, lw1, lw2)
    assert torch.equal(best, wk.masked_window_reduce(b1, b2, fw1, fw2, minimize=False))
    assert torch.equal(root, wk.masked_window_match_pick(b1, b2, fw1, fw2, lw1, lw2, best))


@pytest.mark.parametrize("case", ["all_ones", "first_minus1"])
def test_masked_window_border_edge_rows_match_pallas(rng, interpret, case):
    """The rows the one-pass CUDA design (a lexicographic max of (first,
    label)) must get right, plain version against Pallas: all-ones words
    (every column set, many ties in first), and rows whose set columns all
    have first = -1 (best -1, root the max label among them)."""
    b1, b2 = random_bits(rng)
    nchunks, w = b1.shape[0], b1.shape[2] * 32
    fw1, fw2 = (rng.randint(0, 3, (nchunks, w)).astype(np.int32) for _ in range(2))
    lw1, lw2 = (rng.randint(0, 500, (nchunks, w)).astype(np.int32) for _ in range(2))
    if case == "all_ones":
        b1[:, :16] = 0xFFFFFFFF
        b2[:, :16] = 0xFFFFFFFF
        b1[:, 16:32] = 0xFFFFFFFF  # one window full, the other random
    else:
        fw1[:, :32] = -1
        fw2[:, :32] = -1
        for b in (b1, b2):
            b[:, :16] = 0
            b[:, :16, 0] = rng.randint(1, 2**32, (nchunks, 16), dtype=np.uint64)
    best, root = pk.masked_window_border(*(jnp.asarray(a) for a in (b1, b2, fw1, fw2, lw1, lw2)))
    t = torch.from_numpy
    gb, gr = wk.masked_window_border(t(b1.view(np.int32)), t(b2.view(np.int32)),
                                     t(fw1), t(fw2), t(lw1), t(lw2))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(best))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(root))
    if case == "all_ones":
        assert (gb.numpy()[:, :16] == 2).all()
    else:
        assert (gb.numpy()[:, :16] == -1).all() and (gr.numpy()[:, :16] >= 0).all()
