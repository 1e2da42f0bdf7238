"""The banded-window clustering passes, plain PyTorch (a frozen copy of the
port's plain versions, ``pbnet_torch/ops/window_kernels.py`` ``*_plain``),
under the names the clustering calls.  No CUDA kernel is built or called."""

from __future__ import annotations

import torch

INF_I32 = 2**31 - 1



# ---------------------------------------------------------------------------
# bit-word helpers (plain torch)
# ---------------------------------------------------------------------------
def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., W//32) int32 words holding the uint32 pattern
    (bit b of word w = position 32*w + b)."""
    shp = mask.shape[:-1] + (mask.shape[-1] // 32, 32)
    sh = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (mask.reshape(shp).to(torch.int64) << sh).sum(-1)
    return (words - (words >= 2**31).to(torch.int64) * 2**32).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., NW) int32 words -> (..., NW*32) bool."""
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    u = words.to(torch.int64) & 0xFFFFFFFF
    return (((u[..., None] >> sh) & 1) > 0).reshape(words.shape[:-1] + (-1,))


def sq_dist(rx, ry, rz, cx, cy, cz):
    """Squared distance, unfused and left to right as the JAX package
    evaluates it."""
    dx = rx - cx
    dy = ry - cy
    dz = rz - cz
    return (dx * dx + dy * dy) + dz * dz


# ---------------------------------------------------------------------------
# B1 neighbor_pack
# ---------------------------------------------------------------------------
def neighbor_pack_plain(r2: float, rows_f, rows_i, w1f, w1i, w2f, w2i):
    """Packed neighbor words of both windows + density (plain version).

    rows_f (nchunks, 3, chunk) f32 xyz; rows_i (nchunks, 3, chunk) int32
    (group, valid, global sorted index); w*f (nchunks, 3, W) f32 window xyz;
    w*i (nchunks, 3, W) int32 (group, column valid [window 2: fresh columns
    only], global sorted index).  A bit is set iff ``d2 <= r2``, the groups
    match, the column and the row are valid and the pair is not self.
    Returns (bits1, bits2) (nchunks, chunk, W/32) int32 and density
    (nchunks, chunk) int32 = set bits over both windows.
    """
    r2t = torch.tensor(r2, dtype=torch.float32, device=rows_f.device)
    nchunks = rows_f.shape[0]
    outs = ([], [])
    dens = []
    for c in range(nchunks):
        rx, ry, rz = (rows_f[c, a][:, None] for a in range(3))
        rg, rv, ridx = (rows_i[c, a][:, None] for a in range(3))
        cnt = 0
        for wf, wi, out in ((w1f, w1i, outs[0]), (w2f, w2i, outs[1])):
            d2 = sq_dist(rx, ry, rz, wf[c, 0][None], wf[c, 1][None], wf[c, 2][None])
            m = ((d2 <= r2t) & (rg == wi[c, 0][None]) & (wi[c, 1][None] > 0)
                 & (rv > 0) & (ridx != wi[c, 2][None]))
            cnt = cnt + m.sum(1, dtype=torch.int32)
            out.append(pack_bits(m))
        dens.append(cnt)
    return torch.stack(outs[0]), torch.stack(outs[1]), torch.stack(dens)


# ---------------------------------------------------------------------------
# B2 masked_window_reduce
# ---------------------------------------------------------------------------
def masked_window_reduce_plain(bits1, bits2, vw1, vw2, minimize: bool = True):
    """best[i, r] = min (or max) of {vw*[i, j] : bit j set in bits*[i, r]}
    over both windows; INT32_MAX (min) or -1 (max) where no bit is set."""
    init = INF_I32 if minimize else -1
    out = []
    for c in range(bits1.shape[0]):
        best = None
        for bits, vw in ((bits1, vw1), (bits2, vw2)):
            m = unpack_bits(bits[c])
            cand = torch.where(m, vw[c][None, :], init)
            red = cand.amin(1) if minimize else cand.amax(1)
            best = red if best is None else (
                torch.minimum(best, red) if minimize else torch.maximum(best, red))
        out.append(best)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# B3 masked_window_border
# ---------------------------------------------------------------------------
def masked_window_border_plain(bits1, bits2, fw1, fw2, lw1, lw2):
    """Per row: ``best`` = max first-orig value over the set bits of both
    windows, ``root`` = max label over set bits whose first-orig equals
    ``best``.  Both -1 where no bit is set."""
    bests, roots = [], []
    for c in range(bits1.shape[0]):
        m1, m2 = unpack_bits(bits1[c]), unpack_bits(bits2[c])
        best = torch.maximum(
            torch.where(m1, fw1[c][None], -1).amax(1),
            torch.where(m2, fw2[c][None], -1).amax(1),
        )
        h1 = m1 & (fw1[c][None] == best[:, None])
        h2 = m2 & (fw2[c][None] == best[:, None])
        root = torch.maximum(
            torch.where(h1, lw1[c][None], -1).amax(1),
            torch.where(h2, lw2[c][None], -1).amax(1),
        )
        bests.append(best)
        roots.append(root)
    return torch.stack(bests), torch.stack(roots)


# ---------------------------------------------------------------------------
# B4 window_1nn
# ---------------------------------------------------------------------------
def window_1nn_plain(rows_f, rows_g, need, w1f, w1i, w2f, w2i, anchor, anchor2):
    """Masked nearest candidate per needy row over both windows of its chunk.

    rows_f (nchunks, 3, chunk) f32 query xyz; rows_g (nchunks, chunk) int32
    group; need (nchunks, chunk) bool, the rows that want an answer; w1f,
    w2f (nchunks, 3, W) f32 window xyz; w1i, w2i (nchunks, 2, W) int32
    (group, candidate flag); anchor, anchor2 (nchunks,) int32, the padded
    sorted row of each window's column 0.  Candidates: flag set and the
    row's group.  Order: the least d2, and among ties the LAST column in
    window order (the left window's columns, then the right window's): the
    JAX package's `<=` scan in each window and its right-wins merge of the
    two.  Returns (d2, j) (nchunks, chunk): f32 d2, and int32 j = anchor +
    col or anchor2 + col of the winning column.  A row that is not needy, or
    has no candidate, gets (inf, -1): clustering reads only needy rows.
    """
    nchunks, _, chunk = rows_f.shape
    W = w1f.shape[2]
    dev = rows_f.device
    d2_out = torch.full((nchunks, chunk), float("inf"), device=dev)
    j_out = torch.full((nchunks, chunk), -1, dtype=torch.int32, device=dev)
    order = torch.arange(2 * W, dtype=torch.int32, device=dev)
    for c in range(nchunks):
        rows = need[c].nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        wf = torch.cat([w1f[c], w2f[c]], 1)
        wi = torch.cat([w1i[c], w2i[c]], 1)
        rx, ry, rz = (rows_f[c, a, rows][:, None] for a in range(3))
        d2 = sq_dist(rx, ry, rz, wf[0][None], wf[1][None], wf[2][None])
        ok = (wi[1][None] > 0) & (rows_g[c, rows][:, None] == wi[0][None])
        d2 = torch.where(ok, d2, float("inf"))
        best = d2.amin(1)
        p = torch.where(d2 == best[:, None], order[None], -1).amax(1)
        j = torch.where(p < W, anchor[c] + p, anchor2[c] + (p - W)).to(torch.int32)
        found = torch.isfinite(best)
        d2_out[c, rows] = best
        j_out[c, rows] = torch.where(found, j, -1)
    return d2_out, j_out


neighbor_pack = neighbor_pack_plain
masked_window_reduce = masked_window_reduce_plain
masked_window_border = masked_window_border_plain
window_1nn = window_1nn_plain
