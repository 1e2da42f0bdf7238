"""Point-wise binarization + semantic-constrained clustering (port of
pbnet_tpu/ops/cluster.py).

The algorithm, step for step as the JAX package runs it:

1. sort points by (group, l1 norm of the shifted coords); group = sem*64+batch
2. exact per-row window bounds [lb, ub) (|l1_i - l1_j| <= 2r for neighbors)
3. per chunk of rows, TWO 32-aligned windows of W sorted columns (left
   anchored at the first row's lb, right ending at the last row's ub); rows
   whose own window escapes their union are counted in ``band_overflow``
4. neighbor bits + density over both windows           (kernel B1)
5. same-cell pre-merge of high-density points (HPs), then min-label
   propagation over HP-HP edges, one banded pass (B2) + four pointer jumps
   per round, until a fixpoint or ``prop_iters`` rounds
6. border points adopt the component with the largest first original index
   among their HP neighbors                           (kernel B3)
7. clusters ordered by (group, first original index); small ones demoted
8. unassigned points take the cluster of the nearest assigned same-group
   point on ORIGINAL coords: one banded pass over both windows (B4) proves
   most rows, a compacted exact pass (cap ``nn_exact_cap``, overflow in
   ``nn_overflow``) settles the rest
9. per-cluster mean of shifted coords

Every sort is stable and lexicographic (an exact composite int64 key, or
successive stable sorts), every float expression keeps the JAX package's
order, so all integer outputs equal the JAX package's; ``centers`` come from
a float segment sum and agree within a tolerance.  On CUDA tensors the four
banded passes run the CUDA kernels of ``window_kernels``; on CPU tensors
their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import window_kernels as wk

INF_I32 = 2**31 - 1
# elements of one row block of the exact 1-NN pass (2**26 f32: 256 MiB)
EXACT_BLOCK_ELEMS = 2**26


class ClusterResult(NamedTuple):
    cluster_id: torch.Tensor  # (N,) int32, -1 = unassigned
    num_clusters: torch.Tensor  # () int32
    density: torch.Tensor  # (N,) int32, neighbor count excluding self
    centers: torch.Tensor  # (C, 3) f32 mean of shifted coords per cluster
    cluster_sem: torch.Tensor  # (C,) int32
    cluster_batch: torch.Tensor  # (C,) int32
    cluster_size: torch.Tensor  # (C,) int32
    cluster_valid: torch.Tensor  # (C,) bool
    band_overflow: torch.Tensor  # () int32 rows whose true window exceeded band
    nn_overflow: torch.Tensor  # () int32 rows past the exact-1NN cap
    prop_rounds: torch.Tensor  # () int32 label-propagation rounds run


def _f32_order(x: torch.Tensor) -> torch.Tensor:
    """int64 key ordering like the f32 values (no NaN, no -0.0 here)."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _pair_key(g: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """Exact int64 key of the lexicographic (int32 group, f32 l1) pair."""
    return g.to(torch.int64) * (2**32) + (_f32_order(l1) + 2**31)


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort, most significant key first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _f32(v: float, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


def _i32(v, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=dev)


def binary_cluster(
    shifted: torch.Tensor,  # (N, 3) f32 offset-shifted coords
    orig: torch.Tensor,  # (N, 3) f32 original coords
    sem: torch.Tensor,  # (N,) int32 semantic class
    batch: torch.Tensor,  # (N,) int32 batch item (< 64)
    valid: torch.Tensor,  # (N,) bool
    radius: float,
    min_pts: int,
    count_mean: torch.Tensor,  # (sem_num,) f32 per-class mean point counts
    para_f: float = 0.05,
    cluster_cap: int = 384,
    band: int = 4096,
    chunk: int = 1024,
    prop_iters: int = 10,
    nn_exact_cap: int | None = None,
) -> ClusterResult:
    if chunk % 32:
        raise ValueError(f"chunk must be a multiple of 32, got {chunk}")
    dev = shifted.device
    shifted, orig = shifted.detach(), orig.detach()
    n = shifted.shape[0]
    inf = float("inf")
    group = sem.to(torch.int32) * 64 + batch.to(torch.int32)

    # ---- (group, l1) sort; l1 summed in the JAX package's order ----
    a = shifted.abs()
    l1 = (a[:, 0] + a[:, 1]) + a[:, 2]
    g_key = torch.where(valid, group, INF_I32)
    l1k = torch.where(valid, l1, inf)
    perm = torch.sort(_pair_key(g_key, l1k), stable=True).indices
    g_s, l1_s = g_key[perm], l1k[perm]
    pos = shifted[perm]
    valid_s = valid[perm]
    r2 = float(np.float32(radius * radius))

    # ---- exact window bounds: searchsorted on the (group, l1) pairs ----
    keys = _pair_key(g_s, l1_s)
    two_r = _f32(2 * radius, dev)
    lb = torch.searchsorted(keys, _pair_key(g_s, l1_s - two_r), side="left")
    ub = torch.searchsorted(keys, _pair_key(g_s, l1_s + two_r), side="right")

    nchunks = (n + chunk - 1) // chunk
    npad = nchunks * chunk
    W = min(((min(band, npad) + 31) // 32) * 32, npad)

    c_start = torch.arange(nchunks, device=dev) * chunk
    lb_c = lb[c_start]
    ub_c = ub[torch.clamp(c_start + chunk - 1, max=n - 1)]
    hi = max(npad - W, 0)
    anchor = torch.div(torch.clamp(lb_c, 0, hi), 32, rounding_mode="floor") * 32
    anchor2 = torch.clamp(
        torch.maximum(torch.div(ub_c - W + 31, 32, rounding_mode="floor") * 32, anchor),
        max=hi,
    )
    a1r = anchor.repeat_interleave(chunk)[:n]
    a2r = anchor2.repeat_interleave(chunk)[:n]
    contiguous = a2r <= a1r + W
    row_covered = (
        (contiguous & (lb >= a1r) & (ub <= a2r + W))
        | ((lb >= a1r) & (ub <= a1r + W))
        | ((lb >= a2r) & (ub <= a2r + W))
    )
    band_overflow = (valid_s & ~row_covered).sum(dtype=torch.int32)

    def pad_to(x, fill):
        return torch.cat([x, torch.full((npad - n,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=dev)])

    pos_p = pad_to(pos, 0.0)
    g_p = pad_to(g_s, INF_I32)
    valid_p = pad_to(valid_s, False)
    ar_w = torch.arange(W, device=dev)
    w_idx = anchor[:, None] + ar_w[None, :]  # (nchunks, W) sorted rows
    w_idx2 = anchor2[:, None] + ar_w[None, :]
    # the right window contributes only columns NOT already in the left one
    fresh2 = w_idx2 >= anchor[:, None] + W
    windows = ((w_idx, None), (w_idx2, fresh2))

    rg = g_p.reshape(nchunks, chunk)
    rows_idx = torch.arange(npad, dtype=torch.int32, device=dev).reshape(nchunks, chunk)

    def rows3(p):
        return p.reshape(nchunks, chunk, 3).permute(0, 2, 1).contiguous()

    def wplanes(p, idx):
        return p[idx].permute(0, 2, 1).contiguous()  # (nchunks, 3, W)

    # ---- B1: neighbor bits + density ----
    rows_i = torch.stack([rg, valid_p.reshape(nchunks, chunk).to(torch.int32), rows_idx], 1)
    planes = []
    for idx, extra in windows:
        cv = valid_p[idx] if extra is None else valid_p[idx] & extra
        planes += [wplanes(pos_p, idx),
                   torch.stack([g_p[idx], cv.to(torch.int32), idx.to(torch.int32)], 1)]
    bits1, bits2, dens = wk.neighbor_pack(r2, rows3(pos_p), rows_i, *planes)
    density_s = dens.reshape(npad)[:n]
    hp_s = (density_s >= min_pts) & valid_s
    hp_p = pad_to(hp_s, False)
    # propagation and border passes only look at HP neighbors
    bits_hp = tuple(b & wk.pack_bits(hp_p[idx])[:, None, :]
                    for b, (idx, _) in zip((bits1, bits2), windows))
    hp_r = hp_p.reshape(nchunks, chunk)

    # ---- same-cell pre-merge: points of one (group, cell) with cell side
    # r/sqrt(3) are direct neighbors, so same-cell HPs union up front ----
    inv_g = _f32(float(np.float32(np.sqrt(3.0) / radius)), dev)
    cell = torch.floor(pos * inv_g).to(torch.int32)
    k0 = torch.where(valid_s & hp_s, g_s, INF_I32)
    cperm = _lexsort(k0, cell[:, 0], cell[:, 1], cell[:, 2])
    ks = (k0[cperm], cell[cperm, 0], cell[cperm, 1], cell[cperm, 2])
    bnd = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in ks:
        bnd |= k != torch.roll(k, 1)
    bnd[0] = True
    cseg = torch.cumsum(bnd.to(torch.int64), 0) - 1
    sidx = torch.arange(n, dtype=torch.int32, device=dev)
    init_raw = torch.where(hp_s, sidx, INF_I32)
    cell_min = torch.full((n,), INF_I32, dtype=torch.int32, device=dev).scatter_reduce(
        0, cseg, init_raw[cperm], "amin", include_self=True)
    premerged = torch.full((n,), INF_I32, dtype=torch.int32, device=dev)
    premerged[cperm] = cell_min[cseg]
    label_p = pad_to(torch.where(hp_s, premerged, INF_I32), INF_I32)

    # ---- min-label propagation (B2 per round) + four pointer jumps ----
    def jump(label):
        tgt = torch.clamp(label, 0, n - 1).long()
        hop = torch.where(label < n, label[tgt], label)
        return torch.minimum(label, hop)

    rounds = 0
    changed = True
    while rounds < prop_iters and changed:
        best = wk.masked_window_reduce(bits_hp[0], bits_hp[1], label_p[w_idx],
                                       label_p[w_idx2], minimize=True)
        cur = label_p.reshape(nchunks, chunk)
        new = torch.where(hp_r, torch.minimum(cur, best), cur).reshape(npad)
        for _ in range(4):
            new = jump(new)
        changed = bool((new != label_p).any())  # one host read per round
        label_p = new
        rounds += 1
    prop_rounds = _i32(rounds, dev)
    label_s = label_p[:n]  # HP -> root (sorted index); LP/invalid -> INF

    # first ORIGINAL index per component (the reference's seed identity)
    perm32 = perm.to(torch.int32)
    root_seg = torch.where(hp_s, label_s, n).long()
    comp_first_orig = torch.full((n + 1,), INF_I32, dtype=torch.int32, device=dev).scatter_reduce(
        0, root_seg, torch.where(hp_s, perm32, INF_I32), "amin", include_self=True)
    first_of_point = torch.where(
        hp_s, comp_first_orig[torch.clamp(label_s, 0, n).long()], -1).to(torch.int32)
    first_p = pad_to(first_of_point, -1)

    # ---- B3: border points adopt the largest-first-orig HP component ----
    best_first, root_pick = wk.masked_window_border(
        bits_hp[0], bits_hp[1], first_p[w_idx], first_p[w_idx2],
        label_p[w_idx], label_p[w_idx2])
    border_first = best_first.reshape(npad)[:n]
    border_root = root_pick.reshape(npad)[:n]
    is_border = (~hp_s) & valid_s & (border_first >= 0)
    root_all = torch.where(hp_s, label_s, torch.where(is_border, border_root, INF_I32))

    # ---- enumerate + order clusters by (group, first_orig) ----
    has_comp = comp_first_orig[:n] != INF_I32
    comp_group = torch.full((n + 1,), INF_I32, dtype=torch.int32, device=dev).scatter_reduce(
        0, root_seg, torch.where(hp_s, g_s, INF_I32), "amin", include_self=True)[:n]
    order_g = torch.where(has_comp, comp_group, INF_I32)
    order_f = torch.where(has_comp, comp_first_orig[:n], INF_I32)
    oroot = _lexsort(order_g, order_f)
    og = order_g[oroot]
    ncomp = has_comp.sum(dtype=torch.int32)
    rank_of_root = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    rank_of_root[oroot] = torch.arange(n, dtype=torch.int32, device=dev)

    cap = cluster_cap
    cid_all = torch.where(root_all < n, rank_of_root[torch.clamp(root_all, 0, n).long()], cap)
    cid_all = torch.clamp(torch.where(root_all == INF_I32, cap, cid_all), max=cap)
    size = torch.bincount(cid_all.long(), minlength=cap + 1)[:cap].to(torch.int32)

    c_idx = torch.arange(cap, dtype=torch.int32, device=dev)
    cvalid0 = c_idx < torch.clamp(ncomp, max=cap)
    og_c = og[torch.clamp(c_idx, max=n - 1).long()]
    csem0 = torch.where(cvalid0, torch.div(og_c, 64, rounding_mode="floor"), -1).to(torch.int32)
    cbatch0 = torch.where(cvalid0, torch.remainder(og_c, 64), -1).to(torch.int32)

    # ---- filter small clusters ----
    cm = count_mean.to(device=dev, dtype=torch.float32)
    thresh = _f32(para_f, dev) * cm[torch.clamp(csem0, 0, cm.shape[0] - 1).long()]
    keep = cvalid0 & (size.to(torch.float32) >= thresh)
    new_id_of = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1, -1)
    num_clusters = keep.sum(dtype=torch.int32)
    cid_cl = torch.clamp(cid_all, 0, cap - 1).long()
    cid_filtered = torch.where((cid_all < cap) & keep[cid_cl], new_id_of[cid_cl], -1).to(torch.int32)

    # ---- unassigned points: 1-NN on ORIGINAL coords among assigned points
    # of the same group; the later sorted index wins ties ----
    orig_s = orig[perm]
    assigned = cid_filtered >= 0
    need = (~assigned) & valid_s
    orig_p = pad_to(orig_s, 1e9)
    assigned_p = pad_to(assigned, False)
    cid_p = pad_to(cid_filtered, -1)
    l1_pd = pad_to(l1_s, inf)

    # B4, one launch over both windows (the right one's fresh columns only):
    # the least d2 per needy row, the later window column on a tie (right
    # fresh columns hold later sorted rows), as padded sorted row j
    wiq = [torch.stack([g_p[idx], (assigned_p[idx] if fresh is None
                                   else assigned_p[idx] & fresh).to(torch.int32)], 1)
           for idx, fresh in windows]
    best_d2, j_band = wk.window_1nn(
        rows3(orig_p), rg, pad_to(need, False).reshape(nchunks, chunk),
        wplanes(orig_p, w_idx), wiq[0], wplanes(orig_p, w_idx2), wiq[1],
        anchor.to(torch.int32), anchor2.to(torch.int32))
    found_band = torch.isfinite(best_d2)
    cid_band = torch.where(
        found_band, cid_p[torch.clamp(j_band, 0, npad - 1).long()], -1).reshape(npad)[:n]
    found_band_f = found_band.reshape(npad)[:n]

    # provable-exactness margin: l1 distance to the union's edges
    l1_lo = l1_pd[anchor]
    l1_hi = l1_pd[torch.clamp(anchor2 + W - 1, max=npad - 1)]
    l1_row = l1_pd.reshape(nchunks, chunk)
    m_lo = torch.where(anchor[:, None] > 0, l1_row - l1_lo[:, None], inf)
    m_hi = torch.where((anchor2 + W)[:, None] < npad, l1_hi[:, None] - l1_row, inf)
    contig_c = (anchor2 <= anchor + W)[:, None]
    margin = torch.where(contig_c, torch.clamp(torch.minimum(m_lo, m_hi), min=0.0), 0.0)
    bound = (margin * margin) / _f32(3.0, dev)
    proven = (found_band & (best_d2 <= bound)).reshape(npad)[:n]

    # exact pass for the unproven rows (compacted, static cap).  Only the
    # live rows are computed, in blocks of rows: at ScanNet caps one
    # (F x npad) distance block would take tens of GB of device memory
    F = min(nn_exact_cap or max(256, npad // 32), n)
    need_f = need & ~proven
    order_key = torch.where(need_f, 0, 1).to(torch.int32)
    f_rows = torch.sort(order_key, stable=True).indices[:F]
    f_live = order_key[f_rows] == 0
    nn_overflow = torch.clamp(need_f.sum(dtype=torch.int32) - F, min=0).to(torch.int32)
    cid_exact = torch.full((F,), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(npad, device=dev)
    n_live = int(f_live.sum())
    block = max(1, EXACT_BLOCK_ELEMS // npad)
    for r0 in range(0, n_live, block):
        rows = f_rows[r0:min(r0 + block, n_live)]
        q = orig_s[rows]
        q_g = g_s[rows]
        d2 = wk.sq_dist(q[:, 0:1], q[:, 1:2], q[:, 2:3],
                        orig_p[None, :, 0], orig_p[None, :, 1], orig_p[None, :, 2])
        mok = assigned_p[None, :] & (g_p[None, :] == q_g[:, None])
        d2m = torch.where(mok, d2, inf)
        # LAST minimum in sorted order (the reference's `dist <= best` scan)
        j2 = torch.where(d2m == d2m.amin(1, keepdim=True), cols[None], -1).amax(1)
        found2 = assigned_p[j2] & (g_p[j2] == q_g)
        cid_exact[r0:r0 + rows.shape[0]] = torch.where(found2, cid_p[j2], -1)

    cid_final_s = torch.where(need & found_band_f, cid_band, cid_filtered)
    ext = torch.cat([cid_final_s, torch.full((1,), -1, dtype=torch.int32, device=dev)])
    ext[torch.where(f_live, f_rows, n)] = torch.where(f_live, cid_exact, -1).to(torch.int32)
    cid_final_s = ext[:n]

    # ---- per-cluster mean of shifted coords ----
    member = cid_final_s >= 0
    seg = torch.where(member, cid_final_s, cap).long()
    csum = torch.zeros((cap + 1, 3), dtype=torch.float32, device=dev).index_add_(
        0, seg, torch.where(member[:, None], pos, 0.0))[:cap]
    ccnt = torch.zeros(cap + 1, dtype=torch.float32, device=dev).index_add_(
        0, seg, member.to(torch.float32))[:cap]
    centers = csum / torch.clamp(ccnt, min=1.0)[:, None]

    # final per-cluster metadata in filtered id space
    fvalid = c_idx < num_clusters
    inv = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    inv[torch.where(keep, new_id_of, cap).long()] = c_idx
    old = torch.clamp(inv[:cap], 0, cap - 1).long()
    fsem = torch.where(fvalid, csem0[old], -1).to(torch.int32)
    fbatch = torch.where(fvalid, cbatch0[old], -1).to(torch.int32)
    fsize = torch.bincount(seg, minlength=cap + 1)[:cap].to(torch.int32)

    # ---- un-sort back to original point order ----
    cluster_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cluster_id[perm] = cid_final_s
    density = torch.zeros(n, dtype=torch.int32, device=dev)
    density[perm] = density_s

    return ClusterResult(
        cluster_id=cluster_id,
        num_clusters=num_clusters,
        density=density,
        centers=centers,
        cluster_sem=fsem,
        cluster_batch=fbatch,
        cluster_size=fsize,
        cluster_valid=fvalid,
        band_overflow=band_overflow,
        nn_overflow=nn_overflow,
        prop_rounds=prop_rounds,
    )
