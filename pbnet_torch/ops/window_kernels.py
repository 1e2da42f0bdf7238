"""The banded-window clustering passes: CUDA kernels and plain versions.

Each pass has

* a CUDA kernel in ``csrc/window_kernels.cu`` (built for sm_90a at first use
  by ``_build.py`` and called through ctypes on the current stream),
* a plain PyTorch version ``<name>_plain`` computing the same function step
  by step, and
* a wrapper ``<name>`` that sends CPU tensors to the plain version and CUDA
  tensors to the kernel — a CUDA tensor launches the kernel or raises.

| wrapper              | replaces (JAX package)                            |
|----------------------|---------------------------------------------------|
| neighbor_pack        | pbnet_tpu/ops/pallas_kernels.py:151 neighbor_pack |
| masked_window_reduce | pallas_kernels.py:77 masked_window_reduce         |
| masked_window_border | pallas_kernels.py:326 masked_window_border        |
| window_1nn           | pallas_kernels.py:247 window_1nn                  |
| masked_window_match_pick | pallas_kernels.py:383 masked_window_match_pick |

``masked_window_match_pick`` runs on no path (the fused border pass took its
place in clustering); its kernel is a mode of the border kernel.

Layouts: rows ``(nchunks, 3, chunk)``; window planes ``(nchunks, P, W)``;
window values ``(nchunks, W)``; neighbor bit words ``(nchunks, chunk, W/32)``
int32 holding the uint32 bit pattern (bit b of word w = window column
32*w + b).  The TPU's bit-lane-major ``(nchunks, 32, NW)`` planes are a
TPU layout constraint and are not carried over.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do not
count), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

INF_I32 = 2**31 - 1

LAUNCHES = {
    "neighbor_pack": 0,
    "masked_window_reduce": 0,
    "masked_window_border": 0,
    "window_1nn": 0,
    "masked_window_match_pick": 0,
}

_SOURCE = "window_kernels"
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    """The kernel library, built and bound on first use."""
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pbnet_neighbor_pack.argtypes = [P, P, P, P, P, P, F, P, P, P, I, I, I, P]
        lib.pbnet_masked_window_reduce.argtypes = [P, P, P, P, P, I, I, I, I, P]
        lib.pbnet_masked_window_border.argtypes = [P, P, P, P, P, P, P, P, I, I, I, P]
        lib.pbnet_window_1nn.argtypes = [P] * 11 + [I, I, I, P]
        lib.pbnet_masked_window_match_pick.argtypes = [P, P, P, P, P, P, P, P, I, I, I, P]
        for fn in (lib.pbnet_neighbor_pack, lib.pbnet_masked_window_reduce,
                   lib.pbnet_masked_window_border, lib.pbnet_window_1nn,
                   lib.pbnet_masked_window_match_pick):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_check, _ptr = _build.check, _build.ptr


def _launch(name, fn, *args):
    _build.launch(LAUNCHES, name, fn, *args)


def _window_dims(bits):
    nchunks, chunk, nw = bits.shape
    return nchunks, chunk, nw * 32


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


def neighbor_pack(r2: float, rows_f, rows_i, w1f, w1i, w2f, w2i):
    """See :func:`neighbor_pack_plain`; CUDA tensors run the kernel."""
    if rows_f.device.type == "cpu":
        return neighbor_pack_plain(r2, rows_f, rows_i, w1f, w1i, w2f, w2i)
    nchunks, _, chunk = rows_f.shape
    W = w1f.shape[2]
    if W % 32 or nchunks > 65535:
        raise ValueError(f"neighbor_pack: W={W} must be a multiple of 32, nchunks={nchunks} <= 65535")
    dev = rows_f.device
    _check("rows_f", rows_f, torch.float32, (nchunks, 3, chunk), dev)
    _check("rows_i", rows_i, torch.int32, (nchunks, 3, chunk), dev)
    for nm, t, dt in (("w1f", w1f, torch.float32), ("w2f", w2f, torch.float32),
                      ("w1i", w1i, torch.int32), ("w2i", w2i, torch.int32)):
        _check(nm, t, dt, (nchunks, 3, W), dev)
    bits1 = torch.empty((nchunks, chunk, W // 32), dtype=torch.int32, device=dev)
    bits2 = torch.empty_like(bits1)
    dens = torch.empty((nchunks, chunk), dtype=torch.int32, device=dev)
    lib = _library()
    _launch("neighbor_pack", lib.pbnet_neighbor_pack,
            _ptr(rows_f), _ptr(rows_i), _ptr(w1f), _ptr(w1i), _ptr(w2f), _ptr(w2i),
            ctypes.c_float(r2), _ptr(bits1), _ptr(bits2), _ptr(dens),
            nchunks, chunk, W)
    return bits1, bits2, dens


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


def masked_window_reduce(bits1, bits2, vw1, vw2, minimize: bool = True):
    """See :func:`masked_window_reduce_plain`; CUDA tensors run the kernel."""
    if bits1.device.type == "cpu":
        return masked_window_reduce_plain(bits1, bits2, vw1, vw2, minimize)
    nchunks, chunk, W = _window_dims(bits1)
    dev = bits1.device
    _check("bits1", bits1, torch.int32, (nchunks, chunk, W // 32), dev)
    _check("bits2", bits2, torch.int32, (nchunks, chunk, W // 32), dev)
    _check("vw1", vw1, torch.int32, (nchunks, W), dev)
    _check("vw2", vw2, torch.int32, (nchunks, W), dev)
    out = torch.empty((nchunks, chunk), dtype=torch.int32, device=dev)
    lib = _library()
    _launch("masked_window_reduce", lib.pbnet_masked_window_reduce,
            _ptr(bits1), _ptr(bits2), _ptr(vw1), _ptr(vw2), _ptr(out),
            nchunks, chunk, W, int(bool(minimize)))
    return out


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


def masked_window_border(bits1, bits2, fw1, fw2, lw1, lw2):
    """See :func:`masked_window_border_plain`; CUDA tensors run the kernel."""
    if bits1.device.type == "cpu":
        return masked_window_border_plain(bits1, bits2, fw1, fw2, lw1, lw2)
    nchunks, chunk, W = _window_dims(bits1)
    dev = bits1.device
    _check("bits1", bits1, torch.int32, (nchunks, chunk, W // 32), dev)
    _check("bits2", bits2, torch.int32, (nchunks, chunk, W // 32), dev)
    for nm, t in (("fw1", fw1), ("fw2", fw2), ("lw1", lw1), ("lw2", lw2)):
        _check(nm, t, torch.int32, (nchunks, W), dev)
    best = torch.empty((nchunks, chunk), dtype=torch.int32, device=dev)
    root = torch.empty_like(best)
    lib = _library()
    _launch("masked_window_border", lib.pbnet_masked_window_border,
            _ptr(bits1), _ptr(bits2), _ptr(fw1), _ptr(fw2), _ptr(lw1), _ptr(lw2),
            _ptr(best), _ptr(root), nchunks, chunk, W)
    return best, root


# ---------------------------------------------------------------------------
# B5 masked_window_match_pick
# ---------------------------------------------------------------------------
def masked_window_match_pick_plain(bits1, bits2, fw1, fw2, lw1, lw2, target):
    """out[i, r] = max label ``lw*[i, j]`` over set bits ``j`` of both
    windows whose first-orig ``fw*[i, j]`` equals ``target[i, r]``; -1 where
    none does."""
    roots = []
    for c in range(bits1.shape[0]):
        tgt = target[c][:, None]
        root = None
        for bits, fw, lw in ((bits1, fw1, lw1), (bits2, fw2, lw2)):
            hit = unpack_bits(bits[c]) & (fw[c][None] == tgt)
            r = torch.where(hit, lw[c][None], -1).amax(1)
            root = r if root is None else torch.maximum(root, r)
        roots.append(root)
    return torch.stack(roots)


def masked_window_match_pick(bits1, bits2, fw1, fw2, lw1, lw2, target):
    """See :func:`masked_window_match_pick_plain`; CUDA tensors run the
    border kernel in its match-pick mode."""
    if bits1.device.type == "cpu":
        return masked_window_match_pick_plain(bits1, bits2, fw1, fw2, lw1, lw2, target)
    nchunks, chunk, W = _window_dims(bits1)
    dev = bits1.device
    _check("bits1", bits1, torch.int32, (nchunks, chunk, W // 32), dev)
    _check("bits2", bits2, torch.int32, (nchunks, chunk, W // 32), dev)
    for nm, t in (("fw1", fw1), ("fw2", fw2), ("lw1", lw1), ("lw2", lw2)):
        _check(nm, t, torch.int32, (nchunks, W), dev)
    _check("target", target, torch.int32, (nchunks, chunk), dev)
    out = torch.empty((nchunks, chunk), dtype=torch.int32, device=dev)
    lib = _library()
    _launch("masked_window_match_pick", lib.pbnet_masked_window_match_pick,
            _ptr(bits1), _ptr(bits2), _ptr(fw1), _ptr(fw2), _ptr(lw1), _ptr(lw2),
            _ptr(target), _ptr(out), nchunks, chunk, W)
    return out


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


def window_1nn(rows_f, rows_g, need, w1f, w1i, w2f, w2i, anchor, anchor2):
    """See :func:`window_1nn_plain`; CUDA tensors run the kernel (one launch
    for both windows)."""
    if rows_f.device.type == "cpu":
        return window_1nn_plain(rows_f, rows_g, need, w1f, w1i, w2f, w2i, anchor, anchor2)
    nchunks, _, chunk = rows_f.shape
    W = w1f.shape[2]
    if nchunks > 65535:
        raise ValueError(f"window_1nn: nchunks={nchunks} > 65535")
    dev = rows_f.device
    _check("rows_f", rows_f, torch.float32, (nchunks, 3, chunk), dev)
    _check("rows_g", rows_g, torch.int32, (nchunks, chunk), dev)
    _check("need", need, torch.bool, (nchunks, chunk), dev)
    for nm, t, dt, planes in (("w1f", w1f, torch.float32, 3), ("w1i", w1i, torch.int32, 2),
                              ("w2f", w2f, torch.float32, 3), ("w2i", w2i, torch.int32, 2)):
        _check(nm, t, dt, (nchunks, planes, W), dev)
    _check("anchor", anchor, torch.int32, (nchunks,), dev)
    _check("anchor2", anchor2, torch.int32, (nchunks,), dev)
    d2 = torch.empty((nchunks, chunk), dtype=torch.float32, device=dev)
    j = torch.empty((nchunks, chunk), dtype=torch.int32, device=dev)
    lib = _library()
    _launch("window_1nn", lib.pbnet_window_1nn,
            _ptr(need), _ptr(rows_f), _ptr(rows_g), _ptr(w1f), _ptr(w1i), _ptr(w2f), _ptr(w2i),
            _ptr(anchor), _ptr(anchor2), _ptr(d2), _ptr(j), nchunks, chunk, W)
    return d2, j
