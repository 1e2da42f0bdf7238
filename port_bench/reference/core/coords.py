"""Coordinate keys for the sparse-voxel engine (plain reference: a frozen copy of the port's
``pbnet_torch/core/coords.py``).

A sparse tensor's coordinates are int32 rows ``[b, x, y, z]``.  Each row packs
into a pair of int32 keys

    hi = b * 4096 + x          (x < 4096, b < 2**19)
    lo = y * 65536 + z         (y, z < 65536)

and rows sort lexicographically by the SIGNED (hi, lo) pair, invalid rows
carrying (SENTINEL, SENTINEL) so they sort last and never match a lookup.

Sorting and searching use one int64 key, ``hi * 2**32 + (lo + 2**31)``: the
``+ 2**31`` shift maps signed int32 ``lo`` onto [0, 2**32) monotonically, so
the int64 order is exactly the signed (hi, lo) order and SENTINEL rows, whose
key is the int64 maximum, stay last.
"""

from __future__ import annotations

import torch

# Sentinel key for invalid/padding rows: sorts after every valid key.
SENTINEL = 2**31 - 1

# Packing limits (see module docstring).
MAX_X = 4096
MAX_YZ = 65536


def pack(coords: torch.Tensor, valid: torch.Tensor):
    """Pack int32 coordinates ``[b, x, y, z]`` -> (hi, lo) int32 key pair.

    Invalid rows map to (SENTINEL, SENTINEL).  Arithmetic stays in int32, as
    in the JAX package, so out-of-range coordinates wrap the same way.
    """
    c = coords.to(torch.int32)
    hi = c[:, 0] * MAX_X + c[:, 1]
    lo = c[:, 2] * MAX_YZ + c[:, 3]
    sent = torch.full_like(hi, SENTINEL)
    return torch.where(valid, hi, sent), torch.where(valid, lo, sent)


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key that orders exactly like the signed (hi, lo) pair."""
    return hi.to(torch.int64) * (2**32) + (lo.to(torch.int64) + 2**31)


def sort_perm(hi: torch.Tensor, lo: torch.Tensor):
    """Stable lexicographic sort by (hi, lo) -> (hi_s, lo_s, perm)."""
    perm = torch.sort(key64(hi, lo), stable=True).indices
    return hi[perm], lo[perm], perm


def sort_by_key(hi: torch.Tensor, lo: torch.Tensor, *payloads: torch.Tensor):
    """Stable lexicographic sort by (hi, lo); payloads are permuted along
    axis 0.  Returns ``(hi_sorted, lo_sorted, *payloads_sorted)``."""
    hi_s, lo_s, perm = sort_perm(hi, lo)
    return (hi_s, lo_s, *[p[perm] for p in payloads])


def lookup(sorted_hi, sorted_lo, query_hi, query_lo):
    """Find each query key in a sorted, duplicate-free key array.

    Lower-bound search on the int64 key.  Returns ``(idx, found)``: ``idx``
    is the lower-bound position clamped to ``n - 1`` (meaningful only where
    ``found``), as the JAX package's binary search returns it.
    """
    n = sorted_hi.shape[0]
    keys = key64(sorted_hi, sorted_lo)
    q = key64(query_hi, query_lo)
    lb = torch.searchsorted(keys, q, side="left")
    pos = torch.clamp(lb, max=n - 1)
    found = (
        (lb < n)
        & (sorted_hi[pos] == query_hi)
        & (sorted_lo[pos] == query_lo)
        & (query_hi != SENTINEL)
    )
    return pos.to(torch.int32), found


def unique_sorted(hi_sorted: torch.Tensor, lo_sorted: torch.Tensor):
    """First-occurrence flags / unique positions for a sorted key array.

    Returns ``(first_flag, unique_pos, count)``: ``unique_pos[i]`` is the
    index of row i's key among the unique keys, ``count`` the number of
    unique non-pad keys (a 0-dim int32 tensor).
    """
    minus1 = torch.full((1,), -1, dtype=torch.int32, device=hi_sorted.device)
    prev_hi = torch.cat([minus1, hi_sorted[:-1]])
    prev_lo = torch.cat([minus1, lo_sorted[:-1]])
    first = ((hi_sorted != prev_hi) | (lo_sorted != prev_lo)) & (
        hi_sorted != SENTINEL
    )
    f32 = first.to(torch.int32)
    unique_pos = torch.cumsum(f32, 0, dtype=torch.int32) - 1
    count = f32.sum(dtype=torch.int32)
    return first, unique_pos, count
