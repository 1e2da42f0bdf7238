"""ctypes binding of the mesh segmentator (port of
``pbnet_tpu/native/segmentator/__init__.py``), plus its numpy reference.

Public API as PBNet's wrapper (lib/segmentator/main.py:7-36): compacted
segment ids 0..S-1 via ``unique(return_inverse)``.

``segmentator.cc`` (a copy of the JAX package's) is built at first use with

    g++ -O3 -shared -fPIC -o pbnet_torch/_build/segmentator-<hash>.so segmentator.cc

where the hash covers the source and the flags, as ``_build.py`` names the
CUDA libraries.  A failed build raises: ``segment_mesh_np`` is the test
oracle, never a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "segmentator.cc"
_FLAGS = ("-O3", "-shared", "-fPIC")
_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"segmentator-{h}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for segmentator.cc (rc {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.segment_mesh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            lib.segment_mesh.restype = None
            lib.segment_point.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            lib.segment_point.restype = None
            _lib = lib
        return _lib


def loaded_library() -> str:
    """The path of the shared library this process loaded (built if needed)."""
    return _get_lib()._name


def _compact(ids: np.ndarray) -> np.ndarray:
    _, inverse = np.unique(ids, return_inverse=True)
    return inverse.astype(np.int64)


def segment_mesh(vertices: np.ndarray, faces: np.ndarray,
                 k_thresh: float = 0.01, seg_min_verts: int = 20) -> np.ndarray:
    """Superpoints for a triangle mesh -> (V,) int64 compacted segment ids."""
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"vertices {v.shape} and faces {f.shape}: expected (V, 3) and (F, 3)")
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError("face index out of range")
    out = np.zeros(v.shape[0], np.int32)
    _get_lib().segment_mesh(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), f.shape[0],
        ctypes.c_float(k_thresh), seg_min_verts,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return _compact(out)


def segment_point(points: np.ndarray, normals: np.ndarray, edges: np.ndarray,
                  k_thresh: float = 0.01, seg_min_verts: int = 20) -> np.ndarray:
    """Superpoints for an arbitrary point graph -> (N,) int64 segment ids."""
    p = np.ascontiguousarray(points, np.float32)
    n = np.ascontiguousarray(normals, np.float32)
    e = np.ascontiguousarray(edges, np.int64)
    if p.ndim != 2 or p.shape[1] != 3 or n.shape != p.shape or e.ndim != 2 or e.shape[1] != 2:
        raise ValueError(f"points {p.shape}, normals {n.shape}, edges {e.shape}: expected "
                         "(N, 3), (N, 3) and (E, 2)")
    if e.size and (e.min() < 0 or e.max() >= p.shape[0]):
        raise ValueError("edge index out of range")
    out = np.zeros(p.shape[0], np.int32)
    _get_lib().segment_point(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), p.shape[0],
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), e.shape[0],
        ctypes.c_float(k_thresh), seg_min_verts,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return _compact(out)


# ------------------------------------------------------------------
# Pure-numpy reference (test oracle; same algorithm, python union-find)
# ------------------------------------------------------------------


def segment_mesh_np(vertices: np.ndarray, faces: np.ndarray,
                    k_thresh: float = 0.01, seg_min_verts: int = 20) -> np.ndarray:
    v = vertices.astype(np.float32)
    f = faces.astype(np.int64)
    nv = v.shape[0]
    points = np.zeros((nv, 3), np.float32)
    normals = np.zeros((nv, 3), np.float32)
    counts = np.zeros(nv, np.int64)
    edges = []
    for i in range(f.shape[0]):
        i1, i2, i3 = f[i]
        p1, p2, p3 = v[i1], v[i2], v[i3]
        points[i1], points[i2], points[i3] = p1, p2, p3
        edges += [(i1, i2), (i1, i3), (i3, i2)]
        fn = np.cross(p2 - p1, p3 - p1)
        fn = fn / np.linalg.norm(fn)
        for vi in (i1, i2, i3):
            t = 1.0 / (counts[vi] + 1.0)
            normals[vi] = t * fn + (1.0 - t) * normals[vi]
            counts[vi] += 1
    ws = []
    for a, b in edges:
        d = points[b] - points[a]
        d = d / np.linalg.norm(d)
        dot = float(np.dot(normals[a], normals[b]))
        dot2 = float(np.dot(normals[b], d))
        w = 1.0 - dot
        if dot2 > 0:
            w = w * w
        ws.append(np.float32(w))

    parent = list(range(nv))
    size = [1] * nv
    rank = [0] * nv

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    def join(a, b):
        if rank[a] > rank[b]:
            parent[b] = a
            size[a] += size[b]
        else:
            parent[a] = b
            size[b] += size[a]
            if rank[a] == rank[b]:
                rank[b] += 1

    order = np.argsort(np.array(ws), kind="stable")
    thr = [k_thresh] * nv
    for ei in order:
        a, b = edges[ei]
        ra, rb = find(a), find(b)
        if ra != rb and ws[ei] <= thr[ra] and ws[ei] <= thr[rb]:
            join(ra, rb)
            r = find(ra)
            thr[r] = float(ws[ei]) + k_thresh / size[r]
    for ei in order:
        a, b = edges[ei]
        ra, rb = find(a), find(b)
        if ra != rb and (size[ra] < seg_min_verts or size[rb] < seg_min_verts):
            join(ra, rb)
    return _compact(np.array([find(q) for q in range(nv)]))
