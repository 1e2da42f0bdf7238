"""Minimal PLY reader and writer (port of pbnet_tpu/data/ply.py; replaces
the plyfile dependency).

Supports the subset ScanNet uses: binary_little_endian / ascii, vertex
properties (float x/y/z, uchar red/green/blue, ushort label, float alpha...)
and face ``vertex_indices`` lists (uchar count + int32 indices).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> dict:
    """Parse a PLY file -> {element_name: structured array or dict}.

    Faces are returned as an (F, 3) int array under ['face']['vertex_indices']
    (ScanNet meshes are triangle-only).
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)| ('list', cnt_dt, it_dt, name)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            parts = line.decode("ascii").strip().split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append([parts[1], int(parts[2]), []])
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(
                        ("list", _DTYPES[parts[2]], _DTYPES[parts[3]], parts[4])
                    )
                else:
                    elements[-1][2].append((parts[2], _DTYPES[parts[1]]))
            elif parts[0] == "end_header":
                break

        out = {}
        if fmt == "binary_little_endian":
            for name, count, props in elements:
                if any(p[0] == "list" for p in props):
                    out[name] = _read_list_element_binary(f, count, props)
                else:
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    out[name] = np.frombuffer(f.read(dt.itemsize * count), dt)
        elif fmt == "ascii":
            lines = f.read().decode("ascii").split("\n")
            li = 0
            for name, count, props in elements:
                if any(p[0] == "list" for p in props):
                    rows = []
                    for _ in range(count):
                        vals = lines[li].split(); li += 1
                        n = int(vals[0])
                        rows.append([int(v) for v in vals[1 : 1 + n]])
                    out[name] = {props[0][3]: np.array(rows)}
                else:
                    dt = np.dtype([(p[0], p[1]) for p in props])
                    arr = np.zeros(count, dt)
                    for r in range(count):
                        vals = lines[li].split(); li += 1
                        for (pn, _), v in zip(props, vals):
                            arr[r][pn] = float(v)
                    out[name] = arr
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return out


def _read_list_element_binary(f, count, props):
    # ScanNet faces: one list property, uniform triangles -> fast path
    assert len(props) == 1 and props[0][0] == "list"
    _, cnt_dt, item_dt, name = props[0]
    cnt_size = np.dtype(cnt_dt).itemsize
    item_size = np.dtype(item_dt).itemsize
    raw = f.read()
    # peek the first count
    first_n = int(np.frombuffer(raw[:cnt_size], "<" + cnt_dt)[0])
    rec = cnt_size + first_n * item_size
    if len(raw) >= rec * count:
        block = np.frombuffer(raw[: rec * count], dtype=np.uint8).reshape(count, rec)
        counts = block[:, :cnt_size].copy().view("<" + cnt_dt)[:, 0]
        if np.all(counts == first_n):
            idx = (
                block[:, cnt_size:]
                .copy()
                .view("<" + item_dt)
                .reshape(count, first_n)
            )
            return {name: idx.astype(np.int64)}
    # ragged fallback
    rows, off = [], 0
    for _ in range(count):
        n = int(np.frombuffer(raw[off : off + cnt_size], "<" + cnt_dt)[0])
        off += cnt_size
        rows.append(
            np.frombuffer(raw[off : off + n * item_size], "<" + item_dt).astype(np.int64)
        )
        off += n * item_size
    return {name: np.array(rows, dtype=object)}


def write_ply_mesh(path: str, xyz: np.ndarray, rgb: np.ndarray | None,
                   faces: np.ndarray, labels: np.ndarray | None = None):
    """Write a binary PLY mesh (the synthetic ScanNet scenes of the tests and
    the chip smoke run)."""
    n = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if rgb is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        cols += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if labels is not None:
        props += ["property ushort label"]
        cols += [("label", "<u2")]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\n"
        f"element face {faces.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    vert = np.zeros(n, np.dtype(cols))
    vert["x"], vert["y"], vert["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if rgb is not None:
        vert["red"], vert["green"], vert["blue"] = (
            rgb[:, 0], rgb[:, 1], rgb[:, 2],
        )
    if labels is not None:
        vert["label"] = labels
    face_dt = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
    face = np.zeros(faces.shape[0], face_dt)
    face["n"] = 3
    face["v"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vert.tobytes())
        f.write(face.tobytes())
