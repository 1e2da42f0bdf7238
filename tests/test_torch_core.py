"""The port's sparse-voxel core (pbnet_torch/core) against the JAX package's.

Integer outputs only, so everything is compared EXACTLY: packed keys, sort
order, lookups, quantization maps, every level and kernel map of the UNet
topology, and the overflow counters.  The main topology is compared with the
JAX package's grid-based build (the path its models take) at
``__graft_entry__._SHAPES``-sized caps; the local (pid) topology with its
maps derived from the main one (``build_pid_unet_topology``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbnet_tpu.core import coords as jck
from pbnet_tpu.core import quantize as jqz
from pbnet_tpu.core import topology as jtp
from pbnet_torch.core import coords as tck
from pbnet_torch.core import quantize as tqz
from pbnet_torch.core import topology as ttp

GRAFT_CAPS = (512, 256, 128, 64, 32)
GRAFT_EXTENT = (1, 256, 256, 64)


def eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def padded_coords(rng, n, cap, extent=20, batches=2, unique=True):
    c = np.stack([rng.randint(0, batches, n)]
                 + [rng.randint(0, extent, n) for _ in range(3)], 1).astype(np.int32)
    if unique:
        c = np.unique(c, axis=0)
    c = c[rng.permutation(len(c))]
    out = np.zeros((cap, 4), np.int32)
    out[: len(c)] = c
    return out, np.arange(cap) < len(c)


def test_pack_sort_lookup_unique(rng):
    c, valid = padded_coords(rng, 300, 350, unique=False)  # duplicates too
    c[5, 1:] = [4095, 65535, 65535]  # key extremes
    jhi, jlo = jck.pack(jnp.asarray(c), jnp.asarray(valid))
    thi, tlo = tck.pack(torch.from_numpy(c), torch.from_numpy(valid))
    eq(thi, jhi, "hi")
    eq(tlo, jlo, "lo")
    js = jck.sort_by_key(jhi, jlo, jnp.asarray(c))
    ts = tck.sort_by_key(thi, tlo, torch.from_numpy(c))
    for a, b, nm in zip(ts, js, ("hi", "lo", "payload")):
        eq(a, b, nm)
    for a, b, nm in zip(tck.unique_sorted(ts[0], ts[1]), jck.unique_sorted(js[0], js[1]),
                        ("first", "unique_pos", "count")):
        eq(a, b, nm)
    # lookups of present, absent and pad keys in a duplicate-free key set
    u, uv = padded_coords(rng, 300, 350)
    kh, kl = tck.sort_by_key(*tck.pack(torch.from_numpy(u), torch.from_numpy(uv)))
    q, qv = padded_coords(np.random.RandomState(1), 200, 240, extent=22)
    qhi, qlo = tck.pack(torch.from_numpy(q), torch.from_numpy(qv))
    ti, tf = tck.lookup(kh, kl, qhi, qlo)
    ji, jf = jck.lookup(*(jnp.asarray(a.numpy()) for a in (kh, kl, qhi, qlo)))
    eq(tf, jf, "found")
    eq(ti.numpy()[tf.numpy()], np.asarray(ji)[np.asarray(jf)], "idx")
    assert tf.any() and not tf.all()


@pytest.mark.parametrize("cap,vs", [(512, 0.25), (48, 0.25)])  # fits / overflows
def test_quantize_device_matches_jax(rng, cap, vs):
    n, pad = 400, 57
    xyz = np.zeros((n + pad, 3), np.float32)
    xyz[:n] = rng.rand(n, 3).astype(np.float32) * 3.0
    xyz[:40] = xyz[40:80]  # duplicate points
    batch = rng.randint(0, 3, n + pad).astype(np.int32)
    valid = np.arange(n + pad) < n
    ref = jqz.quantize_device(jnp.asarray(xyz), jnp.asarray(batch), jnp.asarray(valid), cap, vs)
    got = tqz.quantize_device(torch.from_numpy(xyz), torch.from_numpy(batch),
                              torch.from_numpy(valid), cap, vs)
    for k in ref:
        eq(got[k], ref[k], k)
    assert (int(got["count"]) > cap) == (cap == 48)


def main_level_pair(rng, cap=GRAFT_CAPS[0], n=480, extent=10):
    c, valid = padded_coords(rng, n, cap, extent=extent, batches=1)
    jl = jtp.level_from_coords(jnp.asarray(c), jnp.asarray(valid), cap, 1)
    tl = ttp.level_from_coords(torch.from_numpy(c), torch.from_numpy(valid), cap, 1)
    return jl, tl


def assert_topo_equal(t, j, levels=True):
    if levels:
        for l, (a, b) in enumerate(zip(t.levels, j.levels)):
            for f in ("coords", "hi", "lo", "valid", "count"):
                eq(getattr(a, f), getattr(b, f), f"level {l} {f}")
            assert a.stride == b.stride
    eq(t.stem_map, j.stem_map, "stem")
    for name in ("k3_maps", "down_maps", "up_maps"):
        ts, js = getattr(t, name), getattr(j, name)
        assert len(ts) == len(js)
        for i, (a, b) in enumerate(zip(ts, js)):
            eq(a, b, f"{name}[{i}]")
    eq(t.level_overflow, j.level_overflow, "level_overflow")


@pytest.mark.parametrize("caps", [GRAFT_CAPS, (512, 100, 64, 16, 8)])  # fits / overflows
def test_unet_topology_matches_jax(rng, caps, fast_compile):
    jl, tl = main_level_pair(rng)
    j = jtp.build_unet_topology(jl, list(caps), extent=GRAFT_EXTENT)
    t = ttp.build_unet_topology(tl, list(caps))
    assert_topo_equal(t, j)
    assert int(t.grid_overflow) == 0 == int(j.grid_overflow)
    assert (int(t.level_overflow) > 0) == (caps[1] == 100)
    # voxel -> point map
    npt = 300
    xyz = (rng.rand(npt, 3) * 0.22).astype(np.float32)
    pb = np.zeros(npt, np.int32)
    pv = rng.rand(npt) < 0.9
    want = jtp.point_to_voxel_map(j.levels[0], jnp.asarray(xyz), jnp.asarray(pb),
                                  jnp.asarray(pv), 0.02, grid=j.grids[0])
    got = ttp.point_to_voxel_map(t.levels[0], torch.from_numpy(xyz), torch.from_numpy(pb),
                                 torch.from_numpy(pv), 0.02)
    eq(got, want, "point_to_voxel_map")


def test_local_pid_topology_matches_jax(rng, fast_compile):
    """Local scenes: (pid, x, y, z) voxels that are subsets of the main
    lattice.  The JAX package derives their maps from the main topology;
    the port looks them up directly — the maps must be identical."""
    jl, tl = main_level_pair(rng, cap=1024, n=1000, extent=14)
    caps = [1024, 1024, 512, 256, 128]
    main = jtp.build_unet_topology(jl, caps, extent=(1, 64, 64, 64))
    P = 4
    occ = np.asarray(jl.coords)[np.asarray(jl.valid)]
    rows = []
    for p in range(P):
        sub = occ[rng.choice(occ.shape[0], 150, replace=False)].copy()
        sub[:, 0] = p
        rows.append(sub)
    rows = np.concatenate(rows)
    lc = np.zeros((1024, 4), np.int32)
    lc[: len(rows)] = rows
    lvalid = np.arange(1024) < len(rows)
    jll = jtp.level_from_coords(jnp.asarray(lc), jnp.asarray(lvalid), 1024, 1)
    tll = ttp.level_from_coords(torch.from_numpy(lc), torch.from_numpy(lvalid), 1024, 1)
    j = jtp.build_pid_unet_topology(jll, caps, main, jnp.zeros((P,), jnp.int32), P)
    t = ttp.build_unet_topology(tll, caps)
    assert_topo_equal(t, j)
    assert int(j.grid_overflow) == 0
