"""Tiny cells for the CPU tests: the real configurations and limits, rooms
of a few thousand points at caps that hold them (one room in an eval pool,
so that any window checks the whole pool)."""

from __future__ import annotations

import copy

from port_bench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")

TINY_EVAL_CAPS = dict(point_cap=8192, voxel_caps=[8192] * 5, cluster_cap=16,
                      local_point_cap=4096, local_voxel_caps=[4096] * 5,
                      score_voxel_caps=[4096] * 5, instance_cap=16, cluster_band=2048,
                      fg_point_cap=4096, nn_exact_cap=None, grid_extent=[3, 2048, 2048, 256])
TINY_TRAIN_CAPS = dict(TINY_EVAL_CAPS, grid_extent=[4, 2048, 2048, 256])


def eval_cell(name: str = "pbnet34c.eval-tta") -> spec.Cell:
    cell = copy.deepcopy(spec.cell(name))
    cell.traffic.update(points=[2000], objects=[1], side_m_at_140k=4.5 * 3.2,
                        caps=TINY_EVAL_CAPS)
    return cell


def train_cell(name: str = "pbnet34c.train") -> spec.Cell:
    cell = copy.deepcopy(spec.cell(name))
    cell.traffic.update(points=[1500, 2000], objects=[1, 1], batches=4,
                        side_m_at_140k=4.5 * 3.2, caps=TINY_TRAIN_CAPS)
    return cell
