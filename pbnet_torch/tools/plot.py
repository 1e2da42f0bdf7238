"""3D point-cloud views for debugging (port of pbnet_tpu/tools/plot.py):
matplotlib (Agg) scatter renders with fixed colour tables and bounding-box
overlays."""

from __future__ import annotations

import numpy as np

COLOR20 = np.array(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
     [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128]],
    np.float32,
) / 255.0

COLOR40 = np.concatenate([COLOR20, 1.0 - COLOR20 * 0.5], axis=0)
COLOR64 = np.concatenate([COLOR40, (COLOR40[:24] * 0.6 + 0.2)], axis=0)

_BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7))


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def get_ptcloud_img(xyz: np.ndarray, labels: np.ndarray | None = None,
                    colors: np.ndarray = COLOR20, point_size: float = 0.5,
                    boxes: np.ndarray | None = None) -> np.ndarray:
    """A labelled point cloud rendered to an (H, W, 3) uint8 image.  Labels
    below 0 render grey; ``boxes`` (K, 6) [min_xyz, max_xyz] are drawn as
    wireframes."""
    plt = _pyplot()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    c = None
    if labels is not None:
        lab = np.asarray(labels).astype(np.int64)
        c = np.where((lab >= 0)[:, None], colors[np.clip(lab, 0, len(colors) - 1) % len(colors)],
                     np.array([0.6, 0.6, 0.6]))
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=point_size, c=c)
    for b in () if boxes is None else boxes:
        mn, mx = b[:3], b[3:6]
        corners = np.array([[mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]], [mx[0], mx[1], mn[2]],
                            [mn[0], mx[1], mn[2]], [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
                            [mx[0], mx[1], mx[2]], [mn[0], mx[1], mx[2]]])
        for a, e in _BOX_EDGES:
            ax.plot(*zip(corners[a], corners[e]), c="k", linewidth=0.8)
    ax.set_axis_off()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return img


def save_instance_view(path: str, xyz: np.ndarray, instance_ids: np.ndarray) -> None:
    """Save an instance-coloured view to ``path``."""
    _pyplot().imsave(path, get_ptcloud_img(xyz, instance_ids, COLOR64))
