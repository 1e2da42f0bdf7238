"""The port's point-cloud plotter (``pbnet_torch/tools/plot.py``) against
the JAX package's ``tools/plot.py``: the same seeded cloud, labels and box
give the same pixels, and ``save_instance_view`` writes the same file
contents as an image."""

import matplotlib.image
import numpy as np

from pbnet_tpu.tools import plot as jplot
from pbnet_torch.tools import plot as tplot


def cloud():
    rng = np.random.RandomState(0)
    return rng.rand(200, 3), rng.randint(-1, 12, 200)


def test_colour_tables_equal():
    for name in ("COLOR20", "COLOR40", "COLOR64"):
        np.testing.assert_array_equal(getattr(tplot, name), getattr(jplot, name))


def test_ptcloud_img_equals_jax():
    xyz, labels = cloud()
    box = np.array([[0.1, 0.1, 0.1, 0.6, 0.5, 0.4]])
    got = tplot.get_ptcloud_img(xyz, labels, boxes=box)
    want = jplot.get_ptcloud_img(xyz, labels, boxes=box)
    assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)
    assert got.min() < 255  # something was drawn
    np.testing.assert_array_equal(tplot.get_ptcloud_img(xyz), jplot.get_ptcloud_img(xyz))


def test_save_instance_view_equals_jax(tmp_path):
    xyz, labels = cloud()
    tplot.save_instance_view(str(tmp_path / "t.png"), xyz, labels)
    jplot.save_instance_view(str(tmp_path / "j.png"), xyz, labels)
    got = matplotlib.image.imread(str(tmp_path / "t.png"))
    np.testing.assert_array_equal(got, matplotlib.image.imread(str(tmp_path / "j.png")))
    assert got.shape[:2] == (800, 800)
