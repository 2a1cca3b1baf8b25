"""The port's descriptor build against JAX's, leaf by leaf, on synth scenes.

Ints, bools and labels are exact. Float leaves agree to rtol/atol 1e-5
(float32 summation order), keys to 1e-4 (the band of
test_pallas_kernels.py's key check). Three groups get their reason stated:
- com_r (and its tab12 channel 4) is |com - mean| of two ~150-magnitude
  float32 vectors, where one ulp is 1.5e-5: atol 1e-4.
- eig_vecs (and tab12 channels 7-8): the eigenvector of a near-round
  ellipse carries the moments' rounding divided by the eigenvalue gap, in
  JAX's float32 sums as in the port's; manual_cov and gmm_pack (which packs
  it) carry that error times the eigenvalue: atol 1e-4.
- nei_theta is compared on valid neighbour slots; an invalid slot's angle
  (e.g. of a contour 0.1 cells away) is never read by any consumer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu.config import ContourManagerConfig
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu.utils.io import pad_points, quantize_points_q16
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.types import ScanDesc, scan_desc_to_numpy

torch.set_num_threads(2)

# one config per package, from the same arguments: neither package's
# functions see the other's config (tests/test_torch_copies.py holds the
# two classes together)
CFG = ContourManagerConfig(max_points=16384)
TCFG = tconfig.ContourManagerConfig(max_points=16384)
SCENES = {
    "world0": (0, 40, 120.0, (0.0, 0.0, 0.0), 1),
    "world11_revisit": (11, 220, 160.0, (10.5, 0.8, 0.2), 508),
}


def _points(name):
    seed, n, ext, pose, s = SCENES[name]
    return pad_points(render_scan(make_world(seed, n, ext), pose, seed=s),
                      CFG.max_points)


def assert_desc_close(dj, dt):
    """JAX ScanDesc (numpy leaves) vs torch ScanDesc, with the bands above."""
    assert ScanDesc._fields == dj._fields
    valid_nei = np.asarray(dj.nei_valid)
    for name, a, b in zip(ScanDesc._fields, dj, scan_desc_to_numpy(dt)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(b, a, err_msg=name)
        elif name == "nei_theta":
            np.testing.assert_allclose(b[valid_nei], a[valid_nei],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        elif name == "keys":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        elif name in ("com_r", "eig_vecs", "manual_cov", "gmm_pack"):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
        elif name == "tab12":
            loose = [4, 7, 8]           # com_r, eigenvector channels
            tight = [c for c in range(12) if c not in loose]
            np.testing.assert_allclose(b[..., loose], a[..., loose],
                                       rtol=1e-5, atol=1e-4, err_msg=name)
            np.testing.assert_allclose(b[..., tight], a[..., tight],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.fixture(scope="module")
def jax_build():
    from contour_context_tpu.ops.descriptor import build_descriptor

    return lambda pts: jax.device_get(build_descriptor(jnp.asarray(pts), CFG))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_descriptor_matches_jax(jax_build, scene):
    pts = _points(scene)
    dj = jax_build(pts)
    dt = td.build_descriptor(torch.from_numpy(pts), TCFG)
    assert_desc_close(dj, dt)
    assert int(dj.n_cont.sum()) > 20 and np.asarray(dj.nei_valid).any()


def test_q16_wire_format_matches_jax(jax_build):
    q = quantize_points_q16(_points("world0"))
    dj = jax_build(q)
    dt = td.build_descriptor(torch.from_numpy(q), TCFG)
    assert dt.keys.dtype == torch.float32
    assert_desc_close(dj, dt)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rasterize_and_cc_labels_match_jax(scene):
    from contour_context_tpu.ops.descriptor import cc_labels, rasterize_bev

    pts = _points(scene)
    # duplicated points: the first in array order must win the pixel
    pts[200:260] = pts[100:160]
    bev_j, rowf_j, colf_j = [np.asarray(x) for x in rasterize_bev(
        jnp.asarray(pts), CFG)]
    bev_t, rowf_t, colf_t = td.rasterize_bev(torch.from_numpy(pts), TCFG)
    np.testing.assert_array_equal(bev_t.numpy(), bev_j)
    np.testing.assert_array_equal(rowf_t.numpy(), rowf_j)
    np.testing.assert_array_equal(colf_t.numpy(), colf_j)

    masks = bev_j.reshape(CFG.n_row, CFG.n_col)[None] > \
        np.asarray(CFG.lv_grads, np.float32)[:, None, None]
    lab_j = np.asarray(cc_labels(jnp.asarray(masks), "hillis"))
    lab_t = td.cc_labels(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(lab_t, lab_j)
    assert (lab_j < CFG.n_row * CFG.n_col).any()
