"""The B axis of the port's descriptor build.

`build_descriptors` runs every stage once for a batch of scans, as the JAX
package's `jax.vmap(build_descriptor)` does (`db._build_descs_chunked`). The
batch here is four scans: world0, world11_revisit (the scenes of
test_torch_descriptor.py), an all-zero cloud (a serving pad: no contour,
zero keys, an empty pixel pool) and world0 with a diagonal staircase of tall
cells added, whose 8-connected component needs one CC propagate a cell (the
row and column flushes cannot shortcut a staircase), so its fixpoint takes
many more convergence checks than the others'.

- The batch, a q16 batch and 5 scans in sub-batches of 2 against JAX's
  `jax.vmap(build_descriptor)` / `_build_descs_chunked` on the same numpy
  clouds, in test_torch_descriptor.py's bands (ints, bools and labels
  exactly).
- Row b of every batched stage (raster, CC labels, tables, ring inputs,
  keys, BCIs, GMM summary, the whole ScanDesc) bit-equal to the same stage
  on scan b alone (B = 1): every reduction runs over the trailing extents of
  one scan. No float leaf needs a band for that on the CPU.
- `ring_key_divs_batch_plain` row-equal to `ring_key_divs_plain`, the empty
  pool row of the zero cloud included, and within float32 summation order
  (1e-5) of the direct formula w * exp(...) summed by einsum, also on a
  pool long enough that the kernel's slices take several chunks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan
from test_torch_descriptor import assert_desc_close

from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu.utils.io import pad_points, quantize_points_q16
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import kernels
from contour_context_tpu_torch.types import ScanDesc

torch.set_num_threads(2)

CFG = ContourManagerConfig(max_points=16384)
TCFG = tconfig.ContourManagerConfig(max_points=16384)
NAMES = ("world0", "world11_revisit", "zero", "staircase")


def _scene(seed, n, ext, pose, s):
    return pad_points(render_scan(make_world(seed, n, ext), pose, seed=s),
                      CFG.max_points)


def _staircase(base):
    """world0 with 48 tall cells on a diagonal (one per 1 m cell, touching
    corner to corner only)."""
    pts = base.copy()
    n = int((pts[:, 3] > 0).sum())
    i = np.arange(48, dtype=np.float32)
    pts[n:n + 48] = np.stack([-30.5 + i, -40.5 + i, np.full(48, 4.0),
                              np.ones(48)], 1)
    return pts


@pytest.fixture(scope="module")
def clouds():
    w0 = _scene(0, 40, 120.0, (0.0, 0.0, 0.0), 1)
    w11 = _scene(11, 220, 160.0, (10.5, 0.8, 0.2), 508)
    return np.stack([w0, w11, np.zeros_like(w0), _staircase(w0)])


def _jax_vmap(points):
    from contour_context_tpu.ops.descriptor import build_descriptor

    return jax.device_get(jax.vmap(lambda p: build_descriptor(p, CFG))(
        jnp.asarray(points)))


def _row_j(dj, b):
    return type(dj)(*[np.asarray(x)[b] for x in dj])


def _row_t(dt, b):
    return ScanDesc(*[x[b] for x in dt])


@pytest.fixture(scope="module")
def batch(clouds):
    return td.build_descriptors(torch.from_numpy(clouds), TCFG)


def test_batch_matches_jax_vmap(clouds, batch):
    dj = _jax_vmap(clouds)
    for b in range(len(NAMES)):
        assert_desc_close(_row_j(dj, b), _row_t(batch, b))
    zero = _row_t(batch, NAMES.index("zero"))
    assert int(zero.n_cont.sum()) == 0 and not zero.keys.any()
    assert not zero.valid.any() and int(zero.pix_overflow) == 0
    for b in (0, 1, 3):
        assert int(batch.n_cont[b].sum()) > 20 and batch.nei_valid[b].any()


def test_q16_batch_matches_jax(clouds):
    q = np.stack([quantize_points_q16(c) for c in clouds[:2]])
    dt = td.build_descriptors(torch.from_numpy(q), TCFG)
    assert q.dtype == np.int16 and dt.keys.dtype == torch.float32
    dj = _jax_vmap(q)
    for b in range(2):
        assert_desc_close(_row_j(dj, b), _row_t(dt, b))


def test_sub_batches_match_jax_chunked(clouds, batch):
    from contour_context_tpu.db import _build_descs_chunked

    pts5 = np.concatenate([clouds, _scene(11, 220, 160.0, (30.0, -1.0, -0.15),
                                          501)[None]])
    dt = td.build_descriptors(torch.from_numpy(pts5), TCFG, batch=2)
    dj = jax.device_get(_build_descs_chunked(
        jnp.asarray(pts5), PipelineConfig(cm=CFG), batch=2))
    for b in range(5):
        assert_desc_close(_row_j(dj, b), _row_t(dt, b))
    # sub-batching changes no bit of the rows it shares with one batch
    for x, y in zip(dt, batch):
        assert torch.equal(x[:4], y)


def _stages(points, cfg=TCFG):
    """Every stage's outputs on points (B, P, 4), as build_descriptors runs
    them."""
    out = {}
    bev, rowf, colf = td.rasterize_bev(points, cfg)
    out["raster"] = (bev, rowf, colf)
    masks = td.level_masks(bev, cfg)
    labels = td.cc_labels(masks)
    out["cc_labels"] = (labels,)
    tab = td.component_tables(labels, masks.flatten(-2), bev, rowf, colf, cfg)
    out["tables"] = tuple(tab[k] for k in sorted(tab))
    anchors, pool, _, pix_overflow = td.ring_inputs(tab, bev, rowf, colf, cfg)
    out["ring_inputs"] = (anchors, pool, pix_overflow)
    keys, anch_valid, _ = td.make_keys(tab, bev, rowf, colf, cfg)
    out["keys"] = (keys, anch_valid)
    bci = td.make_bcis(tab, anch_valid, cfg)
    out["bcis"] = tuple(bci[k] for k in sorted(bci))
    out["gmm_summary"] = td.gmm_summary(tab, tconfig.GMMOptConfig())
    out["build"] = tuple(td.build_descriptors(points, cfg))
    return out


@pytest.fixture(scope="module")
def staged(clouds):
    pts = torch.from_numpy(clouds)
    return _stages(pts), [_stages(pts[b:b + 1]) for b in range(len(NAMES))]


@pytest.mark.parametrize("stage", ["raster", "cc_labels", "tables",
                                   "ring_inputs", "keys", "bcis",
                                   "gmm_summary", "build"])
def test_stage_rows_equal_the_single_call(staged, stage):
    """Row b of the batched stage is the stage on scan b alone, bit for
    bit: ints, bools and floats."""
    full, ones = staged
    for b, one in enumerate(ones):
        for i, (x, y) in enumerate(zip(full[stage], one[stage])):
            assert x.shape[1:] == y.shape[1:] and y.shape[0] == 1, (stage, i)
            assert torch.equal(x[b:b + 1], y), (stage, i, NAMES[b])


def test_unbatched_stages_are_the_batch_of_one(clouds, staged):
    """A scan without a batch axis (the stages' callers outside the build)
    gives the B = 1 row."""
    _, ones = staged
    bev, rowf, colf = td.rasterize_bev(torch.from_numpy(clouds[1]), TCFG)
    for x, y in zip((bev, rowf, colf), ones[1]["raster"]):
        assert torch.equal(x, y[0])
    d = td.build_descriptor(torch.from_numpy(clouds[1]), TCFG)
    for x, y in zip(d, ones[1]["build"]):
        assert torch.equal(x, y[0])


def test_staircase_needs_more_cc_checks(clouds, monkeypatch):
    """The staircase's fixpoint takes many more convergence checks than the
    other scenes'; the batch takes as many as its slowest scan, and its
    labels are still each scan's own."""
    calls = []
    equal = torch.equal
    monkeypatch.setattr(torch, "equal",
                        lambda a, b: calls.append(1) or equal(a, b))

    def checks(points):
        calls.clear()
        masks = td.level_masks(td.rasterize_bev(torch.from_numpy(points),
                                                TCFG)[0], TCFG)
        td.cc_labels(masks)
        return len(calls)

    single = [checks(clouds[b:b + 1]) for b in range(len(NAMES))]
    assert single[3] > 10 * max(single[:3]), single
    assert checks(clouds) == max(single)


def _direct_ring(anchors, pool, centers, roi):
    """The ring sums as one formula (the pre-batch plain version): summed
    over all pixels by einsum, in ATen's order."""
    an, pl = anchors[..., None, :], pool[:, None]
    in_box = ((pl[..., 0] >= an[..., 2]) & (pl[..., 0] <= an[..., 3])
              & (pl[..., 1] >= an[..., 4]) & (pl[..., 1] <= an[..., 5]))
    dr, dc = pl[..., 2] - an[..., 0], pl[..., 3] - an[..., 1]
    dist = torch.sqrt(dr * dr + dc * dc)
    contrib = in_box & (dist < roi - 1e-2) & (pl[..., 5] > 0)
    w = torch.where(contrib, pl[..., 4], 0.0)
    x = centers - dist[..., None]
    g = torch.exp(-0.5 * (x * x)) * kernels.INV_SQRT_2PI
    return torch.einsum("bap,bapd->bad", w, g), contrib.sum(-1).float()


def _long_pool(P=20000, B=3, seed=7):
    """A synthetic batch whose pool (P > 4 slices x 4096) makes each of the
    kernel's slices take two chunks; anchors cover the grid densely."""
    rng = np.random.default_rng(seed)
    A8 = 12
    anchors = np.zeros((B, A8, 8), np.float32)
    anchors[..., 0] = rng.uniform(20, 130, (B, A8))
    anchors[..., 1] = rng.uniform(20, 130, (B, A8))
    anchors[..., 2] = anchors[..., 0] - 11
    anchors[..., 3] = anchors[..., 0] + 11
    anchors[..., 4] = anchors[..., 1] - 11
    anchors[..., 5] = anchors[..., 1] + 11
    pool = np.zeros((B, P, 8), np.float32)
    pool[..., 2] = rng.uniform(0, 150, (B, P))
    pool[..., 3] = rng.uniform(0, 150, (B, P))
    pool[..., 0] = np.floor(pool[..., 2])
    pool[..., 1] = np.floor(pool[..., 3])
    pool[..., 4] = rng.integers(0, 5, (B, P))
    pool[..., 5] = rng.random((B, P)) < 0.9
    return torch.from_numpy(anchors), torch.from_numpy(pool)


def _centers(roi):
    """ring_inputs' division centres."""
    div_len = roi / 35
    return torch.arange(35, dtype=torch.float32) * div_len + 0.5 * div_len


@pytest.mark.parametrize("case", ["block", "long_pool"])
def test_ring_batch_plain_rows_equal_single(staged, case):
    full, _ = staged
    roi = TCFG.roi_radius
    centers = _centers(roi)
    if case == "block":
        anchors, pool, _ = full["ring_inputs"]
    else:
        anchors, pool = _long_pool()
    divs, counts = kernels.ring_key_divs_batch_plain(anchors, pool, centers,
                                                     roi)
    for b in range(anchors.shape[0]):
        d1, c1 = kernels.ring_key_divs_plain(anchors[b], pool[b], centers,
                                             roi)
        assert torch.equal(divs[b], d1) and torch.equal(counts[b], c1), b
    d_ref, c_ref = _direct_ring(anchors, pool, centers, roi)
    assert torch.equal(counts, c_ref)
    torch.testing.assert_close(divs, d_ref, rtol=1e-5, atol=1e-5)
    if case == "block":
        zero = NAMES.index("zero")
        assert not pool[zero, :, 5].any() and not counts[zero].any()
        assert not divs[zero].any()
        assert counts[0].sum() > 100 and counts[3].sum() > 100
    else:
        assert counts.min() > 100          # every anchor sums many pixels


def test_ring_batch_wrapper_takes_plain_on_cpu(staged):
    full, _ = staged
    anchors, pool, _ = full["ring_inputs"]
    centers = _centers(10.0)
    kernels.reset_launches()
    d0, n0 = kernels.ring_key_divs_batch(anchors, pool, centers, 10.0)
    d1, n1 = kernels.ring_key_divs_batch_plain(anchors, pool, centers, 10.0)
    assert torch.equal(d0, d1) and torch.equal(n0, n1)
    assert d0.shape == (4, 36, 35) and n0.shape == (4, 36)
    assert kernels.ring_key_divs_batch.launches == 0
    assert kernels.ring_key_divs.launches == 0
