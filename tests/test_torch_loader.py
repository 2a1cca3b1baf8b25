"""The port's native loader against the JAX package's and the numpy readers
(mirrors tests/test_native_loader.py).

The port builds its own copy of csrc/loader.cpp with g++ into
build/torch_kernels/ and never touches csrc/: the tracked csrc/libcont2.so
keeps its bytes. Every reader gives exactly the bytes of
`pad_points(read_kitti_bin(...))` and of the JAX loader, on scans of 1000,
0, 7, 5000 and 131172 points (the last longer than max_points).
"""

import hashlib
import os

import numpy as np
import pytest

from contour_context_tpu.utils import native_loader as jnl
from contour_context_tpu_torch.utils import native_loader as tnl
from contour_context_tpu_torch.utils.io import pad_points, read_kitti_bin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED = os.path.join(REPO, "csrc", "libcont2.so")


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bins")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate([1000, 0, 7, 5000, 131072 + 100]):
        arr = rng.uniform(-80, 80, (n, 4)).astype(np.float32)
        p = str(tmp / ("%06d.bin" % i))
        arr.tofile(p)
        paths.append(p)
    return paths


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_native_builds_under_build_and_leaves_csrc_alone(tmp_path,
                                                          monkeypatch):
    assert tnl.native_available(), "g++ expected in this image"
    so = tnl.library_path()
    assert so.exists() and so.parent == tnl.BUILD_DIR
    assert os.path.relpath(so, REPO).startswith(
        os.path.join("build", "torch_kernels"))
    # a fresh build from the port's own copy of the source: it writes its
    # library where it is told and nothing under csrc/
    assert os.path.dirname(tnl._SRC).endswith(
        os.path.join("contour_context_tpu_torch", "csrc"))
    csrc = sorted(os.listdir(os.path.dirname(TRACKED)))
    before = _sha(TRACKED)
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_tried", False)
    assert tnl.native_available()
    assert [f.name for f in (tmp_path / "build").iterdir()] == [so.name]
    assert _sha(TRACKED) == before
    assert sorted(os.listdir(os.path.dirname(TRACKED))) == csrc


@pytest.mark.parametrize("max_points", [4096, 131072])
def test_read_parity(bins, max_points):
    for p in bins:
        a = tnl.read_bin_padded(p, max_points)
        b = pad_points(read_kitti_bin(p, max_points), max_points)
        np.testing.assert_array_equal(a, b, err_msg=p)
        np.testing.assert_array_equal(a, jnl.read_bin_padded(p, max_points))
        out = np.full((max_points, 4), -9.0, np.float32)
        n = tnl.read_bin_padded_into(p, out)
        np.testing.assert_array_equal(out, b)
        assert n == min(os.path.getsize(p) // 16, max_points)


def test_prefetcher_order_and_content(bins):
    paths = (bins * 5)[:23]       # the ring wraps several times
    pf = tnl.ScanPrefetcher(paths, max_points=2048, depth=3, n_threads=4)
    got = list(pf)
    pf.close()
    assert len(got) == len(paths)
    for p, g in zip(paths, got):
        np.testing.assert_array_equal(
            g, pad_points(read_kitti_bin(p, 2048), 2048), err_msg=p)


def test_read_block_into(bins, tmp_path):
    paths = (bins * 3)[:11]
    out = np.full((11, 2048, 4), -9.0, np.float32)
    tnl.read_block_into(paths, out, n_threads=4)
    ref = np.full((11, 2048, 4), -9.0, np.float32)
    jnl.read_block_into(paths, ref, n_threads=4)
    np.testing.assert_array_equal(out, ref)
    for j, p in enumerate(paths):
        np.testing.assert_array_equal(
            out[j], pad_points(read_kitti_bin(p, 2048), 2048), err_msg=p)
    with pytest.raises(IOError):
        tnl.read_block_into([bins[0], str(tmp_path / "missing.bin")],
                            np.empty((2, 256, 4), np.float32))


def test_prefetcher_missing_file(bins, tmp_path):
    pf = tnl.ScanPrefetcher([bins[0], str(tmp_path / "nope.bin")],
                            max_points=256)
    next(pf)
    with pytest.raises(IOError):
        next(pf)
    pf.close()


def test_numpy_fallback_gives_the_same_bytes(bins, monkeypatch):
    """Without the library (no g++) every reader falls back to numpy: host
    file IO only, the same bytes."""
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_lib_tried", True)
    assert not tnl.native_available()
    out = np.empty((3, 2048, 4), np.float32)
    tnl.read_block_into(bins[:3], out)
    for j, p in enumerate(bins[:3]):
        want = pad_points(read_kitti_bin(p, 2048), 2048)
        np.testing.assert_array_equal(out[j], want)
        np.testing.assert_array_equal(tnl.read_bin_padded(p, 2048), want)
    assert len(list(tnl.ScanPrefetcher(bins, 512))) == len(bins)
