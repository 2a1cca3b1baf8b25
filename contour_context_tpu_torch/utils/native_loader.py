"""ctypes bindings for the port's native data plane (csrc/loader.cpp).

The port's own copy of `contour_context_tpu/utils/native_loader.py`: an
mmap'd `.bin` reader, a block reader on a thread pool and a multi-threaded
in-order prefetch ring, so the pipeline's host side reads scans without
Python file IO on the critical path. The library is compiled at first use
with g++ from the package's `csrc/loader.cpp` into `build/torch_kernels/`
at the repository root (named by a hash of the source, written to a
temporary file and renamed, so concurrent builds are safe). Without g++,
or when the build fails, every function falls back to the numpy readers of
utils/io.py: host file IO only, the same bytes either way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from contour_context_tpu_torch.ops.kernels import BUILD_DIR
from contour_context_tpu_torch.utils.io import pad_points, read_kitti_bin

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "loader.cpp"
_lib = None
_lib_tried = False


def library_path() -> Path:
    """Where the library of the current source is built."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcc_loader_{tag}.so"


def _build() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-Wall",
                          "-pthread", "-shared", "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.c2_read_bin_padded.restype = ctypes.c_int
    lib.c2_read_bin_padded.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.c2_prefetcher_create.restype = ctypes.c_void_p
    lib.c2_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.c2_prefetcher_next.restype = ctypes.c_int
    lib.c2_prefetcher_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.c2_prefetcher_destroy.restype = None
    lib.c2_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.c2_read_block.restype = ctypes.c_int
    lib.c2_read_block.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_bin_padded_into(path: str, out: np.ndarray) -> int:
    """Read + pad one scan directly into a caller-owned (max_points, 4) f32
    row-contiguous buffer. Returns the point count."""
    assert out.dtype == np.float32 and out.flags["C_CONTIGUOUS"]
    max_points = out.shape[0]
    lib = _load_lib()
    if lib is None:
        pts = read_kitti_bin(path, max_points)
        out[:] = pad_points(pts, max_points)
        return len(pts)
    n = lib.c2_read_bin_padded(path.encode(), _fptr(out), max_points)
    if n < 0:
        raise IOError(f"c2_read_bin_padded failed for {path}")
    return n


def read_block_into(paths: List[str], out: np.ndarray,
                    n_threads: int = 4) -> None:
    """Fill a (B, max_points, 4) f32 block buffer, one scan per row, with a
    native thread pool (the host side of block and chain staging)."""
    B = len(paths)
    assert out.shape[0] >= B and out.dtype == np.float32 \
        and out.flags["C_CONTIGUOUS"]
    lib = _load_lib()
    if lib is None:
        for j, p in enumerate(paths):
            read_bin_padded_into(p, out[j])
        return
    arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    counts = (ctypes.c_int * B)()
    rc = lib.c2_read_block(arr, B, _fptr(out), out.shape[1], n_threads,
                           counts)
    if rc != 0:
        bad = [paths[i] for i in range(B) if counts[i] < 0]
        raise IOError(f"c2_read_block failed for {bad}")


def read_bin_padded(path: str, max_points: int) -> np.ndarray:
    """Read + pad one scan -> (max_points, 4) f32 [x y z valid], the layout
    of utils/io.py read_kitti_bin + pad_points."""
    out = np.empty((max_points, 4), np.float32)
    read_bin_padded_into(path, out)
    return out


class ScanPrefetcher:
    """In-order threaded prefetcher over a list of `.bin` paths.

    Iterating yields (max_points, 4) padded f32 arrays in submission order;
    reads happen on native threads up to `depth` scans ahead (synchronous
    numpy reads without the native library)."""

    def __init__(self, paths: List[str], max_points: int,
                 depth: int = 8, n_threads: int = 4):
        self.paths = list(paths)
        self.max_points = max_points
        self._i = 0
        lib = _load_lib()
        self._lib = lib
        self._h = None
        if lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._h = lib.c2_prefetcher_create(
                arr, len(self.paths), max_points, depth, n_threads)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= len(self.paths):
            raise StopIteration
        self._i += 1
        if self._h is None:
            return read_bin_padded(self.paths[self._i - 1], self.max_points)
        out = np.empty((self.max_points, 4), np.float32)
        n = self._lib.c2_prefetcher_next(self._h, _fptr(out))
        if n == -2:
            raise StopIteration
        if n == -1:
            raise IOError(
                f"prefetcher read failed for {self.paths[self._i - 1]}")
        return out

    def close(self) -> None:
        if self._h is not None:
            self._lib.c2_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
