"""The port's hand-written CUDA kernels, their plain torch twins, and the build.

Three kernel entries replace the JAX package's two Pallas kernels
(`contour_context_tpu/ops/pallas_kernels.py`):

- `ring_key_divs` (csrc/ring_key.cu): the ring-key Gaussian contraction of
  `make_keys`, replacing `_ring_kernel`.
- `search_tilemin` (csrc/search_tilemin.cu): stage 1 of the tile-min-cover key
  search (masked squared key distance + per-128-column tile minimum over the
  bf16 search-layout store), replacing `_search_tilemin_kernel` under the
  contract of `db._search_cover2`.
- `search_tilemin_batch` (a second entry of csrc/search_tilemin.cu): the same
  for B queries, each with its own searchable_n, in one launch that reads the
  store once (what `jax.vmap` of the query makes of the search in block and
  serving modes).

Each wrapper takes its plain twin for CPU tensors only; a CUDA tensor launches
the kernel or raises. The kernels are compiled at first use with nvcc into one
shared library with a plain C interface (loaded with ctypes) under
`build/torch_kernels/` at the repository root, named by a hash of the sources.
Each wrapper counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path
import torch

from contour_context_tpu_torch.types import device_const

MAX_DIST_SQ = 1e6        # contour_db.h:30, the masked-distance sentinel
TILE = 128               # tile width of the min-cover search (db.TOPK_TILE)
N_DIV = 35               # ring divisions: (RET_KEY_DIM - 3) bins x 5
KEY_DIM = 10             # RET_KEY_DIM
MAX_ANCHORS = 16         # query anchors per level the search kernel stages
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("ring_key.cu", "search_tilemin.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library from the
    package's csrc/."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = [_CSRC / s for s in _SOURCES]
    tag = hashlib.sha1(b"".join(p.read_bytes() for p in srcs)).hexdigest()[:12]
    so = BUILD_DIR / f"libcc_kernels_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp)] + [str(p) for p in srcs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
        (BUILD_DIR / f"ptxas_{tag}.log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cc_ring_key_divs.restype = ci
    lib.cc_ring_key_divs.argtypes = [vp, vp, vp, vp, vp, ci, ci, cf, vp]
    lib.cc_search_tilemin.restype = ci
    lib.cc_search_tilemin.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                      ctypes.c_uint, ci, vp]
    lib.cc_search_tilemin_vector.restype = ci
    lib.cc_search_tilemin_vector.argtypes = [vp, ci]
    lib.cc_search_tilemin_batch.restype = ci
    lib.cc_search_tilemin_batch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                            ctypes.c_uint, ci, vp]
    _lib = lib
    return lib


def _check(name, t, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# ---------------------------------------------------------------------------
# ring-key contraction
# ---------------------------------------------------------------------------

def ring_key_divs_plain(anchors, pool, centers, roi_radius: float):
    """anchors (A8, 8) [v0, v1, r_min, r_max, c_min, c_max, _, _], pool
    (P, 8) [p_r, p_c, rowf, colf, higher, ok, _, _], centers (n_div,) ->
    divs (A8, n_div) = sum_p w exp(-(c_d - dist)^2 / 2) / sqrt(2 pi) and the
    in-RoI pixel count (A8,), both f32 (pallas_kernels.ring_key_divs_reference)."""
    v0, v1 = anchors[:, 0:1], anchors[:, 1:2]
    p_r, p_c = pool[None, :, 0], pool[None, :, 1]
    rowf, colf = pool[None, :, 2], pool[None, :, 3]
    in_box = ((p_r >= anchors[:, 2:3]) & (p_r <= anchors[:, 3:4])
              & (p_c >= anchors[:, 4:5]) & (p_c <= anchors[:, 5:6]))
    dr = rowf - v0
    dc = colf - v1
    dist = torch.sqrt(dr * dr + dc * dc)
    contrib = in_box & (dist < roi_radius - 1e-2) & (pool[None, :, 5] > 0)
    w = torch.where(contrib, pool[None, :, 4], 0.0)
    x = centers[None, None, :] - dist[..., None]
    g = torch.exp(-0.5 * (x * x)) * INV_SQRT_2PI
    divs = torch.einsum("ap,apd->ad", w, g)
    return divs, contrib.sum(dim=1).to(torch.float32)


def ring_key_divs(anchors, pool, centers, roi_radius: float):
    """Kernel wrapper of `ring_key_divs_plain` (same signature and outputs)."""
    if anchors.device.type == "cpu":
        return ring_key_divs_plain(anchors, pool, centers, roi_radius)
    if anchors.device.type != "cuda":
        raise ValueError(f"ring_key_divs: unsupported device {anchors.device}")
    A8, P = anchors.shape[0], pool.shape[0]
    _check("anchors", anchors, torch.float32, (A8, 8))
    _check("pool", pool, torch.float32, (P, 8))
    _check("centers", centers, torch.float32, (N_DIV,))
    if pool.device != anchors.device or centers.device != anchors.device:
        raise ValueError("ring_key_divs: inputs on different devices")
    if pool.data_ptr() % 16:
        raise ValueError("ring_key_divs: pool is not 16-byte aligned (the "
                         "kernel loads each row as two float4s)")
    lib = build()
    divs = torch.empty((A8, N_DIV), dtype=torch.float32, device=anchors.device)
    counts = torch.empty((A8,), dtype=torch.float32, device=anchors.device)
    rc = lib.cc_ring_key_divs(anchors.data_ptr(), pool.data_ptr(),
                              centers.data_ptr(), divs.data_ptr(),
                              counts.data_ptr(), A8, P, float(roi_radius),
                              _stream(anchors.device))
    _raise_on(rc, "ring_key_divs")
    ring_key_divs.launches += 1
    return divs, counts


ring_key_divs.launches = 0


# ---------------------------------------------------------------------------
# search stage 1: masked key distance + per-tile minimum
# ---------------------------------------------------------------------------

def masked_key_distances(kt, q, searchable_n, NA: int, cols):
    """Masked squared distances of query keys q (Q, A, D) f32 to key columns
    kt (Q, D, 1 or A, *C) at global column ids `cols` (broadcastable to the
    trailing axes): accumulated over d = 0..D-1 in order with each op rounded
    on its own (db._search_cover2's order). Zero key columns, columns of
    scans >= searchable_n, columns >= NA and zero query anchors give
    MAX_DIST_SQ. `searchable_n` is a 0-d tensor, or one value per row of the
    Q axis shaped to broadcast against (Q, A, *C). Returns (Q, A, *C) f32."""
    Q, A, D = q.shape
    tail = (1,) * (kt.dim() - 3)
    k = kt.to(torch.float32)
    qv = q.reshape((Q, A) + tail + (D,))
    d2 = torch.zeros((Q, A) + tuple(k.shape[3:]), dtype=torch.float32,
                     device=kt.device)
    for d in range(D):
        diff = k[:, d] - qv[..., d]
        d2 = d2 + diff * diff
    row_valid = k.abs().sum(1) > 0
    col_ok = (torch.div(cols, A, rounding_mode="floor") < searchable_n) & \
        (cols < NA)
    q_valid = (q.abs().sum(-1) > 0).reshape((Q, A) + tail)
    return torch.where(row_valid & col_ok & q_valid, d2, MAX_DIST_SQ)


def search_tilemin_plain(keys_q, q_levels, q, state):
    """keys_q (L, D, NA) search-layout store (bf16 or f32), q_levels tuple of
    Q level indices, q (Q, A, D) f32 query keys, state (2,) int32 device
    [n, searchable_n] -> (Q, A, ceil(NA/TILE)) f32 per-tile minima of the
    masked squared key distances."""
    L, D, NA = keys_q.shape
    A = q.shape[1]
    lv = device_const(tuple(q_levels), torch.long, keys_q.device)
    kt = keys_q.index_select(0, lv)
    Bt = -(-NA // TILE)
    pad = Bt * TILE - NA
    if pad:
        kt = torch.nn.functional.pad(kt, (0, pad))
    kt = kt.reshape(len(q_levels), D, 1, Bt, TILE)
    cols = torch.arange(Bt * TILE, dtype=torch.int32,
                        device=keys_q.device).reshape(Bt, TILE)
    d2 = masked_key_distances(kt, q, state[1], NA, cols)
    return d2.amin(dim=-1)


def search_tilemin(keys_q, q_levels, q, state):
    """Kernel wrapper of `search_tilemin_plain` (same signature and outputs;
    the tile minima are bit-identical: the kernel rounds every sub, mul and
    add separately in the same d order)."""
    if keys_q.device.type == "cpu":
        return search_tilemin_plain(keys_q, q_levels, q, state)
    if keys_q.device.type != "cuda":
        raise ValueError(f"search_tilemin: unsupported device {keys_q.device}")
    L, D, NA = keys_q.shape
    Q, A = len(q_levels), q.shape[1]
    _check_tilemin("search_tilemin", keys_q, q_levels, A, D)
    _check("q", q, torch.float32, (Q, A, D))
    _check("state", state, torch.int32, (2,))
    if q.device != keys_q.device or state.device != keys_q.device:
        raise ValueError("search_tilemin: inputs on different devices")
    lib = build()
    Bt = -(-NA // TILE)
    out = torch.empty((Q, A, Bt), dtype=torch.float32, device=keys_q.device)
    rc = lib.cc_search_tilemin(
        keys_q.data_ptr(), q.data_ptr(), state.data_ptr(), out.data_ptr(),
        Q, A, NA, int(keys_q.dtype == torch.bfloat16),
        _pack_levels(q_levels), L, _stream(keys_q.device))
    _raise_on(rc, "search_tilemin")
    search_tilemin.launches += 1
    return out


search_tilemin.launches = 0


def _check_tilemin(name, keys_q, q_levels, A: int, D: int) -> None:
    L = keys_q.shape[0]
    Q = len(q_levels)
    if D != KEY_DIM or A > MAX_ANCHORS or not 0 < Q <= 4:
        raise ValueError(f"{name}: unsupported D={D} A={A} Q={Q}")
    if not all(0 <= lv < L for lv in q_levels):
        raise ValueError(f"{name}: q_levels {q_levels} outside {L}")
    if keys_q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: keys_q dtype {keys_q.dtype}")
    _check("keys_q", keys_q, keys_q.dtype)


def _pack_levels(q_levels) -> int:
    packed = 0
    for i, lv in enumerate(q_levels):
        packed |= lv << (8 * i)
    return packed


def search_tilemin_batch_plain(keys_q, q_levels, q_b, searchable_b):
    """keys_q (L, D, NA), q_b (B, Q, A, D) f32 query keys of B queries,
    searchable_b (B,) int32 searchable_n of each -> (B, Q, A, ceil(NA/TILE))
    f32; row b equals `search_tilemin_plain` of q_b[b] at searchable_b[b]
    bit for bit (the same elementwise ops over a folded (B*Q) axis)."""
    L, D, NA = keys_q.shape
    B, Q, A, _ = q_b.shape
    lv = device_const(tuple(q_levels), torch.long, keys_q.device)
    kt = keys_q.index_select(0, lv)
    Bt = -(-NA // TILE)
    pad = Bt * TILE - NA
    if pad:
        kt = torch.nn.functional.pad(kt, (0, pad))
    kt = kt.reshape(1, Q, D, 1, Bt, TILE).expand(B, Q, D, 1, Bt, TILE) \
        .reshape(B * Q, D, 1, Bt, TILE)
    cols = torch.arange(Bt * TILE, dtype=torch.int32,
                        device=keys_q.device).reshape(Bt, TILE)
    sn = searchable_b.repeat_interleave(Q).reshape(B * Q, 1, 1, 1)
    d2 = masked_key_distances(kt, q_b.reshape(B * Q, A, D), sn, NA, cols)
    return d2.amin(dim=-1).reshape(B, Q, A, Bt)


def search_tilemin_batch(keys_q, q_levels, q_b, searchable_b):
    """Kernel wrapper of `search_tilemin_batch_plain` (same signature and
    outputs, bit-identical): one launch for the B queries, in which the
    store leaves device memory once. `searchable_b` stays on the device."""
    if keys_q.device.type == "cpu":
        return search_tilemin_batch_plain(keys_q, q_levels, q_b, searchable_b)
    if keys_q.device.type != "cuda":
        raise ValueError("search_tilemin_batch: unsupported device "
                         f"{keys_q.device}")
    L, D, NA = keys_q.shape
    B, Q, A = q_b.shape[0], len(q_levels), q_b.shape[2]
    _check_tilemin("search_tilemin_batch", keys_q, q_levels, A, D)
    _check("q_b", q_b, torch.float32, (B, Q, A, D))
    _check("searchable_b", searchable_b, torch.int32, (B,))
    if q_b.device != keys_q.device or searchable_b.device != keys_q.device:
        raise ValueError("search_tilemin_batch: inputs on different devices")
    if B < 1:
        raise ValueError("search_tilemin_batch: no query")
    lib = build()
    out = torch.empty((B, Q, A, -(-NA // TILE)), dtype=torch.float32,
                      device=keys_q.device)
    rc = lib.cc_search_tilemin_batch(
        keys_q.data_ptr(), q_b.data_ptr(), searchable_b.data_ptr(),
        out.data_ptr(), B, Q, A, NA, int(keys_q.dtype == torch.bfloat16),
        _pack_levels(q_levels), L, _stream(keys_q.device))
    _raise_on(rc, "search_tilemin_batch")
    search_tilemin_batch.launches += 1
    return out


search_tilemin_batch.launches = 0


def search_tilemin_path(keys_q) -> str:
    """The path the C launcher takes for this store: "vector" (one 8-byte
    load of 4 bf16 columns, or 16 bytes of 4 f32 columns, a key dimension)
    or "scalar" (NA % 8 != 0, or a base off 16-byte alignment)."""
    vec = build().cc_search_tilemin_vector(keys_q.data_ptr(), keys_q.shape[2])
    return "vector" if vec else "scalar"


def reset_launches() -> None:
    ring_key_divs.launches = 0
    search_tilemin.launches = 0
    search_tilemin_batch.launches = 0
