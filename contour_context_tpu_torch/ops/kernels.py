"""The port's hand-written CUDA kernels, their plain torch twins, and the build.

Four kernel entries replace the JAX package's two Pallas kernels
(`contour_context_tpu/ops/pallas_kernels.py`), and four more take the JAX
package's device-side while-loops and scans off the host:

- `ring_key_divs` (csrc/ring_key.cu): the ring-key Gaussian contraction of
  `make_keys`, replacing `_ring_kernel`.
- `ring_key_divs_batch` (the same `__global__` with a batch grid axis): the
  same for the B scans of a block or serving chunk in one launch (what
  `jax.vmap(build_descriptor)` makes of `_ring_kernel`); `ring_key_divs` is
  its B = 1 launch.
- `search_tilemin` (csrc/search_tilemin.cu): stage 1 of the tile-min-cover key
  search (masked squared key distance + per-128-column tile minimum over the
  bf16 search-layout store), replacing `_search_tilemin_kernel` under the
  contract of `db._search_cover2`.
- `search_tilemin_batch` (a second entry of csrc/search_tilemin.cu): the same
  for B queries, each with its own searchable_n, in one launch that reads the
  store once (what `jax.vmap` of the query makes of the search in block and
  serving modes).
- `cc_labels` (csrc/cc_labels.cu): the 8-connected component labels of N
  masks to their fixpoint in one launch (the lax.while_loop of the JAX
  `ops/descriptor.cc_labels`; the plain version checks its fixpoint on the
  host once a propagate).
- `merge_hints` (csrc/merge_hints.cu): the proposal merge's addProposal
  loop over every candidate row of B queries, its trip count read on the
  device (the lax.while_loop of the JAX `ops/candidate.merge_proposals`;
  the plain version reads its trip count on the host).
- `dyn_pass_scan` and `dyn_post_scan` (csrc/dyn_thres.cu): the two
  DYNAMIC_THRES recurrences of B queries, the re-gating of the cascade and
  the post screens with rising bars (the two lax.scans of the JAX
  `ops/candidate.py`; the plain versions step along the last axis in
  torch.where ops), a warp a row that skips from one rise of the bars to
  the next.

Each wrapper takes its plain twin for CPU tensors only; a CUDA tensor launches
the kernel or raises. The kernels are compiled at first use with nvcc into one
shared library with a plain C interface (loaded with ctypes) under
`build/torch_kernels/` at the repository root, named by a hash of the sources.
Each wrapper counts its kernel launches in its `launches` attribute. The
library also holds the stage marks of csrc/stage_mark.cu (`tracing.mark`),
which compute nothing and are not counted.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from contour_context_tpu_torch.ops.cascade import clamp_ang
from contour_context_tpu_torch.types import device_const

MAX_DIST_SQ = 1e6        # contour_db.h:30, the masked-distance sentinel
TILE = 128               # tile width of the min-cover search (db.TOPK_TILE)
N_DIV = 35               # ring divisions: (RET_KEY_DIM - 3) bins x 5
KEY_DIM = 10             # RET_KEY_DIM
MAX_ANCHORS = 16         # query anchors per level the search kernel stages
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("ring_key.cu", "search_tilemin.cu", "cc_labels.cu",
            "merge_hints.cu", "dyn_thres.cu", "stage_mark.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library from the
    package's csrc/: one nvcc a source, all started together, then one
    link."""
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
        flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC"]
        objs = [BUILD_DIR / f"{p.stem}_{tag}.{os.getpid()}.o" for p in srcs]
        procs = [subprocess.Popen(
            [nvcc] + flags + ["-Xptxas", "-v", "-c", str(p), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, o in zip(srcs, objs)]
        logs = [pr.communicate()[0] for pr in procs]
        failed = [f"{p.name}:\n{log}" for p, pr, log in zip(srcs, procs, logs)
                  if pr.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                             + [str(o) for o in objs],
                             capture_output=True, text=True)
        for o in objs:
            o.unlink()
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        (BUILD_DIR / f"ptxas_{tag}.log").write_text("".join(logs))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cc_ring_key_divs_batch.restype = ci
    lib.cc_ring_key_divs_batch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf,
                                           vp]
    lib.cc_search_tilemin.restype = ci
    lib.cc_search_tilemin.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                      ctypes.c_uint, ci, vp]
    lib.cc_search_tilemin_vector.restype = ci
    lib.cc_search_tilemin_vector.argtypes = [vp, ci]
    lib.cc_search_tilemin_batch.restype = ci
    lib.cc_search_tilemin_batch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                            ctypes.c_uint, ci, vp]
    lib.cc_cc_labels.restype = ci
    lib.cc_cc_labels.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.cc_merge_hints.restype = ci
    lib.cc_merge_hints.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                   cf, cf, cf, cf, cf, vp]
    lib.cc_dyn_pass_scan.restype = ci
    lib.cc_dyn_pass_scan.argtypes = [vp] * 8 + [ci] * 12 + [vp]
    lib.cc_dyn_post_scan.restype = ci
    lib.cc_dyn_post_scan.argtypes = [vp] * 5 + [ci, ci] + [cf] * 6 + [vp]
    lib.cc_stage_mark.restype = ci
    lib.cc_stage_mark.argtypes = [ci, vp]
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

# the kernel's split of a scan's pool (csrc/ring_key.cu): a cluster of
# CLUSTER CTAs a scan, the pool cut into stripes of RING_STRIPE rows, stripe
# s taken by CTA s mod CLUSTER (kCluster and kStripe there; a CPU test reads
# both out of the source)
CLUSTER = 8               # kCluster
RING_STRIPE = 8           # kStripe


def ring_ranks(P: int, device) -> torch.Tensor:
    """(P,) int64: the CTA of the kernel's cluster that sums pool row p,
    (p // RING_STRIPE) mod CLUSTER."""
    return torch.arange(P, device=device) // RING_STRIPE % CLUSTER


def ring_key_divs_batch_plain(anchors_b, pool_b, centers, roi_radius: float):
    """anchors (B, A8, 8) [v0, v1, r_min, r_max, c_min, c_max, _, _] and pool
    (B, P, 8) [p_r, p_c, rowf, colf, higher, ok, _, _] of B scans, centers
    (n_div,) -> divs (B, A8, n_div) = sum_p w exp(-(c_d - dist)^2 / 2) /
    sqrt(2 pi) over the pixels p of the scan's own pool that lie in the
    anchor's box, at dist < roi_radius - 0.01 with ok set, and that count
    (B, A8), both f32 (pallas_kernels.ring_key_divs_reference per scan).

    The sums run in the kernel's order, each op rounded on its own, so the
    kernel equals this bit for bit: rank r of the cluster (`ring_ranks`)
    adds the terms of its counted pixels from 0 in pixel order, then the
    ranks' sums are added from 0 in rank order. Row b depends on scan b
    alone."""
    B, A8, _ = anchors_b.shape
    P = pool_b.shape[1]
    dev = anchors_b.device
    f32 = torch.float32
    an = anchors_b[..., None, :]                                # (B, A8, 1, 8)
    pl = pool_b[:, None]                                        # (B, 1, P, 8)
    in_box = ((pl[..., 0] >= an[..., 2]) & (pl[..., 0] <= an[..., 3])
              & (pl[..., 1] >= an[..., 4]) & (pl[..., 1] <= an[..., 5]))
    dr = pl[..., 2] - an[..., 0]
    dc = pl[..., 3] - an[..., 1]
    dist = torch.sqrt(dr * dr + dc * dc)                        # (B, A8, P)
    lim = float(torch.tensor(roi_radius, dtype=f32) - 1e-2)     # as in f32
    counted = in_box & (dist < lim) & (pl[..., 5] > 0)
    counts = counted.sum(-1).to(f32)

    # each rank's counted pixels in pixel order: sorted by (rank, pixel)
    pix = torch.arange(P, device=dev)
    c = counted.to(torch.int64)
    slot = torch.where(counted, ring_ranks(P, dev), CLUSTER)
    order = torch.sort(slot * P + pix, dim=-1).indices
    n_in = torch.zeros((B, A8, CLUSTER + 1), dtype=torch.int64,
                       device=dev).scatter_add_(-1, slot, c)[..., :CLUSTER]
    first = torch.cumsum(n_in, -1) - n_in
    w = pl[..., 4].expand(B, A8, P)
    acc = torch.zeros((B, A8, CLUSTER, centers.shape[0]), dtype=f32,
                      device=dev)
    for k in range(int(n_in.max()) if n_in.numel() else 0):
        p_k = order.gather(-1, (first + k).clamp(max=P - 1))
        x = centers - dist.gather(-1, p_k)[..., None]
        g = torch.exp(-0.5 * (x * x)) * INV_SQRT_2PI
        acc = torch.where((k < n_in)[..., None],
                          acc + w.gather(-1, p_k)[..., None] * g, acc)
    divs = torch.zeros_like(acc[:, :, 0])
    for r in range(CLUSTER):
        divs = divs + acc[:, :, r]
    return divs, counts


def ring_key_divs_plain(anchors, pool, centers, roi_radius: float):
    """One scan's `ring_key_divs_batch_plain`: anchors (A8, 8), pool (P, 8)
    -> divs (A8, n_div), counts (A8,)."""
    divs, counts = ring_key_divs_batch_plain(anchors[None], pool[None],
                                             centers, roi_radius)
    return divs[0], counts[0]


def _ring_launch(name, anchors_b, pool_b, centers, roi_radius: float):
    """One launch of the ring kernel over the B scans of (B, A8, 8) anchors
    and a (B, P, 8) pool."""
    if anchors_b.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {anchors_b.device}")
    B, A8, P = anchors_b.shape[0], anchors_b.shape[1], pool_b.shape[1]
    _check("anchors", anchors_b, torch.float32, (B, A8, 8))
    _check("pool", pool_b, torch.float32, (B, P, 8))
    _check("centers", centers, torch.float32, (N_DIV,))
    if pool_b.device != anchors_b.device or centers.device != anchors_b.device:
        raise ValueError(f"{name}: inputs on different devices")
    if not 0 < B <= 65535 or A8 > 65535:
        raise ValueError(f"{name}: unsupported B={B} A8={A8}")
    if pool_b.data_ptr() % 16:
        raise ValueError(f"{name}: pool is not 16-byte aligned (the kernel "
                         "loads each row as two float4s)")
    lib = build()
    divs = torch.empty((B, A8, N_DIV), dtype=torch.float32,
                       device=anchors_b.device)
    counts = torch.empty((B, A8), dtype=torch.float32, device=anchors_b.device)
    rc = lib.cc_ring_key_divs_batch(
        anchors_b.data_ptr(), pool_b.data_ptr(), centers.data_ptr(),
        divs.data_ptr(), counts.data_ptr(), B, A8, P, float(roi_radius),
        _stream(anchors_b.device))
    _raise_on(rc, name)
    return divs, counts


def ring_key_divs(anchors, pool, centers, roi_radius: float):
    """Kernel wrapper of `ring_key_divs_plain` (same signature and outputs,
    bit-identical): the B = 1 launch of the batched kernel."""
    if anchors.device.type == "cpu":
        return ring_key_divs_plain(anchors, pool, centers, roi_radius)
    divs, counts = _ring_launch("ring_key_divs", anchors[None], pool[None],
                                centers, roi_radius)
    add_launches({"ring_key_divs": 1})
    return divs[0], counts[0]


ring_key_divs.launches = 0


def ring_key_divs_batch(anchors_b, pool_b, centers, roi_radius: float):
    """Kernel wrapper of `ring_key_divs_batch_plain` (same signature and
    outputs, bit-identical): one launch for the B scans of a block or a
    serving chunk, row b equal to `ring_key_divs` of scan b."""
    if anchors_b.device.type == "cpu":
        return ring_key_divs_batch_plain(anchors_b, pool_b, centers,
                                         roi_radius)
    out = _ring_launch("ring_key_divs_batch", anchors_b, pool_b, centers,
                       roi_radius)
    add_launches({"ring_key_divs_batch": 1})
    return out


ring_key_divs_batch.launches = 0


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
    add_launches({"search_tilemin": 1})
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
    add_launches({"search_tilemin_batch": 1})
    return out


search_tilemin_batch.launches = 0


def search_tilemin_path(keys_q) -> str:
    """The path the C launcher takes for this store: "vector" (one 8-byte
    load of 4 bf16 columns, or 16 bytes of 4 f32 columns, a key dimension)
    or "scalar" (NA % 8 != 0, or a base off 16-byte alignment)."""
    vec = build().cc_search_tilemin_vector(keys_q.data_ptr(), keys_q.shape[2])
    return "vector" if vec else "scalar"


# ---------------------------------------------------------------------------
# connected-component labels to their fixpoint
# ---------------------------------------------------------------------------

CC_BITS = 15              # labels and segment ids share an int32 in the plain
                          # version's flush; the kernel's shared memory too


def _shift(x, d: int, dim: int, fill):
    """x shifted by d along dim (d > 0 moves values to higher indices),
    vacated positions filled with `fill`."""
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if d > 0:
        out.narrow(dim, d, n - d).copy_(x.narrow(dim, 0, n - d))
    else:
        out.narrow(dim, 0, n + d).copy_(x.narrow(dim, -d, n + d))
    return out


def _check_cc(masks) -> None:
    nr, nc = masks.shape[-2:]
    if nr * nc >= 1 << CC_BITS:
        raise ValueError(f"cc_labels packs labels in {CC_BITS} bits: "
                         f"n_row*n_col = {nr * nc} too large")


def cc_labels_plain(masks):
    """masks (..., nr, nc) bool -> labels (..., nr*nc) int32: 8-connected
    components labelled by their minimum linear pixel index, background S.
    Every leading index (a level of a scan) is labelled on its own.

    Each propagate takes the 3x3 window min, then flushes the running min
    along whole foreground runs of every row and then every column. A
    segmented min is a running max of `seg << 15 | (MAXV - label)` with the
    segment id (a cumulative count of background breaks) in the high bits —
    the packing of cc_labels' "hillis" flush, here as torch.cummax (and a
    flipped cummax for the reverse direction). Runs to the fixpoint, so the
    labels do not depend on the number of propagates; one host sync per
    convergence check, for the whole batch: the loop runs until the slowest
    level converges, and more propagates do not change a converged one."""
    _check_cc(masks)
    lead, (nr, nc) = masks.shape[:-2], masks.shape[-2:]
    masks = masks.reshape(-1, nr, nc)
    S = nr * nc
    MAXV = (1 << CC_BITS) - 1
    dev = masks.device
    lin = torch.arange(S, dtype=torch.int32, device=dev).reshape(nr, nc)
    lab = torch.where(masks, lin[None], S)
    brk = (~masks).to(torch.int32)
    segs = {}
    for dim in (1, 2):
        seg_f = torch.cumsum(brk, dim).to(torch.int32) << CC_BITS
        seg_r = torch.flip(torch.cumsum(torch.flip(brk, (dim,)), dim),
                           (dim,)).to(torch.int32) << CC_BITS
        segs[dim] = (seg_f, seg_r)

    def run_min(x, dim):
        seg_f, seg_r = segs[dim]
        neg = MAXV - x
        f = torch.cummax(seg_f | neg, dim).values & MAXV
        r = torch.flip(torch.cummax(torch.flip(seg_r | neg, (dim,)), dim)
                       .values, (dim,)) & MAXV
        return MAXV - torch.maximum(f, r)

    def propagate(x):
        m = torch.minimum(x, torch.minimum(_shift(x, 1, 1, S),
                                           _shift(x, -1, 1, S)))
        m = torch.minimum(m, torch.minimum(_shift(m, 1, 2, S),
                                           _shift(m, -1, 2, S)))
        new = torch.where(masks, torch.minimum(x, m), S)
        new = torch.where(masks, run_min(new, 2), S)
        return torch.where(masks, run_min(new, 1), S)

    # 4 propagates reach the fixpoint on typical scans; then check and loop
    # (each propagate lowers some label or changes nothing, so S bound it)
    for _ in range(3):
        lab = propagate(lab)
    for _ in range(S):
        new = propagate(lab)
        if torch.equal(new, lab):           # host sync
            return lab.reshape(lead + (S,))
        lab = new
    raise RuntimeError("cc_labels did not converge")


def cc_labels(masks):
    """Kernel wrapper of `cc_labels_plain` (same signature and outputs; the
    answer is unique, so the kernel's union-find equals the plain
    version's propagation bit for bit): one launch labels every mask to
    its fixpoint, with no host sync."""
    if masks.device.type == "cpu":
        return cc_labels_plain(masks)
    if masks.device.type != "cuda":
        raise ValueError(f"cc_labels: unsupported device {masks.device}")
    _check_cc(masks)
    lead, (nr, nc) = masks.shape[:-2], masks.shape[-2:]
    _check("masks", masks, torch.bool)
    N = math.prod(lead)
    lib = build()
    labels = torch.empty(lead + (nr * nc,), dtype=torch.int32,
                         device=masks.device)
    rc = lib.cc_cc_labels(masks.data_ptr(), labels.data_ptr(), N, nr, nc,
                          _stream(masks.device))
    _raise_on(rc, "cc_labels")
    add_launches({"cc_labels": 1})
    return labels


cc_labels.launches = 0


# ---------------------------------------------------------------------------
# the proposal merge's addProposal loop
# ---------------------------------------------------------------------------

P_PROP = 4               # proposals a candidate row holds
TF_TRANS_MERGE = 2.0     # addProposal's merge radius (BEV cells)
TF_ANG_MERGE = 0.3       # and angle (rad)


def merge_hints_plain(hint_of, T, votes):
    """The addProposal loop of B queries' candidate rows (the body of
    candidate.merge_proposals' loop): hint_of (B, C, MP) int32, the hint
    that arrives j-th at row c (-1 past the row's last), T (B, MP, 3) f32
    hint poses, votes (B, MP) int32 their pair counts -> prop_T (B, C,
    P_PROP, 3) f32, prop_votes (B, C, P_PROP) int32, prop_n (B, C) int32,
    key_of_m (B, MP) int32 (the proposal c * P_PROP + slot each hint went
    to, -1 none). The loop runs over the j-th hint of every row of every
    query at once, its trip count the busiest row's (one host sync); a row
    with fewer hints idles through the rest."""
    dev = hint_of.device
    B, C, MP = hint_of.shape
    i32, f32 = torch.int32, torch.float32
    nj = int(torch.where(hint_of >= 0, torch.arange(1, MP + 1, device=dev,
                                                    dtype=i32), 0).max()) \
        if hint_of.numel() else 0                            # host sync
    rows = torch.arange(C, dtype=i32, device=dev)
    slot_iota = torch.arange(P_PROP, dtype=i32, device=dev)
    prop_T = torch.zeros((B, C, P_PROP, 3), dtype=f32, device=dev)
    prop_votes = torch.zeros((B, C, P_PROP), dtype=i32, device=dev)
    prop_n = torch.zeros((B, C), dtype=i32, device=dev)
    key_of_m = torch.full((B, MP + 1), -1, dtype=i32, device=dev)
    for j in range(nj):
        m_c = hint_of[:, :, j]
        act = m_c >= 0
        mm = m_c.clamp(0, MP - 1).long()
        T_m = T.gather(1, mm[..., None].expand(B, C, 3))       # (B, C, 3)
        w2 = votes.gather(1, mm)
        c_m, s_m = torch.cos(T_m[..., 2:3]), torch.sin(T_m[..., 2:3])
        dx = prop_T[..., 0] - T_m[..., 0:1]
        dy = prop_T[..., 1] - T_m[..., 1:2]
        tx = c_m * dx + s_m * dy
        ty = -s_m * dx + c_m * dy
        dth = clamp_ang(prop_T[..., 2] - T_m[..., 2:3])
        in_use = slot_iota < prop_n[..., None]
        match = in_use & (torch.hypot(tx, ty) < TF_TRANS_MERGE) & \
            (dth.abs() < TF_ANG_MERGE)
        has_match = match.any(dim=-1)
        first = torch.argmax(match.to(torch.uint8), dim=-1).to(i32)
        can_append = prop_n < P_PROP
        slot = torch.where(has_match, first,
                           torch.clamp(prop_n, max=P_PROP - 1))
        write = act & (has_match | can_append)
        oh = slot_iota == slot[..., None]
        old_T = torch.where(oh[..., None], prop_T, 0.0).sum(dim=-2)
        w1 = torch.where(oh, prop_votes, 0).sum(dim=-1).to(i32)
        wsum = torch.clamp(w1 + w2, min=1).to(f32)
        trans = (old_T[..., :2] * w1[..., None]
                 + T_m[..., :2] * w2[..., None]) / wsum[..., None]
        diff = T_m[..., 2] - old_T[..., 2]
        diff = torch.where(diff < 0, diff + 2 * math.pi, diff)
        diff = torch.where(diff > math.pi, diff - 2 * math.pi, diff)
        ang = diff * w2.to(f32) / wsum + old_T[..., 2]
        T_merged = torch.cat([trans, ang[..., None]], dim=-1)
        new_T = torch.where(has_match[..., None], T_merged, T_m)
        new_votes = torch.where(has_match, w1 + w2, w2)
        wsel = write[..., None] & oh
        prop_T = torch.where(wsel[..., None], new_T[..., None, :], prop_T)
        prop_votes = torch.where(wsel, new_votes[..., None], prop_votes)
        prop_n = prop_n + (write & ~has_match).to(i32)
        key_of_m.scatter_(1, torch.where(write, mm, MP),
                          rows * P_PROP + slot)
    return prop_T, prop_votes, prop_n, key_of_m[:, :MP]


def merge_hints(hint_of, T, votes):
    """Kernel wrapper of `merge_hints_plain` (same signature and outputs,
    bit-identical on the card): one launch, a thread a candidate row
    walking its hints in arrival order, the trip count read on the
    device."""
    if hint_of.device.type == "cpu":
        return merge_hints_plain(hint_of, T, votes)
    if hint_of.device.type != "cuda":
        raise ValueError(f"merge_hints: unsupported device {hint_of.device}")
    B, C, MP = hint_of.shape
    _check("hint_of", hint_of, torch.int32)
    _check("T", T, torch.float32, (B, MP, 3))
    _check("votes", votes, torch.int32, (B, MP))
    if T.device != hint_of.device or votes.device != hint_of.device:
        raise ValueError("merge_hints: inputs on different devices")
    lib = build()
    dev = hint_of.device
    prop_T = torch.empty((B, C, P_PROP, 3), dtype=torch.float32, device=dev)
    prop_votes = torch.empty((B, C, P_PROP), dtype=torch.int32, device=dev)
    prop_n = torch.empty((B, C), dtype=torch.int32, device=dev)
    key_of_m = torch.empty((B, MP), dtype=torch.int32, device=dev)
    # the host scalars as torch's CUDA kernels take them: float32, and a
    # division by one as a product with its float32 reciprocal
    two_pi = np.float32(2 * math.pi)
    rc = lib.cc_merge_hints(
        hint_of.data_ptr(), T.data_ptr(), votes.data_ptr(), prop_T.data_ptr(),
        prop_votes.data_ptr(), prop_n.data_ptr(), key_of_m.data_ptr(), B, C,
        MP, float(np.float32(math.pi)), float(two_pi),
        float(np.float32(1.0) / two_pi), TF_TRANS_MERGE, TF_ANG_MERGE,
        _stream(dev))
    _raise_on(rc, "merge_hints")
    add_launches({"merge_hints": 1})
    return prop_T, prop_votes, prop_n, key_of_m


merge_hints.launches = 0


# ---------------------------------------------------------------------------
# the two DYNAMIC_THRES recurrences
# ---------------------------------------------------------------------------

def dyn_pass_scan_plain(pass1, ovlp_sum, ovlp_max1, in_ang, indiv, orie,
                        lb, ub):
    """The re-gating of the check cascade under DYNAMIC_THRES
    (contour_db.h:439-458; the lax.scan of the JAX
    `ops/candidate.dynamic_pass_scan`): pass1 (..., H) bool and the five
    (..., H) integer pair counts of each hint in check order, `lb` and `ub`
    five ints each (the bars of ovlp_sum, ovlp_max1, in_ang, indiv, orie)
    -> (pass2, pass3) (..., H) bool. The working bars start at lb; hint t
    passes check 2 iff pass1 and its first three counts reach bars 0-2,
    check 3 iff check 2 and its last two reach bars 3-4, and a check-3 pass
    raises every bar to min(max(bar, orie_t), ub). Every leading index
    advances together, one step of torch.where ops a hint on the inputs'
    device: no host sync."""
    shape = tuple(pass1.shape)
    H = shape[-1]
    if H == 0 or pass1.numel() == 0:
        return (torch.zeros(shape, dtype=torch.bool, device=pass1.device),
                torch.zeros(shape, dtype=torch.bool, device=pass1.device))
    dev = pass1.device
    i32 = torch.int32
    p1 = pass1.reshape(-1, H).to(torch.bool)
    cnt = torch.stack([x.reshape(-1, H).to(i32) for x in (
        ovlp_sum, ovlp_max1, in_ang, indiv, orie)], dim=-1)   # (R, H, 5)
    bars = device_const(tuple(int(v) for v in lb), i32, dev) \
        .expand(p1.shape[0], 5)
    ubv = device_const(tuple(int(v) for v in ub), i32, dev)
    out2, out3 = [], []
    for t in range(H):
        x = cnt[:, t]
        p2 = p1[:, t] & (x[:, 0:3] >= bars[:, 0:3]).all(dim=1)
        p3 = p2 & (x[:, 3:5] >= bars[:, 3:5]).all(dim=1)
        raised = torch.minimum(torch.maximum(bars, x[:, 4:5]), ubv)
        bars = torch.where(p3[:, None], raised, bars)
        out2.append(p2)
        out3.append(p3)
    return (torch.stack(out2, dim=-1).reshape(shape),
            torch.stack(out3, dim=-1).reshape(shape))


def dyn_pass_scan(pass1, ovlp_sum, ovlp_max1, in_ang, indiv, orie, lb, ub):
    """Kernel wrapper of `dyn_pass_scan_plain` (same signature and outputs,
    bit-identical): one launch for every leading index, a warp a row, 8
    hints a lane, one ballot round for each lane whose hints raise the
    bars."""
    if pass1.device.type == "cpu":
        return dyn_pass_scan_plain(pass1, ovlp_sum, ovlp_max1, in_ang, indiv,
                                   orie, lb, ub)
    if pass1.device.type != "cuda":
        raise ValueError(f"dyn_pass_scan: unsupported device {pass1.device}")
    shape = tuple(pass1.shape)
    if not shape:
        raise ValueError("dyn_pass_scan: pass1 is 0-d, expected (..., HC)")
    H = shape[-1]
    pass1 = pass1.contiguous()
    _check("pass1", pass1, torch.bool)
    cols = [x.to(torch.int32).contiguous() for x in (
        ovlp_sum, ovlp_max1, in_ang, indiv, orie)]
    for name, x in zip(("ovlp_sum", "ovlp_max1", "in_ang", "indiv", "orie"),
                       cols):
        if tuple(x.shape) != shape or x.device != pass1.device:
            raise ValueError(f"dyn_pass_scan: {name} {tuple(x.shape)} on "
                             f"{x.device}, expected {shape} on "
                             f"{pass1.device}")
    if len(lb) != 5 or len(ub) != 5:
        raise ValueError("dyn_pass_scan: five lower and five upper bars")
    lib = build()
    pass2 = torch.empty(shape, dtype=torch.bool, device=pass1.device)
    pass3 = torch.empty(shape, dtype=torch.bool, device=pass1.device)
    rc = lib.cc_dyn_pass_scan(
        pass1.data_ptr(), *[x.data_ptr() for x in cols], pass2.data_ptr(),
        pass3.data_ptr(), math.prod(shape[:-1]), H, *[int(v) for v in lb],
        *[int(v) for v in ub], _stream(pass1.device))
    _raise_on(rc, "dyn_pass_scan")
    add_launches({"dyn_pass_scan": 1})
    return pass2, pass3


dyn_pass_scan.launches = 0


def dyn_post_scan_plain(in_use, area, neg_d, corr0, lb, ub):
    """The post-processing screens under DYNAMIC_THRES (contour_db.h:
    532-574; the lax.scan of the JAX `ops/candidate.dynamic_post_scan`):
    in_use (..., C) bool and the float32 area %, distance censor and init
    correlation of each candidate row in first-seen order, `lb` and `ub`
    three floats each (taken as float32) -> keep (..., C) bool. Row t is
    kept iff in use and its three scores reach the working bars (which
    start at lb); a kept row raises the bars to min(max(bar, score), ub).
    One step of torch.where ops a row on the inputs' device: no host
    sync; min, max and >= round nothing."""
    shape = tuple(in_use.shape)
    C = shape[-1]
    if C == 0 or in_use.numel() == 0:
        return torch.zeros(shape, dtype=torch.bool, device=in_use.device)
    dev = in_use.device
    f32 = torch.float32
    use = in_use.reshape(-1, C).to(torch.bool)
    v = torch.stack([x.reshape(-1, C).to(f32) for x in (area, neg_d, corr0)],
                    dim=-1)                                  # (R, C, 3)
    bars = device_const(tuple(float(x) for x in lb), f32, dev) \
        .expand(use.shape[0], 3)
    ubv = device_const(tuple(float(x) for x in ub), f32, dev)
    keep = []
    for t in range(C):
        x = v[:, t]
        k = use[:, t] & (x >= bars).all(dim=1)
        bars = torch.where(k[:, None],
                           torch.minimum(torch.maximum(bars, x), ubv), bars)
        keep.append(k)
    return torch.stack(keep, dim=-1).reshape(shape)


def dyn_post_scan(in_use, area, neg_d, corr0, lb, ub):
    """Kernel wrapper of `dyn_post_scan_plain` (same signature and output,
    bit-identical, a NaN upper bar included): one launch, a warp a row
    that skips from one rise of the bars to the next."""
    if in_use.device.type == "cpu":
        return dyn_post_scan_plain(in_use, area, neg_d, corr0, lb, ub)
    if in_use.device.type != "cuda":
        raise ValueError(f"dyn_post_scan: unsupported device {in_use.device}")
    shape = tuple(in_use.shape)
    if not shape:
        raise ValueError("dyn_post_scan: in_use is 0-d, expected (..., C)")
    C = shape[-1]
    in_use = in_use.contiguous()
    _check("in_use", in_use, torch.bool)
    vals = [x.to(torch.float32).contiguous() for x in (area, neg_d, corr0)]
    for name, x in zip(("area", "neg_d", "corr0"), vals):
        if tuple(x.shape) != shape or x.device != in_use.device:
            raise ValueError(f"dyn_post_scan: {name} {tuple(x.shape)} on "
                             f"{x.device}, expected {shape} on "
                             f"{in_use.device}")
    if len(lb) != 3 or len(ub) != 3:
        raise ValueError("dyn_post_scan: three lower and three upper bars")
    lib = build()
    keep = torch.empty(shape, dtype=torch.bool, device=in_use.device)
    # ctypes.c_float rounds each bar to float32, as the plain version does
    rc = lib.cc_dyn_post_scan(
        in_use.data_ptr(), *[x.data_ptr() for x in vals], keep.data_ptr(),
        math.prod(shape[:-1]), C, *[float(x) for x in lb],
        *[float(x) for x in ub],
        _stream(in_use.device))
    _raise_on(rc, "dyn_post_scan")
    add_launches({"dyn_post_scan": 1})
    return keep


dyn_post_scan.launches = 0


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

WRAPPERS = (ring_key_divs, ring_key_divs_batch, search_tilemin,
            search_tilemin_batch, cc_labels, merge_hints, dyn_pass_scan,
            dyn_post_scan)


def launch_counts() -> dict:
    """{wrapper name: launches counted}, every kernel of the port."""
    return {w.__name__: w.launches for w in WRAPPERS}


_COUNT_LOCK = threading.Lock()
_CAPTURING = threading.local()


def add_launches(counts: dict) -> None:
    """Add {wrapper name: n} to the counts: a wrapper's launch, or a CUDA
    graph's launches of each kernel, once a replay (a replay runs no
    wrapper). Under a lock: the online spinner counts from its own
    thread. Inside `recording_launches` this thread's launches go to the
    recording instead."""
    rec = getattr(_CAPTURING, "launches", None)
    if rec is not None:
        for k, n in counts.items():
            rec[k] = rec.get(k, 0) + n
        return
    with _COUNT_LOCK:
        for w in WRAPPERS:
            w.launches += counts.get(w.__name__, 0)


@contextlib.contextmanager
def recording_launches():
    """Yields {wrapper name: n}, the launches this thread's wrappers make
    inside the block, which are not counted: a CUDA graph capture records
    its kernels and runs none (other threads count as usual)."""
    prev = getattr(_CAPTURING, "launches", None)
    _CAPTURING.launches = rec = {}
    try:
        yield rec
    finally:
        _CAPTURING.launches = prev


def reset_launches() -> None:
    with _COUNT_LOCK:
        for w in WRAPPERS:
            w.launches = 0
