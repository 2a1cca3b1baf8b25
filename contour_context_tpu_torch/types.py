"""Fixed-shape per-scan descriptor as a NamedTuple of torch tensors.

Same 24 leaves, order, shapes and dtypes as `contour_context_tpu.types.ScanDesc`
(L = levels, K = max contours/level, A = anchors/level, M = BCI neighbour
slots, G/Kg = GMM levels/ellipses). A "stacked" ScanDesc (the DB store) has
one extra leading axis on every leaf.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from contour_context_tpu_torch.config import (
    NUM_BIN_KEY_LAYER,
    RET_KEY_DIM,
    ContourManagerConfig,
    GMMOptConfig,
)


class ScanDesc(NamedTuple):
    cnt: torch.Tensor            # (L, K) int16
    valid: torch.Tensor          # (L, K) bool
    mean: torch.Tensor           # (L, K, 2) f32
    eig_vals: torch.Tensor       # (L, K, 2) f32
    eig_vecs: torch.Tensor       # (L, K, 2, 2) f32
    manual_cov: torch.Tensor     # (L, K, 2, 2) f32
    vol3_mean: torch.Tensor      # (L, K) f32
    com_r: torch.Tensor          # (L, K) f32
    ecc_feat: torch.Tensor       # (L, K) bool
    cont_perc: torch.Tensor      # (L, K) f32
    layer_cell_cnt: torch.Tensor  # (L,) int32
    n_cont: torch.Tensor         # (L,) int32
    keys: torch.Tensor           # (L, A, 10) f32
    nei_valid: torch.Tensor      # (L, A, M) bool
    nei_level: torch.Tensor      # (L, A, M) int8
    nei_seq: torch.Tensor        # (L, A, M) int8
    nei_bit: torch.Tensor        # (L, A, M) int16
    nei_theta: torch.Tensor      # (L, A, M) f32
    gmm_mask: torch.Tensor       # (L, K) bool
    auto_corr: torch.Tensor      # () f32
    pix_overflow: torch.Tensor   # () int32
    gmm_overflow: torch.Tensor   # () int32
    tab12: torch.Tensor          # (4, 10, 12) f32
    gmm_pack: torch.Tensor       # (G*Kg*8,) f32


def scan_desc_spec(cm: ContourManagerConfig, gmm: GMMOptConfig) -> dict:
    """{leaf name: (shape, torch dtype)} of one scan's ScanDesc."""
    L, K, A = cm.n_levels, cm.max_contours, cm.piv_firsts
    M = NUM_BIN_KEY_LAYER * cm.dist_firsts
    G, Kg = len(gmm.levels), gmm.max_gmm_ellipses
    f32, i32, b = torch.float32, torch.int32, torch.bool
    return dict(
        cnt=((L, K), torch.int16), valid=((L, K), b), mean=((L, K, 2), f32),
        eig_vals=((L, K, 2), f32), eig_vecs=((L, K, 2, 2), f32),
        manual_cov=((L, K, 2, 2), f32), vol3_mean=((L, K), f32),
        com_r=((L, K), f32), ecc_feat=((L, K), b), cont_perc=((L, K), f32),
        layer_cell_cnt=((L,), i32), n_cont=((L,), i32),
        keys=((L, A, RET_KEY_DIM), f32), nei_valid=((L, A, M), b),
        nei_level=((L, A, M), torch.int8), nei_seq=((L, A, M), torch.int8),
        nei_bit=((L, A, M), torch.int16), nei_theta=((L, A, M), f32),
        gmm_mask=((L, K), b), auto_corr=((), f32), pix_overflow=((), i32),
        gmm_overflow=((), i32), tab12=((NUM_BIN_KEY_LAYER, 10, 12), f32),
        gmm_pack=((G * Kg * 8,), f32),
    )


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A small constant tensor (config levels, grads), made once per device:
    a fresh torch.tensor(..., device="cuda") per scan would be a pageable
    host-to-device copy that waits for the stream. Callers must not write
    to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def scan_desc_from_numpy(desc, device="cpu") -> ScanDesc:
    """Any ScanDesc-shaped NamedTuple of array-likes (e.g. a JAX ScanDesc
    after jax.device_get) -> torch ScanDesc on `device`, leaf for leaf."""
    return ScanDesc(*[torch.from_numpy(np.array(x, copy=True)).to(device)
                      for x in desc])


def scan_desc_to_numpy(desc: ScanDesc) -> ScanDesc:
    """Torch ScanDesc -> the same NamedTuple holding numpy arrays."""
    return ScanDesc(*[x.detach().cpu().numpy() for x in desc])
