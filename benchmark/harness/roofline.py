"""The chip's published peaks and the least time of each kernel's logical
work: frozen copies of the port's `kernel_times.ring_bound`,
`tilemin_bound`, `tilemin_batch_bound`, `cc_bound`, `merge_bound` and
`merge_chain_bound`.

A kernel's least time is the larger of its bytes over the peak memory
bandwidth and its operations over the peak rate that bounds them, where
the bytes are its logical inputs read once and outputs written once and
the operations are what these inputs need. The reference records the
inputs of each call (`plainref.kernels.recording`), so the count is of
the work itself, whatever kernel or fusion carries it.
"""

from __future__ import annotations

# NVIDIA H100 SXM, NVIDIA's data sheet (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SMS = 132
MAX_SM_CLOCK_HZ = 1.98e9
MUFU_PER_CLK_SM = 16       # expf (ex2) results a clock on each SM, cc 9.0

N_DIV = 35                 # ring divisions
TILE = 128                 # tile width of the key search
P_PROP = 4                 # proposals a candidate row holds
MERGE_CHAIN_STEPS = 26     # dependent steps of one hint on the merge walk

# the names of the port's own kernels in a device trace
PORT_KERNELS = ("ring_key_divs_kernel", "search_tilemin_kernel",
                "search_tilemin_batch_kernel", "cc_labels_kernel",
                "merge_hints_kernel", "dyn_pass_scan_kernel",
                "dyn_post_scan_kernel")


def _bound_us(n_bytes: float, t_ops_s: float) -> float:
    return 1e6 * max(n_bytes / HBM_BYTES_PER_S, t_ops_s)


def ring_us(anchors, pool, centers: int, counted: float) -> float:
    """anchors (B, A8, 8) and pool (B, P, 8) f32, `centers` divisions,
    `counted` pixels counted over every anchor: inputs read once, divs and
    counts written once, one expf a (counted pixel, division)."""
    n_in = 4 * (anchors[0] * anchors[1] * anchors[2]
                + pool[0] * pool[1] * pool[2] + centers)
    n_out = 4 * anchors[0] * anchors[1] * (N_DIV + 1)
    exps = counted * N_DIV
    return _bound_us(n_in + n_out,
                     exps / (MUFU_PER_CLK_SM * SMS * MAX_SM_CLOCK_HZ))


def tilemin_us(keys_q, key_bytes: int, q, searchable) -> float:
    """keys_q (L, D, NA), q (Q, A, D) of each query, `searchable` the
    searchable scans of each of the B queries: the keys of the columns
    searchable for any query read once (Q levels x D dims), the queries and
    limits once, the tile minima written once; 3 flops a (query, level,
    anchor, column, dim)."""
    L, D, NA = keys_q
    Q, A, _ = q
    B = len(searchable)
    cols = [min(NA, max(0, int(s)) * A) for s in searchable]
    n_tiles = -(-NA // TILE)
    n_bytes = (Q * D * max(cols) * key_bytes + B * Q * A * D * 4
               + (8 if B == 1 else 4 * B) + B * Q * A * n_tiles * 4)
    return _bound_us(n_bytes, 3 * D * Q * A * sum(cols) / FP32_FLOPS)


def cc_us(masks: int) -> float:
    """Each mask byte read once, each int32 label written once."""
    return _bound_us(5 * masks, 0.0)


def merge_us(shape, ids: int, hints: int, longest: int) -> float:
    """hint_of (B, C, MP): each row's ids read up to its first -1, the pose
    and votes of each hint present once, the proposals written once; or the
    walk's serial chain, the longest row's hints one after another."""
    B, C, MP = shape
    n_bytes = 4 * ids + hints * (3 * 4 + 4) + 4 * (B * C * P_PROP * 4 + B * C
                                                  + B * MP)
    return _bound_us(n_bytes, longest * MERGE_CHAIN_STEPS / MAX_SM_CLOCK_HZ)


def least_us(kernel: str, info: dict) -> float:
    """The least time of one recorded call (`plainref.kernels._note`)."""
    if kernel == "ring":
        return ring_us(info["anchors"], info["pool"], info["centers"],
                       info["counted"])
    if kernel == "tilemin":
        return tilemin_us(info["keys_q"], info["key_bytes"], info["q"],
                          info["searchable"])
    if kernel == "cc":
        return cc_us(info["masks"])
    if kernel == "merge":
        return merge_us(info["shape"], info["ids"], info["hints"],
                        info["longest"])
    raise KeyError(kernel)
