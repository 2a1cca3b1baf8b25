"""The plain torch twins of the port's CUDA kernels, frozen for the
benchmark's reference: the ring-key contraction, the tile-min key search
(single and batched), the CC labels and the proposal merge's walk, and
the two DYNAMIC_THRES recurrences. Each entry point the reference's
stages call is the plain function itself; no kernel is built or loaded.

`recording(rec)` collects, for every call of the four kernels that the
port runs on its default path, the inputs its least time depends on
(`harness.roofline` turns them into bytes and operations).
"""

from __future__ import annotations

import contextlib
import math

import torch

from plainref.cascade import clamp_ang
from plainref.types import device_const

MAX_DIST_SQ = 1e6        # contour_db.h:30, the masked-distance sentinel
TILE = 128               # tile width of the min-cover search (db.TOPK_TILE)
N_DIV = 35               # ring divisions: (RET_KEY_DIM - 3) bins x 5
KEY_DIM = 10             # RET_KEY_DIM
MAX_ANCHORS = 16         # query anchors per level the search kernel stages
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


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


class _Recorder:
    """Where `recording` sends each kernel call's bound inputs."""
    sink = None


@contextlib.contextmanager
def recording(rec: list):
    """Append (kernel, {name: value}) for every kernel call inside the
    block to `rec`: the shapes and the data-dependent counts that the
    kernel's least time needs."""
    prev, _Recorder.sink = _Recorder.sink, rec
    try:
        yield rec
    finally:
        _Recorder.sink = prev


def _note(kernel: str, **kw) -> None:
    if _Recorder.sink is not None:
        _Recorder.sink.append((kernel, kw))


def ring_key_divs_batch(anchors_b, pool_b, centers, roi_radius: float):
    divs, counts = ring_key_divs_batch_plain(anchors_b, pool_b, centers,
                                             roi_radius)
    _note("ring", anchors=tuple(anchors_b.shape), pool=tuple(pool_b.shape),
          centers=int(centers.numel()), counted=float(counts.sum()))
    return divs, counts


def ring_key_divs(anchors, pool, centers, roi_radius: float):
    divs, counts = ring_key_divs_batch(anchors[None], pool[None], centers,
                                       roi_radius)
    return divs[0], counts[0]


def search_tilemin(keys_q, q_levels, q, state):
    _note("tilemin", keys_q=tuple(keys_q.shape),
          key_bytes=keys_q.element_size(), q=tuple(q.shape)[-3:],
          searchable=[int(state[1])])
    return search_tilemin_plain(keys_q, q_levels, q, state)


def search_tilemin_batch(keys_q, q_levels, q_b, searchable_b):
    _note("tilemin", keys_q=tuple(keys_q.shape),
          key_bytes=keys_q.element_size(), q=tuple(q_b.shape)[-3:],
          searchable=[int(s) for s in searchable_b.tolist()])
    return search_tilemin_batch_plain(keys_q, q_levels, q_b, searchable_b)


def cc_labels(masks):
    _note("cc", masks=int(masks.numel()))
    return cc_labels_plain(masks)


def merge_hints(hint_of, T, votes):
    if _Recorder.sink is not None:
        lead = (hint_of >= 0).to(torch.int32).cumprod(-1).sum(-1)
        _note("merge", shape=tuple(hint_of.shape),
              ids=int(torch.clamp(lead + 1, max=hint_of.shape[-1]).sum()),
              hints=int((hint_of >= 0).sum()),
              longest=int((hint_of >= 0).sum(-1).max())
              if hint_of.numel() else 0)
    return merge_hints_plain(hint_of, T, votes)


dyn_pass_scan = dyn_pass_scan_plain
dyn_post_scan = dyn_post_scan_plain
