"""The check cascade's plain twin and the kernel's algorithm on the CPU.

On a CUDA tensor `db.cascade_chunked` and `db.gather_and_cascade` are one
launch of csrc/cascade.cu (`kernels.cascade`); on a CPU tensor they run its
plain twin, the torch body (`ops/cascade.run_cascade`, its Umeyama sums in
the kernel's order). The card tests hold the kernel to the twin bit for bit;
this file holds:

- the twin against JAX's `_gather_and_cascade_impl` / `run_cascade`, ints
  and bools exactly, floats within 1e-4 (test_torch_query.py's band), on
  hint rows made to take each edge of the cascade: no close pair (n_pot 0),
  more close pairs than p_pot (pot_overflow), a window longer than 63
  (win_overflow), angles across the +-pi wrap, equal angles (ties in the
  stable sort), hint_valid false, no shaft pick, a degenerate target shaft
  (tgt_shaft_nan), the orientation screen and check 3 removing pairs,
  negative and out-of-range levels and seqs; at p_pot 8, 128 and None
  (512);
- `cascade_chunked` against JAX's `_cascade_chunked` with the squeezed caps
  (HC 96, W 40: a clamped last chunk) and the default ones, B = 3 queries
  with their own n_valid, +0.0 past each query's own chunks;
- the flat H = Q*A*K call the host spec query makes (900 rows, one query);
- a numpy copy of the kernel's algorithm (`_kernel_rows`: the close pairs
  ranked by their 64-bit keys, the window by binary search and one packed
  maximum, the compacted slot order by counting, the shaft from the first
  10 compacted slots, the Umeyama sums as the halving tree of the shuffles)
  against the twin on the edge rows and on every 8th row of the host spec
  query's: ints and bools exactly, floats within 1e-5;
- the kernel source's constants against the twin's, and the CPU path never
  building or launching the kernel library.
"""

import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch import kernel_times as kt
from contour_context_tpu_torch.ops import cascade as tcasc
from contour_context_tpu_torch.ops import kernels

torch.set_num_threads(2)

L, A, M, J, L12 = 6, 6, 40, 10, 4
NEI = ("nei_valid", "nei_level", "nei_seq", "nei_bit", "nei_theta")
SRC = Path(tcasc.__file__).resolve().parent.parent / "csrc" / "cascade.cu"
KINDS = kt.CASCADE_KINDS


def _torch(d):
    return SimpleNamespace(**{k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in d.items()})


def _jax_scan(d, b=None):
    return SimpleNamespace(**{k: jnp.asarray(v if b is None else v[b])
                              for k, v in d.items()})


def _assert_equal(port, want, what, rtol=1e-4, atol=1e-4):
    for field, a, b in zip(tcasc.CascadeResult._fields, port, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"{what}: {field}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {field}")


def _twin_rows(store, query, hints, tgt_q, p_pot, cfg):
    return tdb.gather_and_cascade(
        _torch(store), _torch(query), torch.from_numpy(tgt_q),
        *[torch.from_numpy(hints[k]) for k in ("gidx", "level", "seq_src",
                                               "seq_tgt", "hv")],
        cfg.thres_lb, cfg.db.cont_sim, p_pot)


def _jax_rows(store, query, hints, tgt_q, p_pot, cfg):
    """JAX's _gather_and_cascade_impl hint by hint group: one call for the
    hints of each query."""
    from contour_context_tpu import db as jdb

    js = _jax_scan(store)
    out = None
    for b in np.unique(tgt_q):
        sel = np.flatnonzero(tgt_q == b)
        r = jax.device_get(jdb._gather_and_cascade_impl(
            js, _jax_scan(query, b), *[hints[k][sel] for k in (
                "gidx", "level", "seq_src", "seq_tgt", "hv")],
            cfg.thres_lb, cfg.db.cont_sim, p_pot))
        if out is None:
            out = [np.zeros((len(tgt_q),) + np.shape(x)[1:], np.asarray(x)
                            .dtype) for x in r]
        for o, x in zip(out, r):
            o[sel] = x
    return out


@pytest.fixture(scope="module")
def edges():
    """The edge rows, twice each (two seeds' neighbour tables): the rows the
    card tests hold the kernel to its twin on."""
    return kt.cascade_edge_rows((3, 4))


CFGS = (jconfig.PipelineConfig(), tconfig.PipelineConfig())


@pytest.mark.parametrize("p_pot", [8, 128, None])
def test_twin_matches_jax_on_edge_rows(edges, p_pot):
    """The twin (`db.gather_and_cascade` on CPU tensors) equals JAX's
    cascade on the rows made to take each edge, at p_pot 8, 128 and None
    (512), and each edge is taken."""
    store, query, hints = edges
    H = len(hints["gidx"])
    tgt_q = np.arange(H)
    res = _twin_rows(store, query, hints, tgt_q, p_pot, CFGS[1])
    _assert_equal([x.numpy() for x in res],
                  _jax_rows(store, query, hints, tgt_q, p_pot, CFGS[0]),
                  f"p_pot {p_pot}")
    kind = {k: [h for h in range(H) if KINDS[h % len(KINDS)] == k]
            for k in KINDS}
    r = SimpleNamespace(**{f: x.numpy() for f, x in res._asdict().items()})
    assert (r.in_ang_rng[kind["no close"]] == 0).all()
    assert (r.in_ang_rng[kind["none valid"]] == 0).all()
    assert r.pot_overflow[kind["pot overflow"]].all()
    assert not r.pot_overflow[kind["plain"]].any() or p_pot == 8
    if p_pot != 8:
        assert r.win_overflow[kind["win overflow"]].all()
        assert (r.in_ang_rng[kind["win overflow"]] > 63).all()
    assert not r.pass1[kind["hv false"]].any()
    assert r.pass3[kind["plain"]].any() and r.pass2.sum() >= 6
    assert (r.i_orie_sim[kind["screen"]]
            < r.i_indiv_sim[kind["screen"]]).any()
    assert (r.i_orie_sim[kind["tgt shaft degenerate"]]
            == r.i_indiv_sim[kind["tgt shaft degenerate"]]).all()


@pytest.mark.parametrize("case", ["squeezed", "default"])
def test_chunked_twin_matches_jax(case):
    """`cascade_chunked` on CPU tensors (the twin) for B = 3 queries, each
    with its own n_valid, equals JAX's `_cascade_chunked` of each query:
    ints and bools exactly, floats in 1e-4, +0.0 bit for bit past each
    query's own ceil(n_valid / W) * W columns. The squeezed caps (HC 96, W
    40) clamp the last chunk's start."""
    from contour_context_tpu import db as jdb

    HC, W = (96, 40) if case == "squeezed" else (256, 128)
    B = 3
    rng = np.random.default_rng(11)
    store, query, _ = kt.cascade_edge_world(5)
    query = {k: v[:B] for k, v in query.items()}
    N = len(store["tab12"])
    hints = dict(gidx=rng.integers(0, N, (B, HC)).astype(np.int32),
                 level=rng.integers(1, 4, (B, HC)).astype(np.int32),
                 seq_src=rng.integers(0, A, (B, HC)).astype(np.int32),
                 seq_tgt=rng.integers(0, A, (B, HC)).astype(np.int32))
    n_valid = np.array([W + 1, 0, HC], np.int32)
    hints["hv"] = np.arange(HC)[None] < n_valid[:, None]
    jcfg, tcfg = CFGS
    res = tdb.cascade_chunked(
        _torch(store), _torch(query),
        *[torch.from_numpy(hints[k]) for k in ("gidx", "level", "seq_src",
                                               "seq_tgt", "hv")],
        torch.from_numpy(n_valid), tcfg.thres_lb, tcfg.db.cont_sim, W,
        tcfg.db.p_pot)
    for b in range(B):
        want = jax.device_get(jdb._cascade_chunked(
            _jax_scan(store), _jax_scan(query, b),
            *[hints[k][b] for k in ("gidx", "level", "seq_src", "seq_tgt",
                                    "hv")],
            jnp.int32(n_valid[b]), jcfg.thres_lb, jcfg.db.cont_sim, W,
            jcfg.db.p_pot))
        _assert_equal([x[b].numpy() for x in res], want, f"{case} row {b}")
        idle = np.arange(HC) >= -(-n_valid[b] // W) * W
        for x in res:
            assert not x[b][torch.from_numpy(idle)].view(torch.uint8).any()
    assert int(res.pass1[2].sum()) > 0


def test_host_spec_query_shape_matches_jax():
    """The flat call the host spec query makes: H = Q*A*K = 900 rows of one
    query (tgt_q all 0, levels and anchors in search order, a third of the
    hints invalid), the twin against JAX's `_gather_and_cascade_impl`."""
    store, query, _ = kt.cascade_edge_world(6)
    query = {k: v[:1] for k, v in query.items()}
    Q, K = 3, 50
    rng = np.random.default_rng(2)
    N = len(store["tab12"])
    shape = (Q, A, K)
    hints = dict(gidx=rng.integers(0, N, shape).reshape(-1).astype(np.int32),
                 level=np.broadcast_to(np.arange(1, Q + 1)[:, None, None],
                                       shape).reshape(-1).astype(np.int32),
                 seq_src=rng.integers(0, A, shape).reshape(-1)
                 .astype(np.int32),
                 seq_tgt=np.broadcast_to(np.arange(A)[None, :, None], shape)
                 .reshape(-1).astype(np.int32),
                 hv=(rng.random(shape) < 0.66).reshape(-1))
    tgt_q = np.zeros(Q * A * K, np.int64)
    res = _twin_rows(store, query, hints, tgt_q, 128, CFGS[1])
    _assert_equal([x.numpy() for x in res],
                  _jax_rows(store, query, hints, tgt_q, 128, CFGS[0]),
                  "host spec query")
    assert int(res.pass2.sum()) > 0
    # the kernel's algorithm on every 8th row
    sub = {k: v[::8] for k, v in hints.items()}
    _assert_equal([x[::8].numpy() for x in res],
                  _kernel_rows(store, query, sub, tgt_q[::8], 128, CFGS[1]),
                  "kernel copy, host spec query", rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel's algorithm in numpy
# ---------------------------------------------------------------------------

F32 = np.float32
INT_MAX = 2 ** 31 - 1


def _check_sim(s, t, cs):
    def mx(a, b):
        return F32(np.nan) if np.isnan(a) or np.isnan(b) else max(a, b)

    def perc(a, b, p):
        return bool(abs(F32(a - b) / mx(a, b)) > F32(p))

    def delt(a, b, d):
        return bool(abs(F32(a - b)) > F32(d))

    with np.errstate(all="ignore"):
        fail = perc(s[0], t[0], cs.tp_cell_cnt) and \
            delt(s[0], t[0], cs.ta_cell_cnt)
        fail |= mx(s[2], t[2]) > 2 and perc(np.sqrt(s[2]), np.sqrt(t[2]),
                                            cs.tp_eigval)
        fail |= mx(s[1], t[1]) > 2 and perc(np.sqrt(s[1]), np.sqrt(t[1]),
                                            cs.tp_eigval)
        fail |= mx(s[0], t[0]) > 15 and delt(s[3], t[3], cs.ta_h_bar)
        fail |= delt(s[4], t[4], cs.ta_rcom) and perc(s[4], t[4], cs.tp_rcom)
    return not fail


def _order_bits(v):
    u = np.float32(v).view(np.uint32)
    if np.isnan(v):
        return 0xffffffff
    return int(~u & 0xffffffff) if u & 0x80000000 else int(u | 0x80000000)


def _tree(x):
    """csrc/cascade.cu's slot_sum: x[l] + x[l + 32], the shuffles, + 0."""
    x = np.asarray(x, F32)
    while len(x) > 1:
        x = x[:len(x) // 2] + x[len(x) // 2:]
    return x[0] + F32(0.0)


def _kernel_row(store, query, g, lev, ss, st, hv, q, pot, lb, cs):
    """One CTA of csrc/cascade.cu in numpy float32, step for step."""
    clip = lambda x, hi: min(max(int(x), 0), hi)  # noqa: E731
    gi = clip(g if hv else 0, len(store["tab12"]) - 1)
    lvl = clip(lev, L - 1)
    s = {k: store[k][gi, lvl, clip(ss, A - 1)] for k in NEI}
    t = {k: query[k][q, lvl, clip(st, A - 1)] for k in NEI}
    stab, qtab = store["tab12"][gi], query["tab12"][q]
    li = clip(lev - 1, L12 - 1)
    pass1 = hv and _check_sim(stab[li, clip(ss, J - 1)],
                              qtab[li, clip(st, J - 1)], cs)
    masks = []
    for side in (s, t):
        m = 0
        for ok, bit in zip(side["nei_valid"], side["nei_bit"].tolist()):
            if ok and 0 <= bit < 256:
                m |= 1 << bit
        masks.append(m)
    ms, mt = masks
    full = (1 << 256) - 1
    a = [bin(ms & mt).count("1"), bin(((ms << 1) & full) & mt).count("1"),
         bin((ms >> 1) & mt).count("1")]
    keys, n_fin, first_open = [], 0, INT_MAX
    two_pi, pi = F32(2 * math.pi), F32(math.pi)
    for f in range(M * M):
        j, i = divmod(f, M)
        if s["nei_valid"][i] and t["nei_valid"][j] and \
                abs(int(s["nei_bit"][i]) - int(t["nei_bit"][j])) <= 1:
            # clamp_ang as the CPU twin rounds it (a true division by 2 pi;
            # on the card torch and the kernel multiply by its reciprocal)
            x = F32(t["nei_theta"][j] - s["nei_theta"][i])
            k = np.floor(F32(x + pi) / two_pi)
            o = F32(F32(x - F32(k * two_pi)) + F32(0.0))
            n_fin += bool(np.isfinite(o))
            keys.append((_order_bits(o) << 32) | f)
        else:
            first_open = min(first_open, f)
    n = min(n_fin, pot, M * M)
    sv, sf = np.zeros(n, F32), np.zeros(n, int)
    for k in keys:
        rank = sum(k2 < k for k2 in keys)
        if rank < n:
            u = np.uint32(k >> 32)
            bits = u & 0x7fffffff if u & 0x80000000 else ~u
            sv[rank], sf[rank] = np.uint32(bits).view(F32), k & 0xffffffff
    best = 0
    for k in range(n):
        hi = F32(sv[k] + F32(math.pi / 16))
        cm = int(np.searchsorted(sv, hi, "right"))
        cw = int(np.searchsorted(sv, F32(hi - two_pi), "right"))
        best = max(best, ((min(cm, n) - k + min(cw, n)) << 16)
                   | (0xffff - k))
    longest = max(best >> 16, 1)
    beg = 0xffff - (best & 0xffff) if n > 0 else 0
    in_ang = longest if n > 0 else 0
    pass2 = pass1 and sum(a) >= lb.sim_constell.i_ovlp_sum and \
        max(a) >= lb.sim_constell.i_ovlp_max_one and n > 0 and \
        in_ang >= lb.sim_constell.i_in_ang_rng
    P = tcasc.P_MAX
    plev, pss, pst = np.zeros(P, int), np.zeros(P, int), np.zeros(P, int)
    c1, rank0 = np.zeros(P, bool), np.zeros(P, int)
    sr, tr = np.zeros((P, 12), F32), np.zeros((P, 12), F32)
    ls = s["nei_level"].astype(int) * 64 + s["nei_seq"].astype(int)
    for p in range(P):
        if p < P - 1:
            gf = sf[(beg + p) % n] if n > 0 else \
                (0 if first_open == INT_MAX else first_open)
            j, i = divmod(int(gf), M)
            plev[p], pss[p] = ls[i] >> 6, ls[i] & 63
            pst[p] = int(t["nei_seq"][j])
            v0, rank0[p] = p < min(longest, P - 1), p
        else:
            plev[p], pss[p], pst[p], v0, rank0[p] = lev, ss, st, True, longest
        li = clip(plev[p] - 1, L12 - 1)
        sr[p], tr[p] = stab[li, clip(pss[p], J - 1)], \
            qtab[li, clip(pst[p], J - 1)]
        c1[p] = v0 and pass2 and _check_sim(sr[p], tr[p], cs) and \
            sr[p, 11] > 0.5 and tr[p, 11] > 0.5
    cpos = np.full(P, 1 << 20)
    for p in np.flatnonzero(c1):
        cpos[p] = sum(c1[q2] and (rank0[q2] < rank0[p] or (
            rank0[q2] == rank0[p] and q2 < p)) for q2 in range(P))
    slot_at = {int(cpos[p]): p for p in np.flatnonzero(cpos < 10)}
    n_top = min(int(c1.sum()), 10)
    gt1, gt0 = -1, 1 << 20
    for ci in range(n_top):
        for cj in range(ci):
            d = sr[slot_at[ci], 5:7] - sr[slot_at[cj], 5:7]
            span = np.sqrt(F32(d[0] * d[0]) + F32(d[1] * d[1]))
            if span > 1:
                gt1 = max(gt1, ci * 10 + cj)
            if span > 0:
                gt0 = min(gt0, ci * 10 + cj)
    use = gt1 if gt1 >= 0 else gt0
    sh, nan_shaft = np.zeros(4, F32), False
    if use < 1 << 20:
        i, j = slot_at[use // 10], slot_at[use % 10]
        ds_, dt_ = sr[i, 5:7] - sr[j, 5:7], tr[i, 5:7] - tr[j, 5:7]
        ns = np.sqrt(F32(ds_[0] * ds_[0]) + F32(ds_[1] * ds_[1]))
        nt = np.sqrt(F32(dt_[0] * dt_[0]) + F32(dt_[1] * dt_[1]))
        with np.errstate(all="ignore"):
            sh[:2] = ds_ / max(ns, F32(1e-12))
            sh[2:] = dt_ / max(nt, F32(1e-12))
        nan_shaft = nt <= F32(1e-12)
    with np.errstate(all="ignore"):
        th_s = np.arccos(np.clip(F32(sh[0] * sr[:, 7]) + F32(sh[1] * sr[:, 8]),
                                 -1, 1))
        th_t = np.arccos(np.clip(F32(sh[2] * tr[:, 7]) + F32(sh[3] * tr[:, 8]),
                                 -1, 1))
    bad = (sr[:, 9] > 0.5) & (tr[:, 9] > 0.5) & \
        (np.abs(th_s - th_t) > F32(math.pi / 6)) & \
        (np.abs(F32(math.pi) - th_s - th_t) > F32(math.pi / 6)) & \
        (not nan_shaft)
    c2 = c1 & ~bad
    w = c2.astype(F32)
    nf = F32(max(int(c2.sum()), 1))
    mu = [_tree(sr[:, 5] * w) / nf, _tree(sr[:, 6] * w) / nf,
          _tree(tr[:, 5] * w) / nf, _tree(tr[:, 6] * w) / nf]
    dt0, dt1 = (tr[:, 5] - mu[2]) * w, (tr[:, 6] - mu[3]) * w
    ds0, ds1 = sr[:, 5] - mu[0], sr[:, 6] - mu[1]
    c00, c01, c10, c11 = (_tree(dt0 * ds0), _tree(dt0 * ds1),
                          _tree(dt1 * ds0), _tree(dt1 * ds1))
    th = np.arctan2(F32(c10 - c01), F32(c00 + c11))
    cth, sth = np.cos(th), np.sin(th)
    tx = mu[2] - (cth * mu[0] - sth * mu[1])
    ty = mu[3] - (sth * mu[0] + cth * mu[1])
    i_indiv, i_orie = int(c1.sum()), int(c2.sum())
    pass3 = pass2 and i_indiv >= lb.sim_pair.i_indiv_sim and \
        i_orie >= lb.sim_pair.i_orie_sim
    area = np.where(c2, F32(0.5) * (sr[:, 10] + tr[:, 10]), F32(0))
    return (pass1, pass2, pass3, sum(a), max(a), in_ang, i_indiv, i_orie,
            c2, plev, pss, pst, area, np.array([tx, ty, th], F32),
            len(keys) > pot, longest > P - 1)


def _kernel_rows(store, query, hints, tgt_q, p_pot, cfg):
    pot = tcasc.P_POT if p_pot is None else p_pot
    rows = [_kernel_row(store, query, *[hints[k][h] for k in (
        "gidx", "level", "seq_src", "seq_tgt", "hv")], int(tgt_q[h]), pot,
        cfg.thres_lb, cfg.db.cont_sim) for h in range(len(tgt_q))]
    return [np.stack([np.asarray(r[i]) for r in rows])
            for i in range(len(rows[0]))]


@pytest.mark.parametrize("p_pot", [8, 128, None])
def test_kernel_algorithm_matches_twin(edges, p_pot):
    """A numpy copy of the kernel's algorithm (its orders: ranks of the
    64-bit keys, the packed window maximum, counted slot order, the shaft
    from compacted slots, the halving-tree sums) equals the twin on the edge
    rows: ints and bools exactly, floats within 1e-5."""
    store, query, hints = edges
    tgt_q = np.arange(len(hints["gidx"]))
    twin = _twin_rows(store, query, hints, tgt_q, p_pot, CFGS[1])
    _assert_equal([x.numpy() for x in twin],
                  _kernel_rows(store, query, hints, tgt_q, p_pot, CFGS[1]),
                  f"kernel copy, p_pot {p_pot}", rtol=1e-5, atol=1e-5)


def test_kernel_constants_match_the_twin():
    """The kernel source's slot count, pair capacity, shaft window and
    neighbour slots are the twin's (and the wrapper's checks)."""
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src)
                   .group(1).split("//")[0].replace("1 << 20", str(1 << 20)))

    assert const("kSlots") == tcasc.P_MAX
    assert const("kPotMax") == tcasc.P_POT == kernels.CASCADE_MAX_POT
    assert const("kShaftTop") == tcasc.SHAFT_TOP
    assert const("kMaxM") == kernels.CASCADE_MAX_M == \
        4 * tconfig.ContourManagerConfig().dist_firsts
    assert "cascade.cu" in kernels._SOURCES


def test_cpu_cascade_never_calls_the_kernel_library(monkeypatch, edges):
    """CPU tensors take the twin: the kernel library is neither built nor
    launched, and no cascade launch is counted."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was called")

    n = kernels.cascade.launches
    monkeypatch.setattr(kernels, "build", refuse)
    monkeypatch.setattr(tdb, "cascade_kernel", refuse)
    store, query, hints = edges
    tgt_q = np.arange(len(hints["gidx"]))
    _twin_rows(store, query, hints, tgt_q, 128, CFGS[1])
    cfg = CFGS[1]
    B = 2
    tq = {k: v[:B] for k, v in query.items()}
    cols = [torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        hints[k][:10], (B, 10)))) for k in ("gidx", "level", "seq_src",
                                            "seq_tgt", "hv")]
    tdb.cascade_chunked(_torch(store), _torch(tq), *cols,
                        torch.tensor([3, 10], dtype=torch.int32),
                        cfg.thres_lb, cfg.db.cont_sim, 4, cfg.db.p_pot)
    assert kernels.cascade.launches == n
    assert "cascade" in kernels.launch_counts()
