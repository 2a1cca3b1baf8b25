"""The port's sync-free step on the CPU, held against the JAX package.

The JAX package runs its step as one dispatch: the cascade's chunks, the CC
labels and the proposal merge are `lax.while_loop`s on the device. The port
runs every cascade chunk and zeroes each query's columns past its own
chunks (no chunk count on the host), labels the components in one kernel
launch (`kernels.cc_labels`) and walks the proposal merge in one kernel
launch (`kernels.merge_hints`), and writes the store at rows read from the
device's window state, so the whole step can be captured in a CUDA graph.
On the CPU each kernel wrapper takes its plain version; this file holds:

- the all-chunk `cascade_chunked` against JAX's `_cascade_chunked` (ints
  and bools exactly, floats in test_torch_query.py's 1e-4 band and bit for
  bit +0.0 past each query's own chunks), at n_valid 0, 1, W - 1, W, W + 1
  and HC, at B = 1 and as row b of a B = 3 batch with other limits in the
  other rows, at the default caps and at an HC that is no multiple of W;
- the plain `cc_labels` against JAX's `cc_labels` under the config's
  `cc_flush`, exactly, on synth scans' level masks and on masks made to
  stress a labelling (a spiral one pixel wide, a comb, a checkerboard,
  full, empty, diagonal staircases, a random field, and for the kernel's
  strips of rows a U joined only in its last rows, a serpentine crossing
  every strip at each turn, two interleaved combs); the card tests hold
  the kernel to the plain version on the same masks;
- the merge's plain loop (`kernels.merge_hints_plain`) against a per-row
  walk written the way the kernel walks (a row's hints in arrival order,
  float32 numpy), also on rows made to stress the kernel's lanes (trip
  counts from 0 to MP in one warp, full rows, angles across the wrap), and
  the port's `merge_proposals` against JAX's on the cascade outputs of a
  found revisit, at the default and squeezed caps;
- the merge kernel's byte bound against a count of what its walk reads,
  and its chain bound (the longest row's hints, a fixed count of dependent
  steps each);
- the device-indexed appends and record writes against the host-indexed
  writes they replace, bit for bit, over a 40-scan stream (and 5 blocks of
  8) that crosses two grows.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu import config as jconfig
from contour_context_tpu.utils.io import pad_points
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch import kernel_times as kt
from contour_context_tpu_torch.ops import candidate as tcand
from contour_context_tpu_torch.ops import descriptor as td
from contour_context_tpu_torch.ops import kernels
from contour_context_tpu_torch.types import ScanDesc, scan_desc_from_numpy

torch.set_num_threads(2)


def _configs(**db):
    """(JAX config, port config), each from its own package and the same
    arguments."""
    return tuple(m.PipelineConfig(cm=m.ContourManagerConfig(max_points=16384),
                                  db=m.ContourDBConfig(**db))
                 for m in (jconfig, tconfig))


# the default caps (HC 256 in chunks of 128) and squeezed ones (HC 96 in
# chunks of 40: the last chunk's start is clamped)
CASES = {"default": _configs(),
         "squeezed": _configs(max_check_cands=96, cascade_chunk=40,
                              max_pass_hints=16, max_cand_poses=2, p_pot=8)}
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (30.0, -1.0, -0.15), (110.0, 40.0, 0.6), (50.2, 0.7, 0.1)]
QUERY_POSE = (10.5, 0.8, 0.2)      # revisits scan 1


@pytest.fixture(scope="module")
def carried():
    """A JAX DB of 11 synth scans (6 s apart), a revisit query descriptor,
    and the query's hint rows as the cascade gets them under each case's
    caps (after the hint cap and the check-1 compaction)."""
    from contour_context_tpu import db as jdb
    from contour_context_tpu.db import ContourDB as JDB
    from contour_context_tpu.ops.candidate import select_topk_stable
    from contour_context_tpu.ops.descriptor import build_descriptor

    cfg0 = CASES["default"][0]
    world = make_world(11, n_structs=220, extent=160.0)
    db = JDB(cfg0, capacity=16)
    for i, pose in enumerate(POSES):
        pts = pad_points(render_scan(world, pose, seed=500 + i),
                         cfg0.cm.max_points)
        db.add_scan(build_descriptor(jnp.asarray(pts), cfg0.cm, cfg0.gmm),
                    i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    qpts = pad_points(render_scan(world, QUERY_POSE, seed=777),
                      cfg0.cm.max_points)
    qdesc = build_descriptor(jnp.asarray(qpts), cfg0.cm, cfg0.gmm)

    def rows(cfg):
        def fn(store, query, keys_q, state):
            q_levels = tuple(cfg.db.q_levels)
            gidx, seq_src, dist, valid = jdb._search_impl(
                keys_q, query.keys, state[1], q_levels, cfg.db.nnk,
                cfg.db.topk_strategy)
            Q, A, K = gidx.shape
            lv = jnp.array(q_levels, jnp.int32)
            level_f = jnp.broadcast_to(lv[:, None, None], (Q, A, K)) \
                .reshape(-1)
            seq_tgt_f = jnp.broadcast_to(
                jnp.arange(A, dtype=jnp.int32)[None, :, None],
                (Q, A, K)).reshape(-1)
            HC = min(cfg.db.max_check_cands, Q * A * K)
            perm, hv, _, _ = jdb._select_hints(valid.reshape(-1),
                                               dist.reshape(-1), HC)
            g, l_ = gidx.reshape(-1)[perm], level_f[perm]
            ss, st = seq_src.reshape(-1)[perm], seq_tgt_f[perm]
            p1 = jdb._check1_impl(store, query, g, l_, ss, st, hv,
                                  cfg.db.cont_sim)
            perm2, hv_run, n_run, _ = select_topk_stable(
                jnp.arange(HC, dtype=jnp.float32), p1, HC)
            return g[perm2], l_[perm2], ss[perm2], st[perm2], hv_run, n_run

        return jax.device_get(jax.jit(fn)(db.store, qdesc, db.keys_q,
                                          db.state))

    host = dict(store=jax.device_get(db.store), keys_q=np.asarray(db.keys_q),
                ts_store=np.asarray(db.ts_store), state=np.asarray(db.state),
                recs_store=None, n=db.n, seq_of_gidx=db.seq_of_gidx)
    return dict(db=db, qdesc=qdesc, host=host,
                rows={name: rows(c[0]) for name, c in CASES.items()})


@pytest.fixture(scope="module")
def jax_cascades(carried):
    """{(case, n_valid): JAX _cascade_chunked of the query's hint rows with
    the first n_valid rows live}, one compile a case."""
    from contour_context_tpu import db as jdb

    out = {}
    for name, (cfg, _) in CASES.items():
        fn = jax.jit(lambda store, query, g, l_, ss, st, hv, n, cfg=cfg:
                     jdb._cascade_chunked(store, query, g, l_, ss, st, hv, n,
                                          cfg.thres_lb, cfg.db.cont_sim,
                                          cfg.db.cascade_chunk, cfg.db.p_pot))
        g, l_, ss, st, _, _ = carried["rows"][name]
        HC = g.shape[0]
        for n in _n_valids(cfg):
            hv = np.arange(HC) < n
            out[name, n] = jax.device_get(fn(
                carried["db"].store, carried["qdesc"], g, l_, ss, st, hv,
                jnp.int32(n)))
    return out


def _n_valids(cfg):
    HC = cfg.db.max_check_cands
    W = cfg.db.cascade_chunk
    return (0, 1, W - 1, W, W + 1, HC)


def _assert_cascade_equal(port_row, jax_res, idle, what):
    """ints and bools exactly; floats to 1e-4 (torch's and XLA's CPU
    kernels round atan2 and friends differently: test_torch_query.py's
    band), and bit for bit +0.0 in the idle columns past the query's own
    chunks, where JAX's loop never wrote."""
    for field, a, b in zip(jax_res._fields, port_row, jax_res):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}: {field}")
            assert not a[idle].view(np.int32).any() and \
                not b[idle].view(np.int32).any(), f"{what}: {field} idle"
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {field}")


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("i_n", range(6))
@pytest.mark.parametrize("case", sorted(CASES))
def test_all_chunk_cascade_matches_jax(carried, jax_cascades, case, i_n, B):
    """Every chunk runs and each query's columns past ceil(n_valid / W) * W
    are zeroed: row b equals JAX's while_loop over the query's own chunks,
    exactly. At B = 3 the query under test sits in row 1 between a full
    and an empty one."""
    cfg, tcfg = CASES[case]
    host = carried["host"]
    db = tdb.ContourDB.from_numpy_state(tcfg, device="cpu", **host)
    q = scan_desc_from_numpy(jax.device_get(carried["qdesc"]), device="cpu")
    g, l_, ss, st, _, _ = (torch.from_numpy(np.array(x))
                           for x in carried["rows"][case])
    HC = g.shape[0]
    n = _n_valids(cfg)[i_n]
    row_ns = [n] if B == 1 else [HC, n, 0]
    b_test = 0 if B == 1 else 1
    hv = torch.stack([torch.arange(HC) < m for m in row_ns])
    res = tdb.cascade_chunked(
        db.store, ScanDesc(*[x[None].expand((B,) + x.shape) for x in q]),
        *[x[None].expand(B, HC) for x in (g, l_, ss, st)], hv,
        torch.tensor(row_ns, dtype=torch.int32), tcfg.thres_lb,
        tcfg.db.cont_sim, tcfg.db.cascade_chunk, tcfg.db.p_pot)
    W = tcfg.db.cascade_chunk
    for b, m in enumerate(row_ns):
        idle = np.arange(HC) >= -(-m // W) * W
        _assert_cascade_equal([x[b] for x in res], jax_cascades[case, m],
                              idle, f"{case} n_valid {m} row {b} of {B}")
    assert not bool(res.pass1[b_test, n:].any())


@pytest.fixture(scope="module")
def jax_cc():
    from contour_context_tpu.ops.descriptor import cc_labels

    flush = CASES["default"][0].cm.cc_flush
    return jax.jit(lambda m: cc_labels(m, flush))


MASKS = sorted(kt.adversarial_masks(8, 8)) + ["synth scans"]


@pytest.mark.parametrize("name", MASKS)
def test_plain_cc_labels_match_jax(carried, jax_cc, name):
    """The plain CC labels (the CPU's side of `kernels.cc_labels`) equal
    JAX's cc_labels under the config's cc_flush, exactly: the adversarial
    masks at the config's 150 x 150, and the level masks of four synth
    scans."""
    tcfg = CASES["default"][1]
    nr, nc = tcfg.cm.n_row, tcfg.cm.n_col
    if name == "synth scans":
        world = make_world(11, n_structs=220, extent=160.0)
        pts = np.stack([pad_points(render_scan(world, p, seed=900 + i),
                                   tcfg.cm.max_points)
                        for i, p in enumerate(POSES[:3] + [QUERY_POSE])])
        masks = kt.masks_of(torch.from_numpy(pts), tcfg).reshape(-1, nr, nc)
    else:
        masks = torch.from_numpy(kt.adversarial_masks(nr, nc)[name])[None]
    # one (1, nr, nc) program for every case: one compile
    lab_j = np.concatenate([np.asarray(jax_cc(jnp.asarray(m[None])))
                            for m in masks.numpy()])
    lab_p = kernels.cc_labels_plain(masks)
    np.testing.assert_array_equal(lab_p.numpy(), lab_j)
    # the wrapper on the CPU is the plain version, with leading axes
    assert torch.equal(td.cc_labels(masks[None]), lab_p[None])
    S = nr * nc
    fg = masks.reshape(masks.shape[0], -1)
    assert bool((lab_p[~fg] == S).all()) and bool((lab_p[fg] < S).all())


def test_adversarial_masks_are_what_they_say():
    """The spiral, comb, checkerboard, staircases, U and serpentine are one
    8-connected component each (scipy's labelling), the two interleaved
    combs two, the random field many."""
    import scipy.ndimage as ndi

    counts = {k: ndi.label(m, structure=np.ones((3, 3)))[1]
              for k, m in kt.adversarial_masks().items()}
    assert counts.pop("empty") == 0 and counts.pop("random") > 10
    assert counts.pop("two interleaved combs") == 2
    assert set(counts.values()) == {1}, counts
    lab = kernels.cc_labels_plain(
        torch.from_numpy(kt.adversarial_masks()["spiral"])[None])
    assert int(lab.min()) == 0 and int((lab < 150 * 150).sum()) > 11000


def _row_walk(hint_of, T, votes):
    """The merge as the kernel runs it: one (query, row) at a time, its
    hints in arrival order, each op rounded to float32 on its own (numpy
    float32 scalars). The reference for `merge_hints_plain`."""
    f = np.float32
    pi, two_pi = f(math.pi), f(2 * math.pi)
    hint_of, T, votes = (x.numpy() for x in (hint_of, T, votes))
    B, C, MP = hint_of.shape
    pT = np.zeros((B, C, 4, 3), np.float32)
    pv = np.zeros((B, C, 4), np.int32)
    pn = np.zeros((B, C), np.int32)
    key = np.full((B, MP), -1, np.int32)
    for b in range(B):
        for c in range(C):
            for m in hint_of[b, c]:
                if m < 0:
                    continue
                x, y, th = T[b, m]
                w2 = votes[b, m]
                cm, sm = f(np.cos(th)), f(np.sin(th))
                first = -1
                for s in range(pn[b, c]):
                    dx, dy = f(pT[b, c, s, 0] - x), f(pT[b, c, s, 1] - y)
                    tx = f(f(cm * dx) + f(sm * dy))
                    ty = f(f(-sm * dx) + f(cm * dy))
                    a = f(pT[b, c, s, 2] - th)
                    dth = f(a - f(f(np.floor(f(f(a + pi) / two_pi)))
                                  * two_pi))
                    if f(np.hypot(tx, ty)) < f(2.0) and abs(dth) < f(0.3):
                        first = s
                        break
                if first < 0 and pn[b, c] >= 4:
                    continue
                slot = first if first >= 0 else pn[b, c]
                if first >= 0:
                    ox, oy, ot = (f(v + f(0.0)) for v in pT[b, c, slot])
                    w1 = pv[b, c, slot]
                    ws = f(max(w1 + w2, 1))
                    nx = f(f(f(ox * f(w1)) + f(x * f(w2))) / ws)
                    ny = f(f(f(oy * f(w1)) + f(y * f(w2))) / ws)
                    diff = f(th - ot)
                    if diff < 0:
                        diff = f(diff + two_pi)
                    if diff > pi:
                        diff = f(diff - two_pi)
                    pT[b, c, slot] = (nx, ny, f(f(f(diff * f(w2)) / ws) + ot))
                    pv[b, c, slot] = w1 + w2
                else:
                    pT[b, c, slot] = (x, y, th)
                    pv[b, c, slot] = w2
                    pn[b, c] += 1
                key[b, m] = c * 4 + slot
    return pT, pv, pn, key


def _synthetic_merge(seed: int, B: int = 4, C: int = 8, MP: int = 24):
    """Random hint rows in the kernel's layout: hints in clusters (so some
    merge, some open proposals and some overflow the 4 slots), angles
    across the wrap."""
    rng = np.random.default_rng(seed)
    T = np.zeros((B, MP, 3), np.float32)
    T[..., :2] = rng.integers(0, 3, (B, MP, 2)) * 3.0 + \
        rng.normal(0, 0.6, (B, MP, 2))
    T[..., 2] = rng.choice([-3.1, 0.0, 3.1], (B, MP)) + \
        rng.normal(0, 0.12, (B, MP))
    votes = rng.integers(1, 9, (B, MP)).astype(np.int32)
    hint_of = np.full((B, C, MP), -1, np.int32)
    for b in range(B):
        row = rng.integers(0, C + 2, MP)        # rows past C: dropped hints
        for c in range(C):
            ms = np.flatnonzero(row == c)
            hint_of[b, c, :len(ms)] = ms
    return tuple(torch.from_numpy(x) for x in (hint_of, T, votes))


@pytest.mark.parametrize("source", ["default", "squeezed", "synthetic 0",
                                    "synthetic 1"]
                         + sorted(kt.merge_stress_cases()))
def test_merge_plain_matches_row_walk(carried, jax_cascades, source):
    """`merge_hints_plain` (all rows at once, one trip a hint position)
    equals the kernel's per-row walk: slots, votes, counts and keys
    exactly, poses to 1e-5 (numpy's cos and sin against torch's); on the
    cascade outputs of a revisit, on random rows, and on the rows made to
    stress the kernel's lanes (`kernel_times.merge_stress_cases`: trip
    counts from 0 to MP in one warp, full rows, angles across the wrap)."""
    if source in kt.merge_stress_cases():
        inputs = tuple(torch.from_numpy(x)
                       for x in kt.merge_stress_cases()[source])
    elif source.startswith("synthetic"):
        inputs = _synthetic_merge(int(source[-1]))
    else:
        cfg, tcfg = CASES[source]
        res = jax_cascades[source, cfg.db.max_check_cands]
        g = carried["rows"][source][0]
        inputs = tcand.merge_inputs(
            *[torch.from_numpy(np.array(x))[None] for x in (
                res.pass3, g, res.T_delta, res.pair_valid)],
            n_cand_max=tcfg.db.max_cand_poses,
            n_pass_max=tcfg.db.max_pass_hints)
    out = kernels.merge_hints_plain(*inputs)
    ref = _row_walk(*inputs)
    assert int(ref[2].sum()) > 0
    np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), b)
    # the wrapper on the CPU is the plain version
    for a, b in zip(kernels.merge_hints(*inputs), out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_bound_counts_what_the_walk_reads(seed):
    """`kernel_times.merge_bound` counts the bytes this input's walk needs:
    each row's ids up to and including its first -1 (all MP of a full
    row), 16 bytes of pose and votes a hint present, and the dense
    outputs written once, counted here by walking the rows in numpy."""
    hint_of, T, votes = _synthetic_merge(seed)
    hint_of[0, 0, :] = torch.arange(hint_of.shape[2])        # a full row
    B, C, MP = hint_of.shape
    ids = hints = 0
    for row in hint_of.reshape(-1, MP).numpy():
        n = int(np.argmax(row < 0)) if (row < 0).any() else MP
        ids += min(n + 1, MP)
        hints += n
    outputs = B * C * 4 * 3 * 4 + B * C * 4 * 4 + B * C * 4 + B * MP * 4
    _, by, n_bytes = kt.merge_bound(hint_of, T, votes)
    assert by == "bytes"
    assert n_bytes == 4 * ids + 16 * hints + outputs
    assert n_bytes < sum(t.numel() * 4 for t in (hint_of, T, votes)) \
        + outputs


def test_merge_chain_bound_is_the_longest_rows_chain():
    """`kernel_times.merge_chain_bound`: the longest row's hints times
    MERGE_CHAIN_STEPS dependent steps, one a clock; rows side by side do
    not add up, and an empty input bounds at 0."""
    hint_of, _, _ = (torch.from_numpy(x) for x in
                     kt.merge_stress_cases()["ragged warp"])
    clk = 2e9
    assert kt.merge_chain_bound(hint_of, clk) == pytest.approx(
        1e6 * 128 * kt.MERGE_CHAIN_STEPS / clk)
    assert kt.merge_chain_bound(hint_of[:1, :16], clk) == pytest.approx(
        1e6 * 15 * kt.MERGE_CHAIN_STEPS / clk)
    assert kt.merge_chain_bound(torch.full((2, 4, 8), -1), clk) == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_proposals_match_jax_on_a_revisit(carried, jax_cascades, case):
    """The port's merge_proposals (its loop in `kernels.merge_hints`)
    equals JAX's merge_proposals (its while_loop) on the JAX cascade
    outputs of a found revisit: ints and bools exactly, floats to 1e-4."""
    from contour_context_tpu.ops.candidate import merge_proposals

    cfg, tcfg = CASES[case]
    res = jax_cascades[case, cfg.db.max_check_cands]
    g = carried["rows"][case][0]
    args = (res.pass3, g, res.T_delta, res.pair_valid, res.pair_level,
            res.pair_seq_src, res.pair_seq_tgt, res.pair_area_perc)
    caps = dict(n_cand_max=tcfg.db.max_cand_poses,
                n_pass_max=tcfg.db.max_pass_hints)
    st_j = jax.device_get(merge_proposals(*[jnp.asarray(x) for x in args],
                                          **caps))
    st_t = tcand.merge_proposals(
        *[torch.from_numpy(np.array(x))[None] for x in args], **caps)
    assert int(st_j.n_cand) > 0 and int(np.sum(res.pass3)) > 0
    for field, a, b in zip(st_j._fields, st_t, st_j):
        a, b = a[0].numpy(), np.asarray(b)
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


class _HostIndexed(tdb.ContourDB):
    """The writes as the port made them before: store, keys_q, timestamps
    and the record at the host's row n (slices), not at state[0]."""

    def _append_rows(self, descs, ts_b):
        n, B = self.n, ts_b.shape[0]
        for buf, x in zip(self.store, descs):
            buf[n:n + B] = x
        L, A, D = descs.keys.shape[1:]
        self.keys_q[:, :, n * A:(n + B) * A] = \
            descs.keys.permute(1, 3, 0, 2).reshape(L, D, B * A) \
            .to(self.keys_q.dtype)
        self.ts_store[n:n + B] = ts_b
        self.state[0] += B

    def _step_body(self, pts, ts_t):
        desc = tdb.build_descriptor(pts, self.cfg.cm, self.cfg.gmm)
        rec = tdb.query_step(self.store, self.keys_q, desc, self.state,
                             self.cfg)
        self.recs_store[self.n] = rec
        self._append_rows(ScanDesc(*[x[None] for x in desc]),
                          ts_t.reshape(1))
        self._push(ts_t)


def _memo(fn):
    """fn of a cloud tensor, computed once a cloud (the two DBs of a test
    build the same descriptors)."""
    import hashlib

    seen = {}

    def call(pts, *args):
        key = hashlib.sha1(pts.numpy().tobytes()).hexdigest()
        if key not in seen:
            seen[key] = fn(pts, *args)
        return seen[key]

    return call


@pytest.mark.parametrize("mode", ["stream", "blocks of 8"])
def test_device_indexed_writes_match_host_indexed(mode, monkeypatch):
    """40 scans (a revisit world, 3 s apart) into a DB of capacity 16,
    which grows twice: the store, keys_q, timestamps, window state and the
    record ring written at rows read from state[0] equal the host-indexed
    writes bit for bit."""
    monkeypatch.setattr(tdb, "build_descriptor", _memo(tdb.build_descriptor))
    monkeypatch.setattr(tdb, "build_descriptors",
                        _memo(tdb.build_descriptors))
    cfg = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(
        max_points=4096))
    world = make_world(3, n_structs=90, extent=120.0)
    poses = [(4.0 * (i % 20), 0.3 * (i // 20), 0.05 * i) for i in range(40)]
    clouds = np.stack([pad_points(render_scan(world, p, seed=40 + i),
                                  cfg.cm.max_points)
                       for i, p in enumerate(poses)])
    dbs = [cls(cfg, capacity=16, device="cpu")
           for cls in (tdb.ContourDB, _HostIndexed)]
    for db in dbs:
        if mode == "stream":
            for i in range(40):
                db.step_async(clouds[i], i, 3.0 * i)
        else:
            for k in range(0, 40, 8):
                db.block_chain_pts_async(
                    torch.from_numpy(clouds[k:k + 8])[None],
                    list(range(k, k + 8)), [[3.0 * i for i in
                                              range(k, k + 8)]])
    a, b = dbs
    assert a.capacity == b.capacity == 64 and a.n == b.n == 40
    for name, x, y in zip(a.store._fields, a.store, b.store):
        assert torch.equal(x, y), name
    assert torch.equal(a.keys_q.view(torch.int16), b.keys_q.view(torch.int16))
    for name in ("ts_store", "state", "recs_store"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.ts == b.ts and a.seq_of_gidx == b.seq_of_gidx
    assert int(a.state[1]) > 0 and bool((a.recs_store[:40, 6] > 0).any())
