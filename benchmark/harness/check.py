"""The comparison that decides `correct`.

Once the window has closed, the harness copies what the program produced
to the host (the records of the window, and for the stream the whole
store, its search-layout keys, its timestamps and window state), frees
the program's state, and has the plain reference (`plainref`, plain
torch that imports nothing of the program) work the same inputs again
from the seed: the history or map descriptors, the appends and window
updates, and the queries. The numbers compared:

- `mismatch`: exact items that differ. Records whose found or gidx
  differ; store rows with an integer or flag leaf that differs; search-
  layout keys that are not the program's own stored keys in that
  layout; timestamps or window state that differ; served answers of one
  pool cloud that differ between the window's cycles. Limit 0.
- `corr_gap`: the widest gap of a record's correlation, over records
  found alike.
- `pose_gap`: the widest gap of a record's pose (x, y in BEV cells, yaw
  in rad), over the same records.
- `desc_gap`: the widest gap of a float leaf of the store's rows (the
  stream's history, warm-up and window; the serving map; the keys among
  them), as a share of the reference leaf's largest magnitude (or 1
  where that is below 1).

The reference runs each query at the batch the program ran it at (one
scan of the stream, a request of the serving pool). The limits leave
room for sound float32 arithmetic in another order: `control.py
--witness` reads what the reference on the CPU gives against the
reference on the card.
"""

from __future__ import annotations

import numpy as np
import torch

EXACT_LEAVES = ("cnt", "valid", "ecc_feat", "layer_cell_cnt", "n_cont",
                "nei_valid", "nei_level", "nei_seq", "nei_bit", "gmm_mask",
                "pix_overflow", "gmm_overflow")
NUMBERS = ("mismatch", "corr_gap", "pose_gap", "desc_gap")


def sample(seed: int, n: int, k: int) -> list:
    """k of range(n), drawn from the seed, sorted; the first and the last
    always in."""
    if k >= n:
        return list(range(n))
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    mid = rng.choice(np.arange(1, n - 1), size=max(0, k - 2), replace=False)
    return sorted({0, n - 1, *mid.tolist()})


def ref_config(cfg_file: dict):
    from plainref.config import PipelineConfig
    from harness.spec import dataclass_from_dict
    return dataclass_from_dict(PipelineConfig(), cfg_file["pipeline"])


def _leaf_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, 0.0, (a - b).abs())
    if torch.isnan(d).any():
        return float("inf")
    if not d.numel():
        return 0.0
    return float(d.max()) / max(1.0, float(torch.nan_to_num(b.abs()).max()))


def _rows_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,) bool: rows whose values differ anywhere."""
    ne = a != b
    return ne.reshape(ne.shape[0], -1).any(1) if ne.dim() > 1 else ne


def snapshot(st, rows: int, n=None) -> dict:
    """A store's first `rows` rows, its search-layout keys of those rows,
    timestamps and window state, on the host: of the port's ContourDB or
    of the reference's PlainStore (the same attribute names). `n` is the
    program's host count of rows (the state's on the device if None)."""
    A = st.store.keys.shape[2]
    kq = st.keys_q[:, :, :rows * A]
    if kq.dtype == torch.bfloat16:
        kq = kq.view(torch.int16)
    state = st.state.cpu().numpy()
    return dict(leaves={k: v[:rows].cpu().numpy()
                        for k, v in st.store._asdict().items()},
                keys_q=kq.cpu().numpy(), ts=st.ts_store[:rows].cpu().numpy(),
                state=state, n=int(state[0]) if n is None else int(n))


def _keys_q(snap: dict) -> torch.Tensor:
    """A snapshot's search-layout keys in their own dtype."""
    k = torch.from_numpy(snap["keys_q"])
    return k.view(torch.bfloat16) if k.dtype == torch.int16 else k


def _layout(snap: dict, dtype) -> torch.Tensor:
    """The search layout (L, D, rows * A) of a snapshot's own stored keys
    (rows, L, A, D), rounded to `dtype`: what its keys_q has to hold."""
    keys = torch.from_numpy(snap["leaves"]["keys"])
    rows, L, A, D = keys.shape
    return keys.permute(1, 3, 0, 2).reshape(L, D, rows * A).to(dtype)


def snapshot_parts(prog: dict, ref: dict) -> dict:
    """What differs between two snapshots, item by item: for each exact
    leaf the rows that differ (`rows.<leaf>`), for each float leaf its
    widest gap (`gap.<leaf>`, the keys among them); the values of the
    program's search-layout keys that are not its own stored keys in the
    search layout (`keys_q.layout`); the timestamps, window state and row
    count that differ. `keys_q.values`, the search-layout values that
    differ from the reference's, is for the record only: a sound change
    of the order of the keys' float32 arithmetic moves a bf16 rounding
    now and then, which the keys' own gap allows for."""
    parts = {}
    for name, r in ref["leaves"].items():
        pl = torch.from_numpy(prog["leaves"][name])
        r = torch.from_numpy(r)
        if name in EXACT_LEAVES:
            parts[f"rows.{name}"] = int(_rows_differ(pl, r).sum())
        else:
            parts[f"gap.{name}"] = _leaf_gap(pl, r)
    kp, kr = (_keys_q(x) for x in (prog, ref))
    parts["keys_q.layout"] = int((kp != _layout(prog, kp.dtype)).sum())
    parts["keys_q.values"] = int((kp != kr).sum())
    parts["ts"] = int(np.sum(prog["ts"] != ref["ts"]))
    parts["state"] = int(np.sum(prog["state"] != ref["state"]))
    parts["n"] = int(prog["n"] != ref["n"])
    return parts


def record_parts(prog_recs, ref_recs) -> dict:
    """What differs between paired records, each (gidx, corr, T3) or None
    (not found): records found on one side only, found at another gidx;
    over the records found alike, the widest correlation and pose gap."""
    found = gidx = 0
    cg = pg = 0.0
    for p, r in zip(prog_recs, ref_recs):
        if (p is None) != (r is None):
            found += 1
            continue
        if p is None:
            continue
        if p[0] != r[0]:
            gidx += 1
            continue
        cg = max(cg, abs(float(p[1]) - float(r[1])))
        pg = max(pg, float(np.max(np.abs(np.asarray(p[2], np.float64)
                                          - np.asarray(r[2], np.float64)))))
    return {"records.found": found, "records.gidx": gidx,
            "records.corr_gap": cg, "records.pose_gap": pg}


def numbers_of(parts: dict) -> dict:
    """The numbers compared, from the parts of a comparison."""
    exact = [k for k in parts if k.startswith("rows.")] + [
        "keys_q.layout", "ts", "state", "n", "records.found",
        "records.gidx", "cycles"]
    return dict(
        mismatch=sum(int(parts.get(k, 0)) for k in exact),
        corr_gap=parts["records.corr_gap"],
        pose_gap=parts["records.pose_gap"],
        desc_gap=max(v for k, v in parts.items() if k.startswith("gap.")))


def as_answer(vec) -> tuple:
    """A packed 18-float record as (gidx, corr, T3), or None if not found
    (the form of `BlockHandle.get`)."""
    v = np.asarray(vec)
    if not v[0] > 0.5:
        return None
    return (int(v[1]), float(v[2]), v[3:6].astype(np.float64))


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------

def reference_stream(p: dict, cfg_file: dict, host, device, queries,
                     moment_dtype=torch.float64, record_slice=None):
    """The reference's store after the history, the warm-up and the
    window, and the records of the post-history scans in `queries`
    (indices into the post drive). With `record_slice` (lo, hi), the
    bound inputs of every kernel call of those post scans' steps."""
    from plainref import kernels as rk
    from plainref.descriptor import build_descriptors
    from plainref.query import PlainStore
    cfg = ref_config(cfg_file)
    st = PlainStore(cfg, int(cfg_file["capacity"]), device)
    block = 16
    for b in range(0, p["H"], block):
        pts = p["hist"].clouds(b, b + block)
        descs = build_descriptors(pts, cfg.cm, cfg.gmm,
                                  moment_dtype=moment_dtype)
        st.block_append(descs, p["ts_hist"][b:b + block])
        del pts
    want = set(queries)
    recs, bounds = {}, []
    lo, hi = record_slice or (0, 0)
    for j in range(len(p["post"])):
        rec_on = lo <= j < hi
        with rk.recording(bounds if rec_on else []):
            pts = host[j].to(device)
            desc = build_descriptors(pts[None], cfg.cm, cfg.gmm,
                                     moment_dtype=moment_dtype)
            if j in want or rec_on:
                rec = st.query(desc)
                if j in want:
                    recs[j] = rec.cpu().numpy()
            st.append(desc, p["ts_post"][j:j + 1])
            st.push(float(p["ts_post"][j]))
    return st, recs, bounds


def reference_serve(p: dict, cfg_file: dict, pool, device,
                    moment_dtype=torch.float64, record_slice=None):
    """The reference's frozen map, the records of every request of the
    pool, and (with `record_slice`, requests [lo, hi) of
    the window, cycling the pool) the bound inputs of their kernels."""
    from plainref import kernels as rk
    from plainref.descriptor import build_descriptors
    from plainref.query import PlainStore
    cfg = ref_config(cfg_file)
    st = PlainStore(cfg, p["M"], device)
    block = 16
    for b in range(0, p["M"], block):
        pts = p["map"].clouds(b, b + block)
        st.append(build_descriptors(pts, cfg.cm, cfg.gmm,
                                    moment_dtype=moment_dtype),
                  p["ts_map"][b:b + block])
    st.freeze()
    req = p["req"]
    n_req = p["n_pool"] // req
    lo, hi = record_slice or (0, 0)
    recorded = {k % n_req for k in range(lo, hi)}
    recs, bounds_of = [], {}
    for r in range(n_req):
        rec_r = bounds_of.setdefault(r, [])
        with rk.recording(rec_r if r in recorded else []):
            pts = pool[r * req:(r + 1) * req].to(device)
            out = st.query_batch(build_descriptors(
                pts, cfg.cm, cfg.gmm, moment_dtype=moment_dtype))
        recs.append(out.cpu().numpy())
    # a traced slice that cycles the pool serves a request more than once
    bounds = [b for k in range(lo, hi) for b in bounds_of[k % n_req]]
    return st, np.concatenate(recs), bounds


# ---------------------------------------------------------------------------
# a window's numbers
# ---------------------------------------------------------------------------

def compare_stream(p, cfg_file, traffic, w, prog, host, device, seed,
                   moment_dtype=torch.float64):
    """The numbers compared, the parts they are made of, and the
    reference's kernel bound inputs of the traced slice."""
    off = p["Wu"]
    picks = sample(seed, p["n_win"], int(traffic["check_sample"]))
    lo, hi = w.slice
    st, recs, bounds = reference_stream(
        p, cfg_file, host, device, [off + j for j in picks], moment_dtype,
        (off + lo, off + hi) if hi > lo else None)
    parts = snapshot_parts(prog, snapshot(st, p["H"] + len(p["post"])))
    prog_recs = [w.results[j] for j in picks]
    prog_ans = [(r.gidx, r.corr, r.T) if r.found else None for r in prog_recs]
    parts.update(record_parts(prog_ans,
                              [as_answer(recs[off + j]) for j in picks]))
    return numbers_of(parts), parts, bounds, len(picks)


def compare_serve(p, cfg_file, w, prog, pool, device,
                  moment_dtype=torch.float64):
    """The numbers compared of a serving window: the map's store and
    every pool cloud's answer against the reference, and every answer of
    one pool cloud against its first; the parts they are made of; and the
    reference's kernel bound inputs of the traced slice."""
    lo, hi = w.slice
    st, recs, bounds = reference_serve(
        p, cfg_file, pool, device, moment_dtype,
        (lo, hi) if hi > lo else None)
    parts = snapshot_parts(prog, snapshot(st, p["M"]))
    # every answer the window served for one pool cloud is the same
    first, cycles = {}, 0
    for i, res in zip(w.pool_of, w.results):
        for k, a in enumerate(res):
            key = i + k
            if key not in first:
                first[key] = a
            elif not same_answer(first[key], a):
                cycles += 1
    parts["cycles"] = cycles
    keys = sorted(first)
    parts.update(record_parts([first[k] for k in keys],
                              [as_answer(recs[k]) for k in keys]))
    return numbers_of(parts), parts, bounds, len(keys)


def same_answer(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return (a[0] == b[0] and a[1] == b[1]
            and np.array_equal(np.asarray(a[2]), np.asarray(b[2])))
