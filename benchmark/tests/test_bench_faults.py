"""The harness with the timed path broken underneath: each fault that a
cell can have turns `correct` false. The runs skip the look for a card
and run on the CPU at a tiny size."""

import pytest
import torch


def _run(spec, tiny, cell):
    import run
    return run.run_cell(spec, cell, 424242, 0.3, False, "cpu", tiny[cell])


def test_stream_answer_altered(spec, tiny, monkeypatch):
    from contour_context_tpu_torch import db as pdb
    orig = pdb.query_step

    def altered(*a, **k):
        rec = orig(*a, **k)
        return torch.where(torch.arange(rec.shape[-1]) == 1, rec + 1, rec)

    monkeypatch.setattr(pdb, "query_step", altered)
    res = _run(spec, tiny, "k08-revisit-10hz")
    assert not res["correct"]
    assert res["checks"]["mismatch"]["value"] > 0


def test_stream_step_leaves_its_state_unchanged(spec, tiny, monkeypatch):
    from contour_context_tpu_torch import db as pdb

    def no_append(self, pts, ts_t):
        desc = pdb.build_descriptor(pts, self.cfg.cm, self.cfg.gmm)
        rec = pdb.query_step(self.store, self.keys_q, desc, self.state,
                             self.cfg)
        self.recs_store.index_copy_(0, self._rows(1), rec[None])

    monkeypatch.setattr(pdb.ContourDB, "_step_body", no_append)
    res = _run(spec, tiny, "k08-revisit-10hz")
    assert not res["correct"]
    assert res["checks"]["mismatch"]["value"] > 0


def test_serve_half_the_batch_left_out(spec, tiny, monkeypatch):
    from contour_context_tpu_torch import db as pdb
    orig = pdb.query_step_batch

    def half(store, keys_q, descs, searchable_b, cfg, depth=None):
        B = descs.keys.shape[0]
        keep = pdb.ScanDesc(*[x[:B // 2] for x in descs])
        recs = orig(store, keys_q, keep, searchable_b[:B // 2], cfg, depth)
        return torch.cat([recs, torch.zeros_like(recs)])

    monkeypatch.setattr(pdb, "query_step_batch", half)
    res = _run(spec, tiny, "kaist-serve-b16")
    assert not res["correct"]
    assert res["checks"]["mismatch"]["value"] > 0


@pytest.mark.parametrize("col,delta,number", [
    (2, 1e-3, "corr_gap"),          # the correlation
    (3, 0.5, "pose_gap"),           # x of the pose, half a BEV cell
])
def test_serve_answer_altered(spec, tiny, monkeypatch, col, delta, number):
    from contour_context_tpu_torch import db as pdb
    orig = pdb.query_step_batch

    def altered(*a, **k):
        recs = orig(*a, **k)
        recs[:, col] += delta       # where the answer is made
        return recs

    monkeypatch.setattr(pdb, "query_step_batch", altered)
    res = _run(spec, tiny, "kaist-serve-b16")
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]
