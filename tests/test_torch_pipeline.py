"""The port's file pipeline and CLI against the JAX package's
(mirrors tests/test_pipeline_e2e.py: e2e, q16, fused, revisit found).

A 10-scan KITTI-format dataset (scans 8 and 9 revisit scans 1 and 3, 6 s a
scan; tests/test_torch_pipeline_data.py) goes through JAX's
`LoopClosurePipeline` on the unfused per-scan path with `save_mid_dir`, and
through the port on the CPU in every way a JAX caller can ask for (the q16
wire format, a caller's loader and mid-stream drains are in
tests/test_torch_pipeline_q16.py):
- `LoopClosurePipeline(cfg, ev, 16, True, mid_dir)`: positional
  `block_for_timing` and `save_mid_dir`, the JAX order (the device is a
  keyword);
- the CLI with `--save-mid-dir`, `--timing-log` and `--trace-dir` (its
  default config patched to the tests' 16384-point clouds);
- `run_batch(p, l, o, cfg, None, True)`: positional `fused_step`.
Outcome files are held line by line to JAX's (`assert_outcomes_match`:
TP/FP/FN, ids and paths exactly, correlation to rtol and atol 1e-4, the
pose-error columns to atol 2e-3, T's band of 2e-3 cells where two float32
LM paths meet, in metres at 1 m cells). The contour dumps are held to
JAX's: row count, levels, cell counts and flags exactly, the floats to atol
1e-4 (the descriptor's eigen-derived band); the BEV images byte for byte. Every JAX-valid call
signature is valid on the port with the same meaning, and the lazy
top-level exports resolve.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from test_torch_pipeline_data import (CFG, JCFG, N, assert_outcomes_match,
                                      dataset, evaluator)

from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch import pipeline as tpipe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_runs(dataset):
    """JAX's unfused run with save_mid_dir."""
    from contour_context_tpu.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu.pipeline import LoopClosurePipeline

    f_pose, f_laser, d = dataset
    (d / "mid_jax").mkdir()
    ev = ContLCDEvaluator(f_pose, f_laser, JCFG.correlation_thres)
    p = LoopClosurePipeline(JCFG, ev, 16, save_mid_dir=str(d / "mid_jax"))
    p.run()
    p.save_outcome(str(d / "jax_unfused.txt"))
    return d / "jax_unfused.txt", d / "mid_jax"


def _assert_dumps_match(got_dir, want_dir):
    from contour_context_tpu_torch.utils.dumps import load_contours

    for i in range(N):
        a = load_contours(str(want_dir / ("contours-%06d.txt" % i)))
        b = load_contours(str(got_dir / ("contours-%06d.txt" % i)))
        assert a.shape == b.shape and a.shape[0] > 20, (i, a.shape, b.shape)
        exact = [0, 1, 18, 19]
        np.testing.assert_array_equal(b[:, exact], a[:, exact])
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    bev = sorted(f for f in os.listdir(want_dir) if f.startswith("bev-"))
    assert len(bev) == N and sorted(
        f for f in os.listdir(got_dir) if f.startswith("bev-")) == bev
    for f in bev:
        assert (got_dir / f).read_bytes() == (want_dir / f).read_bytes(), f


def test_positional_block_for_timing_and_dumps(dataset, jax_runs):
    _, _, d = dataset
    mid = d / "mid_pos"
    mid.mkdir()
    pipe = tpipe.LoopClosurePipeline(CFG, evaluator(dataset), 16, True,
                                     str(mid), device="cpu")
    assert pipe.block and pipe.save_mid_dir == str(mid)
    assert not pipe.q16_transport and not pipe.fused_step
    pipe.run()
    pipe.save_outcome(str(d / "pos.txt"))
    assert_outcomes_match(d / "pos.txt", jax_runs[0])
    _assert_dumps_match(mid, jax_runs[1])
    assert set(pipe.stp.logs) == {"make bev", "query (fused)",
                                  "Update database"}


def test_cli_flags(dataset, jax_runs, monkeypatch):
    import contour_context_tpu_torch.__main__ as cli

    monkeypatch.setattr(cli, "PipelineConfig", lambda: CFG)
    f_pose, f_laser, d = dataset
    mid, trace, log = d / "mid_cli", d / "trace", d / "timing.txt"
    mid.mkdir()
    cli.main(["--pose", f_pose, "--laser", f_laser, "--outcome",
              str(d / "cli.txt"), "--device", "cpu", "--save-mid-dir",
              str(mid), "--timing-log", str(log), "--trace-dir", str(trace),
              "--fused-step"])  # ignored: save_mid_dir needs the descriptor
    assert_outcomes_match(d / "cli.txt", jax_runs[0])
    _assert_dumps_match(mid, jax_runs[1])
    text = log.read_text()
    assert "make bev" in text and "query (fused)" in text
    events = json.loads((trace / tpipe.TRACE_FILE).read_text())
    assert len(events["traceEvents"]) > 100


def test_run_batch_positional_fused_step(dataset, jax_runs):
    f_pose, f_laser, d = dataset
    pipe = tpipe.run_batch(f_pose, f_laser, str(d / "rb.txt"), CFG, None,
                           True, device="cpu")
    assert pipe.fused_step
    # only the fused step fills the DB's record ring
    assert (pipe.db.recs_store[:N, 0] > 0.5).sum() == 2
    assert_outcomes_match(d / "rb.txt", jax_runs[0])


def _signature_pairs():
    from contour_context_tpu import db as jdb
    from contour_context_tpu import online as jonline
    from contour_context_tpu import pipeline as jpipe
    from contour_context_tpu.eval import sweep as jsweep
    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch import online as tonline
    from contour_context_tpu_torch.eval import sweep as tsweep

    return [
        (jpipe.LoopClosurePipeline.__init__,
         tpipe.LoopClosurePipeline.__init__),
        (jpipe.LoopClosurePipeline.run, tpipe.LoopClosurePipeline.run),
        (jpipe.LoopClosurePipeline.set_point_loader,
         tpipe.LoopClosurePipeline.set_point_loader),
        (jpipe.run_batch, tpipe.run_batch),
        (jdb.ContourDB.query_ranged_knn, tdb.ContourDB.query_ranged_knn),
        (jdb.ContourDB.query_ranged_knn_host,
         tdb.ContourDB.query_ranged_knn_host),
        (jdb.ContourDB.step_chain_async, tdb.ContourDB.step_chain_async),
        (jdb.ContourDB.step_chain_dyn_async,
         tdb.ContourDB.step_chain_dyn_async),
        (jdb.ContourDB.stage_chain_k, tdb.ContourDB.stage_chain_k),
        (jonline.OnlineSpinner.__init__, tonline.OnlineSpinner.__init__),
        (jsweep.run_sweep_id, tsweep.run_sweep_id),
    ]


@pytest.mark.parametrize("i", range(11))
def test_jax_signatures_hold_on_the_port(i):
    """The JAX parameters come first on the port, in order, with the same
    defaults; what the port adds (the device) is keyword-only."""
    j, t = _signature_pairs()[i]
    pj = list(inspect.signature(j).parameters.values())
    pt = list(inspect.signature(t).parameters.values())
    assert [(p.name, p.kind, p.default) for p in pt[:len(pj)]] == \
        [(p.name, p.kind, p.default) for p in pj], t.__qualname__
    assert all(p.kind == p.KEYWORD_ONLY for p in pt[len(pj):]), pt


def test_lazy_exports():
    import contour_context_tpu as jpkg
    import contour_context_tpu_torch as tpkg
    from contour_context_tpu_torch import db, online, pipeline, types

    for name, mod in (("ContourDB", db), ("QueryHandle", db),
                      ("drain_handles", db), ("LoopClosurePipeline", pipeline),
                      ("run_batch", pipeline), ("OnlineSpinner", online),
                      ("LoopDetection", online), ("ScanDesc", types)):
        assert getattr(tpkg, name) is getattr(mod, name)
        assert hasattr(jpkg, name)
    configs = [n for n in dir(jpkg) if n[0].isupper() or n.endswith("_config")
               or n.startswith("load_")]
    for name in configs:
        assert getattr(tpkg, name) is getattr(tconfig, name), name
    assert "mulran_pipeline_config" in configs
    with pytest.raises(AttributeError):
        tpkg.no_such_name
