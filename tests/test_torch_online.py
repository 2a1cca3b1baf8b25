"""The port's online spinner and live view against the JAX package's
(mirrors tests/test_online.py:16-55 and :162-200, and tests/test_liveview.py).

The 10-scan revisit stream of tests/test_online.py (scans 8 and 9 revisit
scans 1 and 3, 6 s a scan) is fed to JAX's `OnlineSpinner` and to the
port's on the CPU, fused and unfused, with a pause and a resume through the
control file mid-stream: the port's detections equal JAX's (q_seq and
cand_seq exactly, correlation to rtol and atol 1e-4, T to rtol 1e-4 and
atol 2e-3 cells, the record bands), and nothing is dropped. `finish()`
returns while paused with a full queue, counting what it drops, and
re-raises an error of the spin thread (a bad scan, or a kernel failure).
The live view draws the same loops as JAX's; it needs matplotlib and skips
without it.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from synth import make_world, render_scan

from contour_context_tpu import config as jconfig
from contour_context_tpu_torch import config as tconfig
from contour_context_tpu_torch.online import LoopDetection, OnlineSpinner

torch.set_num_threads(2)

JCFG = jconfig.PipelineConfig(cm=jconfig.ContourManagerConfig(max_points=16384))
CFG = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(max_points=16384))
POSES = [(10.0 * i, 0.0, 0.0) for i in range(8)] + [
    (10.5, 0.8, 0.2), (30.0, -1.0, -0.15)]


@pytest.fixture(scope="module")
def scans():
    world = make_world(11, n_structs=220, extent=160.0)
    return [render_scan(world, p, seed=500 + i) for i, p in enumerate(POSES)]


def _stream(sp, scans, ctrl):
    """Feed the scans; pause and resume through the control file after the
    fifth."""
    hits = []
    sp.on_loop = hits.append
    sp.start()
    for i, pts in enumerate(scans):
        assert sp.feed(pts, i, 6.0 * i, timeout=120)
        if i == 4:
            open(ctrl, "w").write("pause")
            deadline = time.time() + 240
            while not sp._paused.is_set() and time.time() < deadline:
                time.sleep(0.02)
            assert sp._paused.is_set()
            open(ctrl, "w").write("resume")
    sp.finish()
    assert sp.n_processed == len(scans) and sp.dropped == 0
    assert hits == sp.detections
    return sp.detections


@pytest.fixture(scope="module")
def jax_detections(scans, tmp_path_factory):
    from contour_context_tpu.online import OnlineSpinner as JSpinner

    ctrl = str(tmp_path_factory.mktemp("jon") / "status")
    return _stream(JSpinner(JCFG, capacity=16, control_file=ctrl,
                            drain_block=2), scans, ctrl)


def _assert_same(got, want):
    assert [(d.q_seq, d.cand_seq) for d in got] == \
        [(d.q_seq, d.cand_seq) for d in want]
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.correlation, a.correlation, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(b.T_delta, a.T_delta, rtol=1e-4,
                                   atol=2e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_online_stream_with_control_matches_jax(scans, jax_detections,
                                                tmp_path, fused):
    ctrl = str(tmp_path / "status")
    sp = OnlineSpinner(CFG, 16, None, ctrl, 2, fused_step=fused,
                       device="cpu")
    got = _stream(sp, scans, ctrl)
    _assert_same(got, jax_detections)
    found = {d.q_seq: d.cand_seq for d in got
             if d.correlation >= CFG.correlation_thres}
    assert found == {8: 1, 9: 3}, got
    # terminate() stops accepting scans
    sp2 = OnlineSpinner(CFG, capacity=4, device="cpu")
    sp2.terminate()
    assert not sp2.feed(np.zeros((10, 3), np.float32), 0, 0.0)


def test_finish_while_paused_does_not_deadlock():
    cfg = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(
        max_points=2048))
    sp = OnlineSpinner(cfg, capacity=8, queue_depth=2, device="cpu")
    sp.start()
    sp.pause()
    pts = np.zeros((100, 3), np.float32)
    n_fed = 0
    while sp.feed(pts, n_fed, float(n_fed), timeout=0.05):
        n_fed += 1
    sp.finish()
    assert sp._thread is not None and not sp._thread.is_alive()
    # every fed scan is processed before the pause landed, or counted as
    # dropped by the end-of-stream-while-paused exit
    assert sp.n_processed + sp.dropped == n_fed
    assert sp.dropped > 0


def test_spin_error_reraised_by_finish():
    cfg = tconfig.PipelineConfig(cm=tconfig.ContourManagerConfig(
        max_points=2048))
    sp = OnlineSpinner(cfg, capacity=8, device="cpu")
    sp.start()
    sp.feed("not a point cloud", 0, 0.0)        # raises inside spin
    with pytest.raises(Exception):
        sp.finish()
    assert sp.error is not None


def test_device_error_on_the_spin_thread_is_not_swallowed(scans):
    """A failure of the step (here a kernel launch error, as the wrappers
    raise it on the card) ends the stream and reaches finish()."""
    sp = OnlineSpinner(CFG, capacity=8, device="cpu")

    def fail(*args):
        raise RuntimeError("search_tilemin: CUDA launch failed with error 1")

    sp.db.step_async = fail
    sp.start()
    sp.feed(scans[0], 0, 0.0)
    with pytest.raises(RuntimeError, match="launch failed"):
        sp.finish()
    assert sp.n_processed == 0 and not sp.detections


# -- the live view (tests/test_liveview.py) ----------------------------------

def _views(tmp_path, **kw):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    from contour_context_tpu.liveview import LiveLoopView as JView
    from contour_context_tpu_torch.liveview import LiveLoopView

    return (JView(str(tmp_path / "j.png"), **kw),
            LiveLoopView(str(tmp_path / "t.png"), **kw))


def test_liveview_incremental_render_and_colors(tmp_path):
    gt = np.array([[0.0, 0.0], [10.0, 0.0], [0.5, 0.2], [50.0, 50.0]])
    for view in _views(tmp_path, gt_xy=gt, gt_radius=5.0, every=1):
        for seq, (x, y) in enumerate(gt):
            view.add_pose(seq, x, y)
        view.add_loop(LoopDetection(2, 0, 0.9, np.zeros(3)))
        assert view.maybe_render()
        view.add_loop(LoopDetection(3, 1, 0.7, np.zeros(3)))
        view.render(final=True)
        assert view.n_tp == 1 and view.n_fp == 1
        assert os.path.getsize(view.out_path) > 0
        view.close()


def test_liveview_every_cadence(tmp_path):
    for view in _views(tmp_path, every=3):
        for seq in range(6):
            view.add_pose(seq, float(seq), 0.0)
        view.add_loop((3, 0))
        view.add_loop((4, 1))
        assert not view.maybe_render()
        view.add_loop((5, 2, 0.8))
        assert view.maybe_render()
        assert view.n_tp == 3
        view.close()


def test_liveview_threaded_feed_and_late_poses(tmp_path):
    counts = []
    for view in _views(tmp_path, every=1000):
        def feed(base, view=view):
            for i in range(50):
                view.add_pose(base + i, float(base + i), 1.0)
                if i % 5 == 0 and i >= 20:
                    view.add_loop((base + i, base + i - 20))

        ts = [threading.Thread(target=feed, args=(b,)) for b in (0, 100)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        view.add_loop((300, 0, 0.9))            # pose 300 not fed yet
        view.render()
        assert view._pending_loops == [(300, 0, 0.9)]
        view.add_pose(300, 1.0, 1.0)
        view.render(final=True)
        assert not view._pending_loops and view._drawn_poses == 101
        counts.append((view.n_tp, view.n_fp, view._taken_loops))
        view.close()
    assert counts[0] == counts[1] and counts[1][0] == 13
