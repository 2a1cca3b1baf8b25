"""The port's pipeline with the q16 wire format against the JAX package's
(mirrors tests/test_pipeline_e2e.py's q16 and fused tests).

The dataset of tests/test_torch_pipeline_data.py goes through JAX's
unfused pipeline with `q16_transport`, and through the port on the CPU with
q16 transport on the unfused path and on the fused step, the latter with a
caller's point loader (`set_point_loader`) and `DRAIN_BLOCK` patched to 2,
so records are drained mid-stream. The outcome files are held line by line
to JAX's (`assert_outcomes_match`: TP/FP/FN, ids and paths exactly,
correlation to rtol and atol 1e-4, the pose-error columns to atol 2e-3).
"""

import pytest
import torch

from test_torch_pipeline_data import (CFG, JCFG, N, assert_outcomes_match,
                                      dataset, evaluator)

from contour_context_tpu_torch import pipeline as tpipe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_q16(dataset):
    from contour_context_tpu.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu.pipeline import LoopClosurePipeline

    f_pose, f_laser, d = dataset
    ev = ContLCDEvaluator(f_pose, f_laser, JCFG.correlation_thres)
    p = LoopClosurePipeline(JCFG, ev, 16, q16_transport=True)
    p.run()
    p.save_outcome(str(d / "jax_q16.txt"))
    return d / "jax_q16.txt"


def test_fused_q16_with_a_loader_and_mid_stream_drains(dataset, jax_q16,
                                                       monkeypatch):
    from contour_context_tpu_torch.utils.io import read_kitti_bin

    _, _, d = dataset
    monkeypatch.setattr(tpipe, "DRAIN_BLOCK", 2)
    pipe = tpipe.LoopClosurePipeline(CFG, evaluator(dataset), 16,
                                     q16_transport=True, fused_step=True,
                                     device="cpu")
    loads = []
    pipe.set_point_loader(lambda p: loads.append(p) or read_kitti_bin(p))
    for _ in range(5):
        assert pipe.spin_once()
    # 4 pending records drained 2 mid-stream, in scan order
    assert [r.q_seq for r in pipe.results] == [0, 1]
    assert len(pipe._pending) == 3
    pipe.run()
    assert [r.q_seq for r in pipe.results] == list(range(N))
    # each scan loaded once: the prefetched upload is the one the step uses
    assert len(loads) == N and loads == sorted(set(loads))
    pipe.save_outcome(str(d / "q16.txt"))
    assert_outcomes_match(d / "q16.txt", jax_q16)
    assert (pipe.db.recs_store[:N, 0] > 0.5).sum() == 2   # the record ring


def test_unfused_q16(dataset, jax_q16):
    _, _, d = dataset
    pipe = tpipe.LoopClosurePipeline(CFG, evaluator(dataset), 16, False,
                                     None, True, device="cpu")
    pipe.run(progress_every=4)
    pipe.save_outcome(str(d / "q16u.txt"))
    assert_outcomes_match(d / "q16u.txt", jax_q16)
