"""The stage-split profile script of the port, run on the CPU at a small size.

`python -m contour_context_tpu_torch.profile_step` measures the fused step
on the card; here it runs on the CPU with 16384-point scans and short lanes,
so the script keeps working: every stage is timed, the build split covers
build_descriptor's stages, and the profiled scans leave the stream whole.
"""

import torch

from contour_context_tpu_torch import profile_step

torch.set_num_threads(2)


def test_profile_step_runs_on_cpu(tmp_path):
    out = tmp_path / "profile.json"
    res = profile_step.main(["--device", "cpu", "--lane-scans", "7",
                             "--reps", "2", "--profile-scans", "1",
                             "--max-points", "16384", "--capacity", "16",
                             "--out", str(out)])
    assert res["scans"] == [18, 19]
    assert set(res["stage_ms"]) == {"upload", "build", "search",
                                    "stages(search..merge)", "query_step",
                                    "step_async"}
    assert set(res["build_split_ms"]) == {"raster", "cc", "tables", "keys",
                                          "bcis", "gmm"}
    assert all(ms > 0 for ms in res["stage_ms"].values())
    assert list(res["depth_ms"]) == ["search", "hints", "check1", "cascade",
                                     "merge", "init", "record"]
    assert all(ms > 0 for ms in res["depth_ms"].values())
    assert "aten::" in res["profile_table"]
    assert "device_busy_ms_per_scan" not in res      # CUDA only
    assert out.read_text().startswith("{")


def test_profile_step_dynamic_runs_on_cpu():
    """`--dynamic` (the stream under dynamic_thres, whose card run reports
    the two dynamic scans' device time a launch) at the same small size."""
    res = profile_step.main(["--device", "cpu", "--lane-scans", "7",
                             "--reps", "2", "--profile-scans", "1",
                             "--max-points", "16384", "--capacity", "16",
                             "--dynamic"])
    assert res["dynamic_thres"] is True
    assert res["scans"] == [18, 19]
    assert all(ms > 0 for ms in res["stage_ms"].values())
    assert "kernel_device_us" not in res             # CUDA only


def test_block_split_runs_on_cpu():
    """The block-step split (chip_smoke.py prints it from the card) on a
    small CPU map: positive parts, the batched tail's records equal to the
    same queries' one at a time, the card-only counts absent, the DB
    untouched."""
    import numpy as np

    from synth import make_world, render_scan

    from contour_context_tpu_torch import db as tdb
    from contour_context_tpu_torch.config import (ContourManagerConfig,
                                                  PipelineConfig)
    from contour_context_tpu_torch.utils.io import pad_points

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    clouds = np.stack([pad_points(render_scan(world, (10.0 * i, 0.0, 0.0),
                                              seed=500 + i), 16384)
                       for i in range(4)])
    db = tdb.ContourDB(cfg, capacity=8, device="cpu")
    for i in range(4):
        db.step_async(clouds[i], i, 20.0 * i)
    state = db.state.clone()
    split = profile_step.block_split(db, clouds[:2], cfg)
    assert split["B"] == 2 and db.n == 4 and torch.equal(db.state, state)
    assert all(split[k] > 0 for k in ("build_ms", "search_ms", "tails_ms",
                                      "tails_one_by_one_ms"))
    assert split["records"].shape == (2, tdb.RECORD_WIDTH)
    assert torch.equal(split["records"], split["records_one_by_one"])
    assert split["records"][1, 6] > 0                # key hits: a real query
    for k in ("build_device_ops", "search_device_ops", "tail_device_ops",
              "one_by_one_device_ops", "tail_device_busy_ms",
              "tail_host_syncs", "one_by_one_host_syncs"):
        assert split[k] is None, k                   # CUDA only
