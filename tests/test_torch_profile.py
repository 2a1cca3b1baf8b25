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
    assert "aten::" in res["profile_table"]
    assert "device_busy_ms_per_scan" not in res      # CUDA only
    assert out.read_text().startswith("{")
