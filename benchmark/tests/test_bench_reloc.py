"""The one-cloud relocalization cell (`kaist-reloc-b1`) on the CPU at a tiny
size: every request is one cloud, and the whole run agrees with the plain
reference, which computes each pool cloud alone: the map's store and every
found and gidx exactly, correlation and pose within the cell's limits (on
the CPU the LM's twin and the reference's chain can part in the last bits
of a record at any request size, seed by seed)."""

import copy


def test_one_cloud_requests_agree_with_the_reference(spec, tiny):
    import run
    cell = "kaist-reloc-b1"
    assert spec.traffic(spec.workload(cell)["traffic"])["request_clouds"] \
        == 1
    over = copy.deepcopy(tiny["kaist-serve-b16"])
    res = run.run_cell(spec, cell, 2 ** 31 + 77, 2.0, False, "cpu", over)
    assert res["correct"]
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["mismatch"] == 0 and checks["desc_gap"] == 0.0, checks
    assert res["notes"]["compared"] >= 1
    assert res["attempted"] == res["notes"]["items"]


def test_the_cell_runs_one_host_thread(spec):
    import run
    assert run.host_threads(spec, "kaist-reloc-b1") == 1
    cfg = spec.config("mulran-kaist-reloc")
    assert cfg["pipeline"]["cm"]["max_points"] == 64 * 1024
