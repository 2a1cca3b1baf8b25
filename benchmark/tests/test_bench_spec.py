"""Discovery by name, and BENCHMARK.json against the contract's limits."""

import dataclasses
import json
import os
import re
import shutil

import pytest

from harness.spec import Spec, dataclass_from_dict

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_cell_finds_its_files(spec):
    for w in spec.bench["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert spec.traffic(w["traffic"])["kind"] in ("stream", "serve")
        assert set(spec.limits(w["name"])) == {
            "mismatch", "corr_gap", "pose_gap", "desc_gap"}
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics_of(w["name"], kind):
                assert callable(spec.reader(m["name"]))


def test_benchmark_json_keeps_to_the_contract(spec):
    b = spec.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        for k in c["reduced"]:
            assert NAME.match(k) and k in spec.config(c["name"])
        names.add(c["name"])
    cells = {w["name"] for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == names
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert m["source"] in SOURCES
            assert set(m.get("workloads", [])) <= cells
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        # each cell that reports the metric reports what it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in cells:
        assert len(spec.metrics_of(w, "end_to_end")) >= 2
        assert spec.metrics_of(w, "per_layer")
    assert len(json.dumps(b)) < 64 * 1024


def test_configs_are_the_ports_presets(spec):
    from contour_context_tpu_torch.config import (PipelineConfig,
                                                  mulran_pipeline_config)
    from plainref import config as ref
    presets = {"kitti08": (PipelineConfig(), ref.PipelineConfig()),
               "mulran-kaist": (mulran_pipeline_config(),
                                ref.mulran_pipeline_config())}
    for name, (port, plain) in presets.items():
        f = spec.config(name)["pipeline"]
        assert dataclass_from_dict(PipelineConfig(), f) == port
        assert json.loads(json.dumps(dataclasses.asdict(plain))) == f


def test_dataclass_from_dict_refuses_unknown_keys():
    from contour_context_tpu_torch.config import PipelineConfig
    with pytest.raises(KeyError):
        dataclass_from_dict(PipelineConfig(), {"cm": {"no_such": 1}})


def test_a_cell_added_as_files_only(tmp_path, tiny):
    """A throwaway cell: a new traffic file (new territory after the
    history), a limits file, a metric reader and BENCHMARK.json entries;
    no harness file changes. It runs end to end on the CPU."""
    import run
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(src, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(os.path.dirname(src), "BENCHMARK.json"), root)
    b = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "revisit-10hz.json")
                         .read_text())
    traffic["after_history"] = "explore"
    (bench / "traffic" / "explore-10hz.json").write_text(json.dumps(traffic))
    (bench / "limits" / "k08-explore-10hz.json").write_text(
        (bench / "limits" / "k08-revisit-10hz.json").read_text())
    (bench / "metrics" / "scans_done.py").write_text(
        "def read(run):\n    return float(run.window.items)\n")
    b["workloads"].append({"name": "k08-explore-10hz", "config": "kitti08",
                           "traffic": "explore-10hz", "chips": 1,
                           "why": "new territory only"})
    b["end_to_end"].append({"name": "scans_done", "unit": "scans",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["k08-explore-10hz"]})
    for m in b["end_to_end"]:
        if m["name"] == "scan_ms":
            m["workloads"].append("k08-explore-10hz")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = Spec(str(root), str(bench))
    res = run.run_cell(spec, "k08-explore-10hz", 7, 0.3, False, "cpu",
                       tiny["k08-revisit-10hz"])
    assert res["correct"]
    assert res["metrics"]["scans_done"]["value"] == 3.0
    assert {"scan_ms", "setup_s"} <= set(res["metrics"])


def test_host_threads_only_where_a_configuration_states_them(spec):
    import run
    assert run.host_threads(spec, "k08-revisit-10hz") == 1
    assert run.host_threads(spec, "kaist-serve-b16") is None
