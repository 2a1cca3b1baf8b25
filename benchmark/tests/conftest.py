"""The benchmark's own CPU tests: `python -m pytest benchmark/tests`.
They import the harness as `run.py` does: from benchmark/ and the root."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# small shapes for the CPU: a 4096-point cloud of few structures, a short
# history at 1 Hz so that a revisit is older than the 15 s window
TINY_WORLD = {"pts_per_struct": 60, "ground_pts": 600}
TINY = {
    "k08-revisit-10hz": {
        "config": {"history_scans": 48, "capacity": 64, "sensor_hz": 1.0,
                   "world": TINY_WORLD,
                   "pipeline": {"cm": {"max_points": 4096}}},
        "traffic": {"revisit_back_scans": 20, "warmup_scans": 2,
                    "check_sample": 3, "profile_items": 2}},
    "kaist-serve-b16": {
        "config": {"map_scans": 32, "capacity": 32, "world": TINY_WORLD,
                   "pipeline": {"cm": {"max_points": 4096}}},
        "traffic": {"pool_clouds": 32, "profile_start": 1,
                    "profile_items": 1}},
}


@pytest.fixture(scope="session", autouse=True)
def _threads():
    import torch
    torch.set_num_threads(4)


@pytest.fixture
def tiny():
    import copy
    return copy.deepcopy(TINY)


@pytest.fixture
def spec():
    from harness.spec import Spec
    return Spec(ROOT, BENCH)
