"""The traffic generator: deterministic per seed, different across seeds,
the revisit geometry, and the refusals."""

import numpy as np
import pytest
import torch

from harness import drive
from harness import world as W


def _plan(spec, tiny, cell, seed, seconds=0.5):
    from harness.spec import merge
    wl = spec.workload(cell)
    cfg = merge(spec.config(wl["config"]), tiny[cell]["config"])
    traffic = merge(spec.traffic(wl["traffic"]), tiny[cell]["traffic"])
    return drive.plan(cfg, traffic, seconds, seed, "cpu"), cfg, traffic


@pytest.mark.parametrize("cell", ["k08-revisit-10hz", "kaist-serve-b16"])
def test_same_seed_same_inputs_other_seed_other(spec, tiny, cell):
    seed = 2 ** 31 + 12345          # more than 32 signed bits hold
    a, _, _ = _plan(spec, tiny, cell, seed)
    b, _, _ = _plan(spec, tiny, cell, seed)
    c, _, _ = _plan(spec, tiny, cell, seed + 1)
    first = "hist" if cell.startswith("k08") else "map"
    x, y, z = (p[first].clouds(16, 32) for p in (a, b, c))
    assert torch.equal(x, y)
    assert not torch.equal(x, z)
    assert torch.equal(a[first].world, b[first].world)
    # a chunk renders the same whatever was rendered before it
    assert torch.equal(a[first].clouds(0, 32)[16:], x)


def test_clouds_are_padded_as_the_port_pads(spec, tiny):
    p, cfg, _ = _plan(spec, tiny, "k08-revisit-10hz", 3)
    pts = p["hist"].clouds(0, 16)
    P = cfg["pipeline"]["cm"]["max_points"]
    assert pts.shape == (16, P, 4) and pts.dtype == torch.float32
    valid = pts[..., 3] > 0
    # valid points first, pad rows at x = 1e6 with flag 0
    assert torch.all(valid[:, :-1] >= valid[:, 1:])
    assert torch.all(pts[..., 0][~valid] == 1e6)
    assert int(valid.sum(1).min()) > 600


def test_revisits_are_older_than_the_window_and_reversed(spec, tiny):
    p, cfg, traffic = _plan(spec, tiny, "k08-revisit-10hz", 5)
    H, back = p["H"], traffic["revisit_back_scans"]
    hist, post = p["hist"].poses, p["post"].poses
    for j in range(len(post)):
        src = hist[H - back - j]
        assert np.hypot(*(post[j, :2] - src[:2])) == pytest.approx(
            traffic["lateral_m"])
        dth = (post[j, 2] - src[2] + np.pi) % (2 * np.pi) - np.pi
        assert abs(abs(dth) - np.pi) < 1e-9
        age = p["ts_post"][j] - p["ts_hist"][H - back - j]
        assert age > cfg["pipeline"]["db"]["tb"]["min_elapse"]


def test_route_spacing_along_the_road():
    poses = W.route_poses(200, 0.8, 40.0, 400.0)
    step = np.hypot(*np.diff(poses[:, :2], axis=0).T)
    assert np.allclose(step, 0.8, rtol=2e-3)


def test_refusals(spec, tiny):
    import run
    over = tiny["k08-revisit-10hz"]
    over["config"]["capacity"] = 52           # 48 + 2 + 5 > 52
    with pytest.raises(drive.Refused, match="grow inside the window"):
        _plan(spec, {"k08-revisit-10hz": over}, "k08-revisit-10hz", 1)
    wl = spec.workload("k08-revisit-10hz")
    cfg = spec.config(wl["config"])
    traffic = spec.traffic(wl["traffic"])
    with pytest.raises(drive.Refused, match="window scans"):
        drive.plan(cfg, traffic, 52.0, 1, "cpu")   # > max_window_scans
    # the cell as committed fits, inside K08: 3,552 + 8 + 510 <= 4,071
    p = drive.plan(cfg, traffic, 51.0, 1, "cpu")
    assert p["H"] + len(p["post"]) <= min(cfg["capacity"],
                                          cfg["drive_scans"])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(drive.Refused, match="TF32"):
            run._check_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
