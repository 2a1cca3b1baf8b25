"""Synthetic drives rendered from a seed: the world, the route, the clouds.

A world is a set of box structures (cx, cy, sx, sy, height) at the density
of `tests/synth.make_world` (40 structures over 240 m x 240 m), laid over
the corridor of a route. A route is a smooth road (a sine in y over x)
sampled at equal arc length; a pose is (x, y, heading). A cloud is what
`tests/synth.render_scan` samples from a pose (each structure within range
gives points uniform in its box, plus a ground disc, all moved to the
sensor frame with Gaussian noise), padded to the configuration's
max_points as `contour_context_tpu_torch.utils.io.pad_points` pads: xyz
and a validity flag, pad rows at x = 1e6.

Everything random comes from a torch.Generator on the target device, seeded
from (seed, what, chunk): a chunk of scans renders the same whatever else
was rendered before it, so the reference renders exactly the program's
inputs again.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WORLD_CHUNK = -1          # the generator stream of the world's structures
RENDER_CHUNK = 16         # scans drawn from one generator seed


def mix(seed: int, what: int, chunk: int) -> int:
    """A 63-bit generator seed from the run's seed (any whole number up to
    a little over 2**31, or larger), a stream id and a chunk index."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (what + 7) * 0xBF58476D1CE4E5B9
         + (chunk + 11) * 0x94D049BB133111EB) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def generator(device, seed: int, what: int, chunk: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, what, chunk))
    return g


def route_poses(n: int, spacing_m: float, amplitude_m: float,
                wavelength_m: float, start: int = 0) -> np.ndarray:
    """(n, 3) float64 poses (x, y, heading) of scans start..start+n-1 along
    the road y = A sin(2 pi x / wl), spaced `spacing_m` apart along it."""
    s_end = (start + n) * spacing_m + 10.0
    xs = np.linspace(0.0, s_end, int(s_end * 20) + 2)
    ys = amplitude_m * np.sin(2 * np.pi * xs / wavelength_m)
    arc = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(xs),
                                                    np.diff(ys)))])
    s = (start + np.arange(n)) * spacing_m
    x = np.interp(s, arc, xs)
    y = amplitude_m * np.sin(2 * np.pi * x / wavelength_m)
    heading = np.arctan2(2 * np.pi * amplitude_m / wavelength_m
                         * np.cos(2 * np.pi * x / wavelength_m), 1.0)
    return np.stack([x, y, heading], axis=1)


def offset_poses(poses: np.ndarray, lateral_m: float,
                 reverse: bool) -> np.ndarray:
    """The same places seen from `lateral_m` to the left of the direction
    of travel, heading reversed when `reverse` (the opposite lane)."""
    x, y, th = poses[:, 0], poses[:, 1], poses[:, 2]
    out = np.stack([x - lateral_m * np.sin(th), y + lateral_m * np.cos(th),
                    th + (np.pi if reverse else 0.0)], axis=1)
    out[:, 2] = (out[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return out


def make_world(seed: int, poses: np.ndarray, world: dict,
               device) -> torch.Tensor:
    """(N, 5) float32 structures over the bounding box of `poses` widened
    by the sensor range, at `world`'s density (structures per tile)."""
    pad = world["max_range_m"] + 10.0
    x0, x1 = poses[:, 0].min() - pad, poses[:, 0].max() + pad
    y0, y1 = poses[:, 1].min() - pad, poses[:, 1].max() + pad
    n = int(round(world["structures"] * (x1 - x0) * (y1 - y0)
                  / world["tile_m"] ** 2))
    g = generator(device, seed, WORLD_CHUNK, 0)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=device,
                                           dtype=torch.float64)

    cols = [u(x0, x1), u(y0, y1), u(1.0, 8.0), u(1.0, 8.0), u(0.5, 8.0)]
    return torch.stack(cols, dim=1).to(torch.float32)


def render(world_t: torch.Tensor, poses: np.ndarray, seed: int, what: int,
           chunk: int, render_cfg: dict, max_points: int,
           lidar_height: float) -> torch.Tensor:
    """(S, max_points, 4) float32 clouds on the world's device of the S
    poses of one chunk, drawn from generator (seed, what, chunk)."""
    dev = world_t.device
    g = generator(dev, seed, what, chunk)
    f32 = torch.float32
    S, N = len(poses), world_t.shape[0]
    per = int(render_cfg["pts_per_struct"])
    n_gnd = int(render_cfg["ground_pts"])
    rng_m = float(render_cfg["max_range_m"])
    p = torch.as_tensor(poses, dtype=f32, device=dev)          # (S, 3)
    cx, cy, sx, sy, h = world_t.unbind(1)
    near = torch.hypot(cx[None] - p[:, 0:1], cy[None] - p[:, 1:2]) <= rng_m
    u = torch.rand((S, N, per, 3), generator=g, device=dev, dtype=f32)
    xs = cx[None, :, None] + (u[..., 0] - 0.5) * sx[None, :, None]
    ys = cy[None, :, None] + (u[..., 1] - 0.5) * sy[None, :, None]
    zs = u[..., 2] * h[None, :, None]
    box = torch.stack([xs, ys, zs], -1).reshape(S, N * per, 3)
    box_ok = near[:, :, None].expand(S, N, per).reshape(S, N * per)
    ang = 2 * math.pi * torch.rand((S, n_gnd), generator=g, device=dev,
                                   dtype=f32)
    rad = 2.0 + (rng_m - 2.0) * torch.rand((S, n_gnd), generator=g,
                                           device=dev, dtype=f32)
    gnd = torch.stack([p[:, 0:1] + rad * torch.cos(ang),
                       p[:, 1:2] + rad * torch.sin(ang),
                       torch.zeros_like(rad)], -1)
    allp = torch.cat([box, gnd], 1)                            # (S, T, 3)
    ok = torch.cat([box_ok, torch.ones((S, n_gnd), dtype=torch.bool,
                                       device=dev)], 1)
    c, s = torch.cos(-p[:, 2:3]), torch.sin(-p[:, 2:3])
    dx, dy = allp[..., 0] - p[:, 0:1], allp[..., 1] - p[:, 1:2]
    pts = torch.stack([c * dx - s * dy, s * dx + c * dy,
                       allp[..., 2] - lidar_height], -1)
    pts = pts + render_cfg["noise_m"] * torch.randn(
        pts.shape, generator=g, device=dev, dtype=f32)
    # the valid points first, in order, then the pad rows
    order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices
    pts = pts.gather(1, order[..., None].expand(S, -1, 3))
    n_ok = ok.sum(1)
    if int(n_ok.max()) > max_points:
        raise ValueError(f"a cloud has {int(n_ok.max())} points, more than "
                         f"max_points {max_points}")
    out = torch.zeros((S, max_points, 4), dtype=f32, device=dev)
    T = min(max_points, pts.shape[1])
    out[:, :T, :3] = pts[:, :T]
    valid = torch.arange(max_points, device=dev)[None] < n_ok[:, None]
    out[..., 3] = valid.to(f32)
    out[..., 0] = torch.where(valid, out[..., 0], 1e6)
    out[..., 1:3] = torch.where(valid[..., None], out[..., 1:3], 0.0)
    return out


class Drive:
    """Scans at `poses` in `world`: the clouds of any range of them,
    rendered on demand chunk by chunk from the seed (stream `what`)."""

    def __init__(self, seed: int, poses: np.ndarray, world: torch.Tensor,
                 cfg_file: dict, what: int):
        self.seed, self.poses, self.world, self.what = seed, poses, world, what
        self.render_cfg = cfg_file["world"]
        cm = cfg_file["pipeline"]["cm"]
        self.max_points = int(cm["max_points"])
        self.lidar_height = float(cm["lidar_height"])

    def __len__(self) -> int:
        return len(self.poses)

    def clouds(self, lo: int, hi: int) -> torch.Tensor:
        """(hi - lo, max_points, 4) clouds of scans lo..hi-1 on the
        world's device; lo and hi are multiples of RENDER_CHUNK or hi is
        the drive's end."""
        if lo % RENDER_CHUNK or (hi % RENDER_CHUNK and hi != len(self)):
            raise ValueError(f"clouds({lo}, {hi}): not on chunk bounds")
        parts = [render(self.world, self.poses[c:min(c + RENDER_CHUNK, hi)],
                        self.seed, self.what, c // RENDER_CHUNK,
                        self.render_cfg, self.max_points, self.lidar_height)
                 for c in range(lo, hi, RENDER_CHUNK)]
        return torch.cat(parts) if len(parts) > 1 else parts[0]
