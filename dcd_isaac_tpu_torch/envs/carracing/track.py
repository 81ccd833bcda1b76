"""Track geometry and the frame rasterizer, batched (port of
``dcd_isaac_tpu/envs/carracing/track.py``).

A ``Track`` holds N centerlines of ``capacity`` = 480 points with their
normal angles, border flags and valid masks.  ``build_track`` (kernel
B13b's second half), ``nearest_tile`` and ``render_frame`` (kernel B12,
with the preprocessing of ``env.py``) are the kernels' plain twins.  The
nearest-point search keeps the expanded |q|² + |p|² − 2 q·p of the JAX
package with every product and sum rounded in fp32 on its own, the cross
term elementwise (not a matmul), so that twin and kernel round alike
(with ``bezier``'s sin, cos, atan2 and sqrt, rounded from double); the
JAX comment at ``track.py:111-124`` says why reduced precision there is
wrong (the 44-unit² road threshold).  A division by a constant is a
product with its float32 reciprocal, as XLA compiles the JAX package, and
every sum runs in the order the kernels repeat.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .bezier import atan2, cos, f32, sin, sqrt

# Constants (car_racing_bezier.py:39-61; JAX track.py:18-33)
STATE_W, STATE_H = 96, 96
WINDOW_W, WINDOW_H = 1000, 800
SCALE = 6.0
TRACK_RAD = 900 / SCALE
PLAYFIELD = 2000 / SCALE
FPS = 50
ZOOM = 2.7
TRACK_WIDTH = 40 / SCALE
BORDER = 8 / SCALE
BORDER_MIN_COUNT = 4
ROAD_COLOR = np.array([0.4, 0.4, 0.4], np.float32)
GRASS_BASE = np.array([0.4, 0.8, 0.4], np.float32)
GRASS_PATCH = np.array([0.4, 0.9, 0.4], np.float32)
BAR_H = 5 * STATE_H // 40
CAPACITY = 480


def recip(c: float) -> float:
    """The float32 reciprocal of a constant divisor (XLA's x / c)."""
    return float(np.float32(1.0) / np.float32(c))


@dataclasses.dataclass(frozen=True)
class Track:
    points: torch.Tensor    # (N, P, 2) centered centerline
    beta: torch.Tensor      # (N, P) normal angle per point (pi/2 + alpha)
    border: torch.Tensor    # (N, P) bool: red/white border on this tile
    valid: torch.Tensor     # (N, P) bool: active points
    n_points: torch.Tensor  # (N,) int32
    offset: torch.Tensor    # (N, 2) world → centered offset (bbox centre)

    @property
    def capacity(self) -> int:
        return self.points.shape[1]

    def replace(self, **kw) -> 'Track':
        return dataclasses.replace(self, **kw)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis zero-padded to a power of two, halves added
    pairwise (x[:h] + x[h:]) until one is left: the order the kernels'
    lanes repeat."""
    L = x.shape[-1]
    p = 1 << max(L - 1, 0).bit_length()
    x = F.pad(x, (0, p - L))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def build_track(curve: torch.Tensor, valid: torch.Tensor = None) -> Track:
    """Curves (N, P, 2) → Track: betas, zero-length steps masked invalid,
    bbox centring and border flags (JAX track.py:48-105)."""
    N, P, _ = curve.shape
    if valid is None:
        valid = torch.ones((N, P), dtype=torch.bool, device=curve.device)
    d = torch.roll(curve, -1, 1) - curve
    alpha = atan2(d[..., 1], d[..., 0])
    beta = f32(np.pi / 2) + alpha
    valid = valid & ~(d == 0).all(-1)
    n = valid.sum(1).int()

    big = torch.full_like(curve[..., 0], 1e9)
    lo = lambda x: torch.where(valid, x, big).min(1).values
    hi = lambda x: torch.where(valid, x, -big).max(1).values
    min_x, min_y = lo(curve[..., 0]), lo(curve[..., 1])
    max_x, max_y = hi(curve[..., 0]), hi(curve[..., 1])
    offset = torch.stack([min_x + (max_x - min_x) * 0.5,
                          min_y + (max_y - min_y) * 0.5], -1)
    points = curve - offset[:, None]

    dbeta = (torch.roll(beta, -1, 1) - beta).abs()
    mean_abs = tree_sum(torch.where(valid, dbeta, torch.zeros_like(dbeta))
                        ) / n.clamp(min=1).float()
    good = torch.ones_like(valid)
    oneside = torch.zeros_like(beta)
    for neg in range(BORDER_MIN_COUNT):
        b1 = torch.roll(beta, neg, 1)         # beta[i - neg]
        b2 = torch.roll(beta, neg + 1, 1)     # beta[i - neg - 1]
        good = good & ((b1 - b2).abs() > mean_abs[:, None])
        oneside = oneside + torch.sign(b1 - b2)
    border = good & (oneside.abs() == BORDER_MIN_COUNT)
    for neg in range(BORDER_MIN_COUNT):
        border = border | torch.roll(border, -neg, 1)
    border = border & valid
    return Track(points=points, beta=beta, border=border, valid=valid,
                 n_points=n, offset=offset)


def nearest_tile(track: Track, qx: torch.Tensor, qy: torch.Tensor):
    """Nearest valid centerline point of query points (N, Q) → (index
    (N, Q) int64, distance (N, Q)), the first index on a tie
    (JAX track.py:107-133)."""
    px, py = track.points[..., 0], track.points[..., 1]
    q2 = qx * qx + qy * qy
    p2 = px * px + py * py
    qp = qx[..., None] * px[:, None]
    qp.add_(qy[..., None] * py[:, None]).mul_(2.0)
    d2 = q2[..., None] + p2[:, None]
    d2.sub_(qp).masked_fill_(~track.valid[:, None], float('inf'))
    d2min, idx = d2.min(-1)         # the first index of the least
    return idx, sqrt(d2min.clamp(min=0.0))


def on_road(track: Track, qx, qy):
    """(road (N, Q) bool, tile index (N, Q)) of query points."""
    idx, dist = nearest_tile(track, qx, qy)
    return dist <= TRACK_WIDTH, idx


def _color(mask, rgb, img):
    c = torch.tensor(np.asarray(rgb, np.float32), device=img.device)
    return torch.where(mask[..., None], c, img)


def render_rows(track: Track, car, t: torch.Tensor, rows: range
                ) -> torch.Tensor:
    """Rows ``rows`` of the (N, 96, 96, 3) float image before the uint8
    cast (JAX track.py:148-236)."""
    dev = t.device
    zoom = (f32(0.1 * SCALE) * (1.0 - t).clamp(min=0.0)
            + f32(ZOOM * SCALE) * t.clamp(max=1.0))
    sx = (zoom * float(STATE_W)) * recip(WINDOW_W)
    sy = (zoom * float(STATE_H)) * recip(WINDOW_H)
    py_, px_ = torch.meshgrid(
        torch.tensor(list(rows), dtype=torch.float32, device=dev),
        torch.arange(STATE_W, dtype=torch.float32, device=dev),
        indexing='ij')
    R, W = py_.shape
    ex = (px_ - STATE_W / 2)[None] / sx[:, None, None]
    ey = ((STATE_H - 1 - py_) - STATE_H / 4)[None] / sy[:, None, None]
    ca, sa = cos(car.angle), sin(car.angle)
    c = lambda v: v[:, None, None]
    wx = (c(car.pos[:, 0]) + ex * c(ca)) + ey * c(-sa)
    wy = (c(car.pos[:, 1]) + ex * c(sa)) + ey * c(ca)
    N = t.shape[0]
    idx, dist = nearest_tile(track, wx.reshape(N, -1), wy.reshape(N, -1))
    idx, dist = idx.reshape(N, R, W), dist.reshape(N, R, W)
    is_road = dist <= TRACK_WIDTH
    shade = 0.01 * (idx % 3).float()
    road_rgb = torch.tensor(ROAD_COLOR, device=dev) + shade[..., None]

    g = lambda x, i: torch.gather(x, 1, i.reshape(N, -1)).reshape(N, R, W)
    beta_i = g(track.beta, idx)
    beta_prev = g(track.beta, (idx - 1) % track.capacity)
    side = torch.sign(beta_prev - beta_i)
    p_x, p_y = g(track.points[..., 0], idx), g(track.points[..., 1], idx)
    lat = (wx - p_x) * cos(beta_i) + (wy - p_y) * sin(beta_i)
    in_border = (g(track.border, idx) & (dist > TRACK_WIDTH)
                 & (dist <= TRACK_WIDTH + BORDER)
                 & (torch.sign(lat) == side))
    white = (idx % 2) == 0
    border_rgb = torch.where(white[..., None],
                             torch.ones(3, device=dev),
                             torch.tensor([1.0, 0.0, 0.0], device=dev))
    checker = torch.remainder(torch.floor(wx * recip(20))
                              + torch.floor(wy * recip(20)), 2.0) == 0
    grass_rgb = torch.where(checker[..., None],
                            torch.tensor(GRASS_PATCH, device=dev),
                            torch.tensor(GRASS_BASE, device=dev))
    img = torch.where(is_road[..., None], road_rgb, grass_rgb)
    img = torch.where(in_border[..., None], border_rgb, img)

    lx, ly = ex, ey
    hull = (lx.abs() < 1.0) & (ly > -2.6) & (ly < 2.6)
    wheels = (((lx.abs() - 1.1).abs() < 0.30)
              & (((ly - 1.6).abs() < 0.55) | ((ly + 1.64).abs() < 0.55)))
    img = _color(hull, [0.8, 0.0, 0.0], img)
    img = _color(wheels, [0.0, 0.0, 0.0], img)

    row = py_[None]
    in_bar = (row >= (STATE_H - BAR_H)).expand(N, R, W)
    img = _color(in_bar, [0.0, 0.0, 0.0], img)
    vx, vy = car.vel[:, 0], car.vel[:, 1]
    speed = sqrt(vx * vx + vy * vy)
    pxb = px_[None]
    for x0, value, rgb, scale in (
            (5.0, speed, [1.0, 1.0, 1.0], 0.02),
            (10.0, car.wheel_omega[:, 0], [0.0, 0.0, 1.0], 0.01),
            (13.0, car.wheel_omega[:, 1], [0.0, 0.0, 1.0], 0.01),
            (16.0, car.wheel_omega[:, 2], [0.2, 0.0, 1.0], 0.01),
            (19.0, car.wheel_omega[:, 3], [0.2, 0.0, 1.0], 0.01),
            (24.0, car.steer_angle, [0.0, 1.0, 0.0], 2.0),
            (29.0, car.angvel, [1.0, 0.0, 0.0], 0.3)):
        h = (value.abs() * scale).clamp(0.0, 1.0) * float(BAR_H)
        on = (in_bar & (pxb >= x0) & (pxb < x0 + 2)
              & (row >= float(STATE_H) - c(h)))
        img = _color(on, rgb, img)
    return img


def render_frame(track: Track, car, t: torch.Tensor) -> torch.Tensor:
    """(N, 96, 96, 3) uint8 state-pixels frames of N cars (JAX
    track.py:148-241), computed 8 rows at a time so the (pixels × P)
    distances stay small."""
    parts = []
    for r0 in range(0, STATE_H, 8):
        img = render_rows(track, car, t, range(r0, min(r0 + 8, STATE_H)))
        parts.append((img.clamp(0.0, 1.0) * 255.0).to(torch.uint8))
    return torch.cat(parts, 1)
