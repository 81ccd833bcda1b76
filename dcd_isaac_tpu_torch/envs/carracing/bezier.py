"""Bézier tracks from control points, batched (port of
``dcd_isaac_tpu/envs/carracing/bezier.py``).

A level has up to 12 control points, of which its first n ∈ [3, 12]
count; the curve is n cubic segments of 40 samples each, padded to the
track's capacity of 480 points by repeating its last point (JAX
``adversarial.py:_bezier_track_padded``, whose ``lax.switch`` over the
counts becomes a per-level n here).  These are the plain twins of kernel
B13b (``kernels/carracing_track.py``): every sum runs in a fixed order
that the kernel repeats, and the constants are float32 values computed
once (:func:`consts`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_CP = 12
NUMPOINTS = 40
RAD = 0.2
EDGY = 0.2


def f32(v) -> float:
    """A constant as the float32 value JAX computes with."""
    return float(np.float32(v))


# The environment's sin, cos, atan2 and sqrt: computed in double and
# rounded once to float32, in the twins and the kernels alike.  float32
# libraries differ in the last ulp between the CPU and the card (sin,
# cos and atan2 on a fifth of inputs, torch's CPU sqrt on 1 %), and one
# such ulp can flip a pixel's class or a tyre's friction; rounded from
# double, the CPU, the card's twins and the kernels agree to the bit.
def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y.double(), x.double()).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


PI = f32(np.pi)
TWO_PI = f32(2 * np.pi)
# p = arctan(edgy) / pi + 0.5 and 1 - p, in float32 (bezier.py:41, :49)
P_EDGY = float(np.float32(np.arctan(np.float32(EDGY))) / np.float32(np.pi)
               + np.float32(0.5))
Q_EDGY = float(np.float32(1.0) - np.float32(P_EDGY))


@functools.lru_cache(maxsize=None)
def bernstein(device) -> torch.Tensor:
    """(40, 4) float32 cubic Bernstein weights at t = linspace(0, 1, 40):
    (1-t)^3, 3t(1-t)^2, 3t^2(1-t), t^3 (bezier.py:24-30)."""
    t = torch.tensor(np.linspace(0.0, 1.0, NUMPOINTS), dtype=torch.float32)
    u = 1.0 - t
    b = torch.stack([(u * u) * u, (3.0 * t) * (u * u), (3.0 * (t * t)) * u,
                     (t * t) * t], -1)
    return b.to(device)


def seq_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` from the first element to the last."""
    x = x.movedim(dim, -1)
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def ccw_sort(points: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Each level's first n points (N, 12, 2) sorted counter-clockwise
    around their mean by arctan2(dx, dy), x first as the reference does
    (bezier.py:14-21); stable; the unused points last."""
    j = torch.arange(points.shape[1], device=points.device)
    use = j[None] < n[:, None]
    z = torch.zeros_like(points[..., 0])
    nf = n.float()
    mx = seq_sum(torch.where(use, points[..., 0], z)) / nf
    my = seq_sum(torch.where(use, points[..., 1], z)) / nf
    s = atan2(points[..., 0] - mx[:, None], points[..., 1] - my[:, None])
    s = torch.where(use, s, torch.full_like(s, float('inf')))
    idx = torch.argsort(s, dim=1, stable=True)
    return torch.gather(points, 1, idx[..., None].expand_as(points))


def get_bezier_track(cps: torch.Tensor, n: torch.Tensor,
                     capacity: int = N_CP * NUMPOINTS):
    """(N, 12, 2) control points, (N,) counts → curve (N, capacity, 2) and
    its valid mask (N, capacity): n segments of 40 samples through the
    ccw-sorted points with smoothed tangent angles (bezier.py:33-64),
    padded with the last point."""
    N, dev = cps.shape[0], cps.device
    n = n.long().clamp(3, N_CP)
    a = ccw_sort(cps, n)
    j = torch.arange(N_CP, device=dev)[None]
    nxt = (j + 1) % n[:, None]
    prv = (j + n[:, None] - 1) % n[:, None]
    g = lambda x, idx: torch.gather(x, 1, idx)
    ax, ay = a[..., 0], a[..., 1]
    bx, by = g(ax, nxt), g(ay, nxt)
    dx, dy = bx - ax, by - ay
    ang = atan2(dy, dx)
    ang = torch.where(ang >= 0, ang, ang + TWO_PI)
    ang2 = g(ang, prv)
    ang = (P_EDGY * ang + Q_EDGY * ang2) + torch.where(
        (ang2 - ang).abs() > PI, torch.full_like(ang, PI),
        torch.zeros_like(ang))
    th2 = g(ang, nxt)
    r = RAD * sqrt(dx * dx + dy * dy)
    c1x, c1y = ax + r * cos(ang), ay + r * sin(ang)
    th2p = th2 + PI
    c2x, c2y = bx + r * cos(th2p), by + r * sin(th2p)
    b = bernstein(dev)                                     # (40, 4)
    seg = lambda p1, c1, c2, p2: (
        ((b[:, 0] * p1[..., None] + b[:, 1] * c1[..., None])
         + b[:, 2] * c2[..., None]) + b[:, 3] * p2[..., None])
    curve = torch.stack([seg(ax, c1x, c2x, bx), seg(ay, c1y, c2y, by)], -1)
    curve = curve.reshape(N, N_CP * NUMPOINTS, 2)          # (N, 480, 2)
    i = torch.arange(capacity, device=dev)[None]
    used = n[:, None] * NUMPOINTS
    valid = i < used
    last = torch.gather(curve, 1, (used - 1)[..., None].expand(N, 1, 2))
    curve = torch.where(valid[..., None], curve[:, :capacity],
                        last.expand(N, capacity, 2))
    return curve, valid


def trial_min_distance(pts: torch.Tensor) -> torch.Tensor:
    """(..., 12, 2) points → (...) least distance between consecutive
    points of their ccw order (bezier.py:76-80; the closing pair not
    counted)."""
    flat = pts.reshape(-1, N_CP, 2)
    n = torch.full((flat.shape[0],), N_CP, dtype=torch.long,
                   device=pts.device)
    s = ccw_sort(flat, n)
    d = s[:, 1:] - s[:, :-1]
    dist = sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    return dist.min(1).values.reshape(pts.shape[:-2])


def random_control_points(u: torch.Tensor, scale: float = 1.0,
                          mindst: float = None) -> torch.Tensor:
    """Rejection sampling of control points ≥ mindst apart from the
    uniforms ``u`` (N, tries, 12, 2): the first trial that passes, else the
    one whose least distance is largest (bezier.py:67-87), times
    ``scale``."""
    mindst = mindst or 0.7 / N_CP
    mins = trial_min_distance(u)                           # (N, tries)
    ok = mins >= f32(mindst)
    first = torch.argmax(ok.to(torch.uint8), 1)
    best = torch.argmax(mins, 1)
    idx = torch.where(ok.any(1), first, best)
    pts = u[torch.arange(u.shape[0], device=u.device), idx]
    return pts * f32(scale)
