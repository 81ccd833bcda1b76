"""Track polygon complexity metrics (host-side numpy); a copy of
dcd_isaac_tpu/utils/geo_complexity.py, which the port may not import.

Re-derivation of reference util/geo_complexity.py:56-138 (itself after
Brinkhoff et al., "Measuring the Complexity of Polygonal Objects") without
the shapely/geopandas dependency:

  amplitude  = (perimeter − hull_perimeter) / (perimeter + 1e-3)
  convex     = (hull_area − area) / (hull_area + 1e-3)
  notches    = #edges whose direction angle ∈ (π, 2π), / (n_vertices − 2)
  complexity = 0.8·amplitude·notches + 0.2·convex

The notches rule reproduces the reference implementation EXACTLY, including
its quirk of classifying by absolute edge direction (downward-pointing
edges) rather than reflex interior angles — parity with logged reference
stats matters more than geometric orthodoxy here
(geo_complexity.py:21-52).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _perimeter(pts: np.ndarray) -> float:
    d = np.diff(np.vstack([pts, pts[:1]]), axis=0)
    return float(np.hypot(d[:, 0], d[:, 1]).sum())


def _area(pts: np.ndarray) -> float:
    x, y = pts[:, 0], pts[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
                 / 2.0)


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Monotone chain; returns hull vertices in CCW order."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(points):
        chain = []
        for p in points:
            while len(chain) >= 2:
                o, a = chain[-2], chain[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) \
                        - (a[1] - o[1]) * (p[0] - o[0]) <= 0:
                    chain.pop()
                else:
                    break
            chain.append(p)
        return chain

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _notches(pts: np.ndarray) -> float:
    """Reference get_notches: count edges with direction angle > π,
    normalized by len(ring_coords) − 3 = n_vertices − 2."""
    nxt = np.roll(pts, -1, axis=0)
    ang = np.arctan2(nxt[:, 1] - pts[:, 1], nxt[:, 0] - pts[:, 0])
    ang = np.where(ang < 0, ang + 2 * np.pi, ang)
    notches = int((ang > np.pi).sum())
    if notches == 0:
        return 0.0
    return notches / max(len(pts) - 2, 1)


def complexity(points, coeff_ampl: float = 0.8,
               coeff_conv: float = 0.2) -> Dict[str, float]:
    """Polygon complexity stats for a track centerline.

    ``points``: iterable of (x, y); the closing duplicate is optional.
    Returns the reference's dict: area, perimeter, amplitude, convex,
    notches, complexity.
    """
    pts = np.asarray(list(points), np.float64)
    if len(pts) >= 2 and np.allclose(pts[0], pts[-1]):
        pts = pts[:-1]
    if len(pts) < 3:
        return {'area': 0.0, 'perimeter': 0.0, 'amplitude': 0.0,
                'convex': 0.0, 'notches': 0.0, 'complexity': 0.0}

    perim = _perimeter(pts)
    area = _area(pts)
    hull = _convex_hull(pts)
    hull_perim = _perimeter(hull)
    hull_area = _area(hull)

    amplitude = (perim - hull_perim) / (perim + 1e-3)
    convex = (hull_area - area) / (hull_area + 1e-3)
    notches = _notches(pts)
    return {
        'area': area,
        'perimeter': perim,
        'amplitude': amplitude,
        'convex': convex,
        'notches': notches,
        'complexity': coeff_ampl * amplitude * notches + coeff_conv * convex,
    }


def batch_track_complexity(points: np.ndarray,
                           valid: np.ndarray) -> Dict[str, float]:
    """Mean complexity stats over a batch of padded tracks.

    ``points``: (N, P, 2); ``valid``: (N, P) padding mask.  Matches the
    reference's per-env mean aggregation
    (adversarial_runner.py:314-327, 'track_' prefix added by the caller).
    """
    sums: Dict[str, float] = {}
    n = len(points)
    for i in range(n):
        info = complexity(points[i][valid[i]])
        for k, v in info.items():
            sums[k] = sums.get(k, 0.0) + v
    return {k: v / max(n, 1) for k, v in sums.items()}
