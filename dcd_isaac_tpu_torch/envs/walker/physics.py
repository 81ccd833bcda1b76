"""2D rigid-body physics of the BipedalWalker, batched over N walkers.

Port of ``dcd_isaac_tpu/envs/walker/physics.py``: the hull and four leg
segments joined by four motorised revolute joints with limits, colliding
with a heightfield edge chain and axis-aligned boxes; one 1/50 s step is
contact generation, 40 velocity sweeps (the joints' motor, limit and
point-to-point impulses, then the contacts' normal and friction impulses
Jacobi with mass splitting) and the integration.  The constants and body
tables are computed in float64, as the JAX package's numpy does, and used
in float32.

``physics_step`` and ``lidar`` are the plain twin of kernel B10
(``kernels/walker_step.py``): every float operation is the JAX package's,
in its order — the two-term sums of rotations and dot products left to
right, the joints' scatter-adds joint by joint (body 0 takes joint 0's
impulse, then joint 2's), the contacts' per-body sums vertex by vertex —
each rounded on its own, and a division by a constant is a product with
its float32 reciprocal, as XLA compiles it.  The kernel rounds the same
operations in the same order, so it differs from the twin only where the
card's ``cosf``/``sinf`` do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --- constants (walker_env.py:33-57) --------------------------------------
FPS = 50
DT = 1.0 / FPS
SCALE = 30.0
MOTORS_TORQUE = 80.0
SPEED_HIP = 4.0
SPEED_KNEE = 6.0
LIDAR_RANGE = 160.0 / SCALE
INITIAL_RANDOM = 5.0
LEG_DOWN = -8.0 / SCALE
LEG_W, LEG_H = 8.0 / SCALE, 34.0 / SCALE
VIEWPORT_W, VIEWPORT_H = 600, 400
TERRAIN_STEP = 14.0 / SCALE
TERRAIN_LENGTH = 200
TERRAIN_HEIGHT = VIEWPORT_H / SCALE / 4
TERRAIN_GRASS = 10
TERRAIN_STARTPAD = 20
FRICTION = 2.5
GRAVITY = -10.0

HULL_POLY = np.array(
    [(-30, 9), (6, 9), (34, 1), (34, -8), (-30, -8)], np.float64) / SCALE

NUM_BODIES = 5          # 0 hull, 1 upper-L, 2 lower-L, 3 upper-R, 4 lower-R
VEL_ITERS = 40
POS_BAUMGARTE = 0.2
PEN_SLOP = 0.005
MAX_BOXES = 64          # static obstacle budget (stumps/stairs/pit walls)
NUM_RAYS = 10


def _polygon_mass(verts, density):
    """Box2D b2PolygonShape::ComputeMass (area, centroid, inertia)."""
    signed = 0.0
    for i in range(len(verts)):
        p1, p2 = verts[i], verts[(i + 1) % len(verts)]
        signed += p1[0] * p2[1] - p2[0] * p1[1]
    if signed < 0:
        verts = verts[::-1]
    area = 0.0
    c = np.zeros(2)
    inertia = 0.0
    ref = verts[0]
    for i in range(len(verts)):
        p1 = verts[i] - ref
        p2 = verts[(i + 1) % len(verts)] - ref
        cross = p1[0] * p2[1] - p1[1] * p2[0]
        tri_area = 0.5 * cross
        area += tri_area
        c += tri_area / 3.0 * (p1 + p2)
        intx2 = p1[0] ** 2 + p1[0] * p2[0] + p2[0] ** 2
        inty2 = p1[1] ** 2 + p1[1] * p2[1] + p2[1] ** 2
        inertia += (0.25 / 3.0) * cross * (intx2 + inty2)
    c /= area
    mass = density * area
    inertia = density * inertia - mass * (c @ c)
    c += ref
    return mass, c, inertia


def _box_verts(hw, hh):
    return np.array([(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)], np.float64)


_LEG_V = _box_verts(LEG_W / 2, LEG_H / 2)
_LOWER_V = _box_verts(0.8 * LEG_W / 2, LEG_H / 2)


def _pad5(v):
    out = np.zeros((5, 2))
    out[:len(v)] = v
    out[len(v):] = v[-1]
    return out


BODY_VERTS = np.stack([
    _pad5(HULL_POLY), _pad5(_LEG_V), _pad5(_LOWER_V),
    _pad5(_LEG_V), _pad5(_LOWER_V)])              # (5, 5, 2)
BODY_NVERTS = np.array([5, 4, 4, 4, 4])
_hm, _hc, _hI = _polygon_mass(HULL_POLY, 5.0)
_lm, _lc, _lI = _polygon_mass(_LEG_V, 1.0)
_wm, _wc, _wI = _polygon_mass(_LOWER_V, 1.0)
# the hull's origin is its centroid; its vertices are shifted to match
HULL_CENTROID = _hc
BODY_VERTS[0] -= _hc
BODY_MASS = np.array([_hm, _lm, _wm, _lm, _wm])
BODY_I = np.array([_hI, _lI, _wI, _lI, _wI])
INV_M = 1.0 / BODY_MASS
INV_I = 1.0 / BODY_I
# friction per body mixed with the terrain's 2.5 as sqrt(f1 * f2)
BODY_FRICTION = np.array([0.1, 0.2, 0.2, 0.2, 0.2])
CONTACT_FRICTION = np.sqrt(BODY_FRICTION * FRICTION)

# Revolute joints: (bodyA, bodyB), local anchors (centroid frame), limits.
JOINT_A = (0, 1, 0, 3)
JOINT_B = (1, 2, 3, 4)
JOINT_ANCHOR_A = np.array([
    [0.0, LEG_DOWN], [0.0, -LEG_H / 2],
    [0.0, LEG_DOWN], [0.0, -LEG_H / 2]])
JOINT_ANCHOR_A[0] -= HULL_CENTROID
JOINT_ANCHOR_A[2] -= HULL_CENTROID
JOINT_ANCHOR_B = np.array([
    [0.0, LEG_H / 2], [0.0, LEG_H / 2],
    [0.0, LEG_H / 2], [0.0, LEG_H / 2]])
JOINT_LOWER = np.array([-0.8, -1.6, -0.8, -1.6])
JOINT_UPPER = np.array([1.1, -0.1, 1.1, -0.1])
JOINT_REF = np.array([-0.05, 0.0, 0.05, 0.0])
JOINT_SPEED = np.array([SPEED_HIP, SPEED_KNEE, SPEED_HIP, SPEED_KNEE])

# (N, 25) candidate c = 5 * body + vertex
BODY_IDX = np.repeat(np.arange(NUM_BODIES), 5)
VERT_VALID = (np.arange(5)[None, :] < BODY_NVERTS[:, None]).reshape(-1)
BOX_NORMALS = np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]])


def recip(c: float) -> float:
    """The float32 reciprocal of a constant divisor: XLA compiles x / c as
    x * (1 / c), and the port divides by constants the same way."""
    return float(np.float32(1.0) / np.float32(c))


def f32(a, device=None) -> torch.Tensor:
    """A float64 numpy constant as a float32 tensor (JAX's canonical
    float32 of the same table)."""
    return torch.tensor(np.asarray(a, np.float64), dtype=torch.float32,
                        device=device)


@dataclasses.dataclass(frozen=True)
class Bodies:
    pos: torch.Tensor     # (N, 5, 2) centroid positions
    angle: torch.Tensor   # (N, 5)
    vel: torch.Tensor     # (N, 5, 2)
    angvel: torch.Tensor  # (N, 5)


@dataclasses.dataclass(frozen=True)
class Terrain:
    xs: torch.Tensor        # (N, TERRAIN_LENGTH) heightfield x
    ys: torch.Tensor        # (N, TERRAIN_LENGTH) heightfield y
    boxes: torch.Tensor     # (N, MAX_BOXES, 4) x0, y0, x1, y1
    n_boxes: torch.Tensor   # (N,) int32


def rot(angle: torch.Tensor):
    """(cos, sin) of each angle: the rotation [[c, -s], [s, c]]."""
    return torch.cos(angle), torch.sin(angle)


def rotate(c, s, vx, vy):
    """R @ v, each row a two-term sum left to right."""
    return c * vx + (-s) * vy, s * vx + c * vy


def world_vertices(bodies: Bodies) -> torch.Tensor:
    """(N, 5, 5, 2) world-space vertices of every body."""
    c, s = rot(bodies.angle)
    bv = f32(BODY_VERTS, bodies.pos.device)
    wx, wy = rotate(c[..., None], s[..., None], bv[..., 0], bv[..., 1])
    return torch.stack([bodies.pos[..., 0:1] + wx,
                        bodies.pos[..., 1:2] + wy], -1)


def ground_height(terrain: Terrain, x: torch.Tensor):
    """Heightfield lookup of x (N, K) → (y (N, K), normal (N, K, 2))."""
    idx = (torch.searchsorted(terrain.xs, x.contiguous(), right=True) - 1
           ).clamp(0, TERRAIN_LENGTH - 2)
    x0 = terrain.xs.gather(1, idx)
    x1 = terrain.xs.gather(1, idx + 1)
    y0 = terrain.ys.gather(1, idx)
    y1 = terrain.ys.gather(1, idx + 1)
    t = ((x - x0) / torch.clamp(x1 - x0, min=1e-8)).clamp(0.0, 1.0)
    y = y0 + t * (y1 - y0)
    nx, ny = -(y1 - y0), x1 - x0
    norm = torch.clamp(torch.sqrt(nx * nx + ny * ny), min=1e-8)
    return y, torch.stack([nx / norm, ny / norm], -1)


def contact_candidates(bodies: Bodies, terrain: Terrain):
    """Vertex-vs-terrain contacts of the 25 candidate vertices:
    (points (N, 25, 2), normals (N, 25, 2), penetration (N, 25), on_box
    (N, 25) bool: the contact is with a box, not the heightfield)."""
    dev = bodies.pos.device
    n = bodies.pos.shape[0]
    pts = world_vertices(bodies).reshape(n, 25, 2)
    valid = torch.tensor(VERT_VALID, device=dev)
    px, py = pts[..., 0], pts[..., 1]

    gy, gn = ground_height(terrain, px)
    pen_h = torch.where(valid, (gy - py) * gn[..., 1],
                        torch.full_like(gy, -1.0))

    b = terrain.boxes[:, None, :, :]                       # (N, 1, M, 4)
    box_valid = (torch.arange(MAX_BOXES, device=dev)[None, :]
                 < terrain.n_boxes[:, None])                # (N, M)
    dx0 = px[..., None] - b[..., 0]
    dx1 = b[..., 2] - px[..., None]
    dy0 = py[..., None] - b[..., 1]
    dy1 = b[..., 3] - py[..., None]
    inside = ((dx0 > 0) & (dx1 > 0) & (dy0 > 0) & (dy1 > 0)
              & box_valid[:, None, :] & valid[None, :, None])
    depths = torch.stack([dx0, dx1, dy0, dy1], -1)          # (N, 25, M, 4)
    dmin, min_axis = depths.min(-1)
    pen_b = torch.where(inside, dmin, torch.full_like(dmin, -1.0))
    pen_box, best_box = pen_b.max(-1)
    axis = min_axis.gather(2, best_box[..., None])[..., 0]
    n_box = f32(BOX_NORMALS, dev)[axis]                     # (N, 25, 2)

    use_box = pen_box > pen_h
    pen = torch.where(use_box, pen_box, pen_h)
    normal = torch.where(use_box[..., None], n_box, gn)
    return pts, normal, pen, use_box


def _per_body(x: torch.Tensor) -> torch.Tensor:
    """(N, 25, ...) → (N, 5, ...) sums over each body's 5 vertices, vertex
    by vertex (JAX's segment_sum order)."""
    x = x.reshape(x.shape[0], NUM_BODIES, 5, *x.shape[2:])
    s = x[:, :, 0]
    for v in range(1, 5):
        s = s + x[:, :, v]
    return s


def _add_at(x: torch.Tensor, bodies, upd: torch.Tensor) -> torch.Tensor:
    """x[:, bodies[j]] += upd[:, j] for j in order (JAX's scatter-add of a
    joint index with body 0 twice): the first joint of each body at once,
    then the repeats one by one."""
    first, rest = _SCATTER[tuple(bodies)]
    x = x.clone()
    x[:, [bodies[j] for j in first]] += upd[:, first]
    for j in rest:
        x[:, bodies[j]] += upd[:, j]
    return x


def _scatter_order(bodies):
    seen, first, rest = set(), [], []
    for j, b in enumerate(bodies):
        (rest if b in seen else first).append(j)
        seen.add(b)
    return first, rest


_SCATTER = {tuple(JOINT_A): _scatter_order(JOINT_A),
            tuple(JOINT_B): _scatter_order(JOINT_B)}


def _cross_sv(w, vx, vy):
    """w × v = (-w v_y, w v_x)."""
    return (-w) * vy, w * vx


def physics_step(bodies: Bodies, terrain: Terrain, motor_speed: torch.Tensor,
                 motor_torque: torch.Tensor):
    """One 1/50 s step of N walkers → (bodies, lower_contact (N, 2) bool,
    joint_angle (N, 4), joint_speed (N, 4), hull_contact (N,) bool).

    ``motor_speed`` and ``motor_torque`` are per joint (N, 4).
    """
    dev = bodies.pos.device
    inv_m_t = f32(INV_M, dev)
    inv_i_t = f32(INV_I, dev)
    bi = torch.tensor(BODY_IDX, device=dev)
    ja, jb = list(JOINT_A), list(JOINT_B)
    inv_m_c, inv_i_c = inv_m_t[bi], inv_i_t[bi]             # (25,)

    # --- contact generation (once per step) ------------------------------
    pts, normal, pen, _ = contact_candidates(bodies, terrain)
    active = pen > 0.0
    mu = f32(CONTACT_FRICTION, dev)[bi]
    n_per_body = _per_body(active.float())
    split = torch.clamp(n_per_body[:, bi], min=1.0)
    rx = pts[..., 0] - bodies.pos[:, bi, 0]
    ry = pts[..., 1] - bodies.pos[:, bi, 1]
    nx, ny = normal[..., 0], normal[..., 1]
    rxn = rx * ny - ry * nx
    k_n = (inv_m_c + inv_i_c * (rxn * rxn)) * split
    tx, ty = -ny, nx
    rxt = rx * ty - ry * tx
    k_t = (inv_m_c + inv_i_c * (rxt * rxt)) * split
    bias = torch.clamp(POS_BAUMGARTE / DT
                       * torch.clamp(pen - PEN_SLOP, min=0.0), max=2.0)

    # --- joint precomputation --------------------------------------------
    anc_a, anc_b = f32(JOINT_ANCHOR_A, dev), f32(JOINT_ANCHOR_B, dev)
    ca, sa = rot(bodies.angle[:, ja])
    cb, sb = rot(bodies.angle[:, jb])
    rax, ray = rotate(ca, sa, anc_a[:, 0], anc_a[:, 1])
    rbx, rby = rotate(cb, sb, anc_b[:, 0], anc_b[:, 1])
    lower, upper = f32(JOINT_LOWER, dev), f32(JOINT_UPPER, dev)
    joint_angle = (bodies.angle[:, jb] - bodies.angle[:, ja]
                   - f32(JOINT_REF, dev))
    inv_i_a, inv_i_b = inv_i_t[ja], inv_i_t[jb]
    inv_m_a, inv_m_b = inv_m_t[ja], inv_m_t[jb]
    # the reciprocal of the constant divisor max(inv_i_a + inv_i_b, 1e-9)
    inv_i_rsum = 1.0 / torch.clamp(inv_i_a + inv_i_b, min=1e-9)
    at_lower = joint_angle <= lower
    at_upper = joint_angle >= upper
    zero4 = torch.zeros_like(joint_angle)
    limit_bias = (POS_BAUMGARTE / DT) * (
        torch.where(at_lower, joint_angle - lower, zero4)
        + torch.where(at_upper, joint_angle - upper, zero4))
    max_imp = motor_torque * DT
    ma = inv_m_a + inv_m_b
    k11 = ma + inv_i_a * (ray * ray) + inv_i_b * (rby * rby)
    k12 = (-inv_i_a) * rax * ray - inv_i_b * rbx * rby
    k22 = ma + inv_i_a * (rax * rax) + inv_i_b * (rbx * rbx)
    det = torch.clamp(k11 * k22 - k12 * k12, min=1e-9)
    k_n = torch.clamp(k_n, min=1e-9)
    k_t = torch.clamp(k_t, min=1e-9)

    gravity = torch.tensor([0.0, GRAVITY], device=dev) * DT
    vel = bodies.vel + gravity
    angvel = bodies.angvel
    acc_n = torch.zeros_like(pen)
    acc_t = torch.zeros_like(pen)
    acc_m = torch.zeros_like(joint_angle)
    zero25 = torch.zeros_like(pen)

    for _ in range(VEL_ITERS):
        # -- joints: motor, limit, point-to-point ------------------------
        w_rel = angvel[:, jb] - angvel[:, ja]
        m_imp = -(w_rel - motor_speed) * inv_i_rsum
        new_acc = torch.minimum(torch.maximum(acc_m + m_imp, -max_imp),
                                max_imp)
        m_imp = new_acc - acc_m
        acc_m = new_acc
        angvel = _add_at(angvel, ja, (-inv_i_a) * m_imp)
        angvel = _add_at(angvel, jb, inv_i_b * m_imp)

        w_rel = angvel[:, jb] - angvel[:, ja]
        l_imp = -(w_rel + limit_bias) * inv_i_rsum
        l_imp = torch.where(at_lower, torch.clamp(l_imp, min=0.0),
                            torch.where(at_upper, torch.clamp(l_imp, max=0.0),
                                        zero4))
        angvel = _add_at(angvel, ja, (-inv_i_a) * l_imp)
        angvel = _add_at(angvel, jb, inv_i_b * l_imp)

        wa, wb = angvel[:, ja], angvel[:, jb]
        cax, cay = _cross_sv(wa, rax, ray)
        cbx, cby = _cross_sv(wb, rbx, rby)
        cdx = (vel[:, jb, 0] + cbx) - (vel[:, ja, 0] + cax)
        cdy = (vel[:, jb, 1] + cby) - (vel[:, ja, 1] + cay)
        px = -(k22 * cdx - k12 * cdy) / det
        py = -(k11 * cdy - k12 * cdx) / det
        P = torch.stack([px, py], -1)
        vel = _add_at(vel, ja, (-inv_m_a)[:, None] * P)
        vel = _add_at(vel, jb, inv_m_b[:, None] * P)
        angvel = _add_at(angvel, ja, (-inv_i_a) * (rax * py - ray * px))
        angvel = _add_at(angvel, jb, inv_i_b * (rbx * py - rby * px))

        # -- contacts (Jacobi over all points) ---------------------------
        w = angvel[:, bi]
        cx, cy = _cross_sv(w, rx, ry)
        vn = (vel[:, bi, 0] + cx) * nx + (vel[:, bi, 1] + cy) * ny
        lam = -(vn - bias) / k_n
        new_acc_n = torch.clamp(acc_n + torch.where(active, lam, zero25),
                                min=0.0)
        lam = new_acc_n - acc_n
        acc_n = new_acc_n
        ix, iy = lam * nx, lam * ny
        dvel = _per_body(torch.stack([ix * inv_m_c, iy * inv_m_c], -1))
        dang = _per_body((rx * iy - ry * ix) * inv_i_c)
        vel = vel + dvel
        angvel = angvel + dang

        w = angvel[:, bi]
        cx, cy = _cross_sv(w, rx, ry)
        vt = (vel[:, bi, 0] + cx) * tx + (vel[:, bi, 1] + cy) * ty
        lam_t = -vt / k_t
        max_f = mu * acc_n
        new_acc_t = torch.minimum(
            torch.maximum(acc_t + torch.where(active, lam_t, zero25),
                          -max_f), max_f)
        lam_t = new_acc_t - acc_t
        acc_t = new_acc_t
        ix, iy = lam_t * tx, lam_t * ty
        vel = vel + _per_body(torch.stack([ix * inv_m_c, iy * inv_m_c], -1))
        angvel = angvel + _per_body((rx * iy - ry * ix) * inv_i_c)

    pos = bodies.pos + vel * DT
    angle = bodies.angle + angvel * DT
    touching = (active & (acc_n > 0)).reshape(-1, NUM_BODIES, 5).any(-1)
    lower_contact = touching[:, [2, 4]]
    joint_angle = angle[:, jb] - angle[:, ja] - f32(JOINT_REF, dev)
    joint_speed = angvel[:, jb] - angvel[:, ja]
    return (Bodies(pos=pos, angle=angle, vel=vel, angvel=angvel),
            lower_contact, joint_angle, joint_speed, touching[:, 0])


def lidar_dirs(device=None) -> torch.Tensor:
    """(10, 2) ray offsets (sin(1.5 i / 10), -cos(1.5 i / 10)) * range."""
    i = torch.arange(NUM_RAYS, dtype=torch.float32, device=device)
    a = 1.5 * i / 10.0
    return torch.stack([torch.sin(a), -torch.cos(a)], -1) * LIDAR_RANGE


def _guard(x):
    return torch.where(x.abs() < 1e-9, torch.full_like(x, 1e-9), x)


def lidar(bodies: Bodies, terrain: Terrain) -> torch.Tensor:
    """(N, 10) lidar fractions from the hull's centroid
    (walker_env.py:534-541): each ray against the 199 heightfield segments
    and the valid boxes' slabs."""
    dev = bodies.pos.device
    p0 = bodies.pos[:, 0]                                   # (N, 2)
    p1 = p0[:, None, :] + lidar_dirs(dev)                   # (N, 10, 2)
    d = p1 - p0[:, None, :]
    d0, d1 = d[..., 0:1], d[..., 1:2]                       # (N, 10, 1)
    p0x, p0y = p0[:, None, 0:1], p0[:, None, 1:2]
    ax = terrain.xs[:, None, :-1]
    ay = terrain.ys[:, None, :-1]
    ex = terrain.xs[:, None, 1:] - ax
    ey = terrain.ys[:, None, 1:] - ay
    denom = d0 * ey - d1 * ex
    t = ((ax - p0x) * ey - (ay - p0y) * ex) / _guard(denom)
    s = torch.where(ex.abs() > ey.abs(),
                    (p0x + t * d0 - ax) / _guard(ex),
                    (p0y + t * d1 - ay) / _guard(ey))
    hit = (t >= 0) & (t <= 1) & (s >= 0) & (s <= 1)
    frac_h = torch.where(hit, t, torch.ones_like(t)).amin(-1)

    b = terrain.boxes[:, None, :, :]                        # (N, 1, M, 4)
    valid = (torch.arange(MAX_BOXES, device=dev)[None, :]
             < terrain.n_boxes[:, None])[:, None, :]
    inv0 = 1.0 / _guard(d0)
    inv1 = 1.0 / _guard(d1)
    t0x = (b[..., 0] - p0x) * inv0
    t1x = (b[..., 2] - p0x) * inv0
    t0y = (b[..., 1] - p0y) * inv1
    t1y = (b[..., 3] - p0y) * inv1
    tmin = torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y))
    tmax = torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y))
    hit_b = (tmax >= tmin) & (tmax >= 0) & (tmin <= 1) & valid
    frac_b = torch.where(hit_b, tmin.clamp(min=0.0),
                         torch.ones_like(tmin)).amin(-1)
    return torch.minimum(frac_h, frac_b)
