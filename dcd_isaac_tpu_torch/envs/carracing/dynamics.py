"""Top-down car dynamics, batched (port of
``dcd_isaac_tpu/envs/carracing/dynamics.py``).

One rigid body with kinematic wheels: wheel speeds and the steering angle
are state, friction-circle tyre forces act at the four wheel anchors.
``CAR_MASS`` and ``CAR_I`` are computed in numpy from the hull polygons
and the wheels, as in the JAX package.  ``car_step`` is the plain twin of
one substep of kernel B13a (``kernels/carracing_step.py``): each float
operation in the JAX package's order, a division by a constant as a
product with its float32 reciprocal, the sums over the wheels from the
first to the last.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bezier import cos, f32, seq_sum, sin, sqrt
from .track import recip

# gym car_dynamics constants
SIZE = 0.02
ENGINE_POWER = 1e8 * SIZE ** 2
WHEEL_MOMENT = 4000 * SIZE ** 2
FRICTION_LIMIT = 1e6 * SIZE ** 2
WHEEL_R = 27 * SIZE
WHEELPOS = np.array(
    [(-55, 80), (55, 80), (-55, -82), (55, -82)], np.float64) * SIZE
HULL_POLYS = [
    np.array([(-60, 130), (60, 130), (60, 110), (-60, 110)]) * SIZE,
    np.array([(-15, 120), (15, 120), (20, 20), (-20, 20)]) * SIZE,
    np.array([(25, 20), (50, -10), (50, -40), (20, -90), (-20, -90),
              (-50, -40), (-50, -10), (-25, 20)]) * SIZE,
    np.array([(-50, -120), (50, -120), (50, -90), (-50, -90)]) * SIZE,
]
FORCE_COEF = 205000 * SIZE ** 2
STEER_LIMIT = 0.42
DT = 1.0 / 50.0


def _poly_mass(verts, density):
    """Box2D polygon mass, centroid and inertia for either winding
    (JAX dynamics.py:40-65)."""
    signed = 0.0
    for i in range(len(verts)):
        p1, p2 = verts[i], verts[(i + 1) % len(verts)]
        signed += p1[0] * p2[1] - p2[0] * p1[1]
    if signed < 0:
        verts = verts[::-1]
    ref = verts[0]
    area = 0.0
    c = np.zeros(2)
    I = 0.0
    for i in range(len(verts)):
        p1 = verts[i] - ref
        p2 = verts[(i + 1) % len(verts)] - ref
        cross = p1[0] * p2[1] - p1[1] * p2[0]
        tri = 0.5 * cross
        area += tri
        c += tri / 3.0 * (p1 + p2)
        I += (0.25 / 3.0) * cross * (p1 @ p1 + p1 @ p2 + p2 @ p2)
    c /= max(area, 1e-12)
    m = density * area
    I = density * I - m * (c @ c)
    c = c + ref
    return m, c, I + 0.0


def _aggregate():
    m_tot, i_tot = 0.0, 0.0
    for v in HULL_POLYS:
        m, c, i = _poly_mass(v, 1.0)
        m_tot += m
        i_tot += i + m * (c @ c)
    box = np.array([(-14, -27), (14, -27), (14, 27), (-14, 27)]) * SIZE
    wm, _, wi = _poly_mass(box, 0.1)
    for p in WHEELPOS:
        m_tot += wm
        i_tot += wi + wm * (p @ p)
    return float(m_tot), float(i_tot)


CAR_MASS, CAR_I = _aggregate()

# The float32 constants of a substep, as the JAX package's expressions
# round them (python products first, then the float32 constant).
C_GAS = f32(DT * ENGINE_POWER)          # DT * ENGINE_POWER * wheel_gas
R_MOMENT = recip(WHEEL_MOMENT)
R_MASS = recip(CAR_MASS)
R_INERTIA = recip(CAR_I)
WHEEL_X = [f32(v) for v in WHEELPOS[:, 0]]
WHEEL_Y = [f32(v) for v in WHEELPOS[:, 1]]
FRONT = [1.0, 1.0, 0.0, 0.0]
REAR = [0.0, 0.0, 1.0, 1.0]


@dataclasses.dataclass(frozen=True)
class CarState:
    pos: torch.Tensor           # (N, 2)
    angle: torch.Tensor         # (N,)
    vel: torch.Tensor           # (N, 2)
    angvel: torch.Tensor        # (N,)
    wheel_omega: torch.Tensor   # (N, 4)
    steer_angle: torch.Tensor   # (N,) front-wheel joint angle
    gas: torch.Tensor           # (N,) smoothed rear-wheel gas
    fuel_spent: torch.Tensor    # (N,)

    def replace(self, **kw) -> 'CarState':
        return dataclasses.replace(self, **kw)


def init_car(angle: torch.Tensor, x: torch.Tensor, y: torch.Tensor
             ) -> CarState:
    """N cars at rest at (x, y) facing ``angle`` (JAX dynamics.py:96)."""
    z = torch.zeros_like(angle)
    return CarState(pos=torch.stack([x, y], -1).float(),
                    angle=angle.float(), vel=torch.zeros_like(
                        torch.stack([x, y], -1)),
                    angvel=z, wheel_omega=torch.zeros(
                        (angle.shape[0], 4), device=angle.device),
                    steer_angle=z, gas=z, fuel_spent=z)


def _wheel_offsets(angle: torch.Tensor):
    """The anchors rotated: WHEELPOS @ R.T → ((N, 4), (N, 4))."""
    ca, sa = cos(angle)[:, None], sin(angle)[:, None]
    wx = torch.tensor(WHEEL_X, device=angle.device)
    wy = torch.tensor(WHEEL_Y, device=angle.device)
    return wx * ca + wy * (-sa), wx * sa + wy * ca


def wheel_positions(car: CarState):
    """World positions of the 4 wheels → (x (N, 4), y (N, 4))."""
    ox, oy = _wheel_offsets(car.angle)
    return car.pos[:, :1] + ox, car.pos[:, 1:] + oy


def car_step(car: CarState, steer_cmd, gas_cmd, brake_cmd,
             wheel_on_road: torch.Tensor) -> CarState:
    """One 1/50 s step of N cars (JAX dynamics.py:109-177): steer ∈
    [-1, 1] (target joint angle), gas ∈ [0, 1] (ramped by ≤ 0.1 a call),
    brake ∈ [0, 1]; ``wheel_on_road`` (N, 4) picks road or grass
    friction."""
    dev = car.angle.device
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    gas_cmd = gas_cmd.clamp(0.0, 1.0)
    gas = car.gas + (gas_cmd - car.gas).clamp(max=0.1)
    err = steer_cmd - car.steer_angle
    rate = torch.sign(err) * torch.minimum(50.0 * err.abs(), t(3.0))
    steer_angle = (car.steer_angle + DT * rate).clamp(-STEER_LIMIT,
                                                      STEER_LIMIT)

    ox, oy = _wheel_offsets(car.angle)
    px, py = car.pos[:, :1], car.pos[:, 1:]
    rx, ry = (px + ox) - px, (py + oy) - py
    wang = car.angle[:, None] + t(FRONT) * steer_angle[:, None]
    fx, fy = -sin(wang), cos(wang)
    sx, sy = cos(wang), sin(wang)
    w = car.angvel[:, None]
    vx = car.vel[:, :1] + w * (-ry)
    vy = car.vel[:, 1:] + w * rx
    vf = fx * vx + fy * vy
    vs = sx * vx + sy * vy

    omega = car.wheel_omega
    wheel_gas = t(REAR) * gas[:, None]
    omega = omega + ((C_GAS * wheel_gas) * R_MOMENT) / (omega.abs() + 5.0)
    fuel = car.fuel_spent + C_GAS * seq_sum(wheel_gas)

    brake = brake_cmd.clamp(0.0, 1.0)[:, None]
    hard = brake >= 0.9
    brake_delta = torch.minimum(15.0 * brake, omega.abs())
    omega = torch.where(hard, torch.zeros_like(omega),
                        omega - torch.sign(omega) * brake_delta)

    vr = omega * WHEEL_R
    f_force = (-vf + vr) * FORCE_COEF
    p_force = -vs * FORCE_COEF
    force = sqrt(f_force * f_force + p_force * p_force)
    limit = FRICTION_LIMIT * torch.where(wheel_on_road, t(1.0), t(0.6))
    over = force > limit
    scale = torch.where(over, limit / force.clamp(min=1e-9), t(1.0))
    f_force = f_force * scale
    p_force = p_force * scale
    omega = omega - ((DT * f_force) * WHEEL_R) * R_MOMENT

    Fx = p_force * sx + f_force * fx
    Fy = p_force * sy + f_force * fy
    tau = seq_sum(rx * Fy - ry * Fx)
    vel = car.vel + torch.stack([DT * seq_sum(Fx), DT * seq_sum(Fy)],
                                -1) * R_MASS
    angvel = car.angvel + (DT * tau) * R_INERTIA
    pos = car.pos + DT * vel
    angle = car.angle + DT * angvel
    return CarState(pos=pos, angle=angle, vel=vel, angvel=angvel,
                    wheel_omega=omega, steer_angle=steer_angle, gas=gas,
                    fuel_spent=fuel)
