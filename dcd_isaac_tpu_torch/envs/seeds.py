"""Terrain seeds of float32 level encodings (dcd_isaac_tpu/envs/seeds.py).

Walker levels are (9,) float32 vectors whose last element is the terrain
seed, drawn from [0, 2^24) so that a plain value cast stores it exactly.
The port keeps seeds as int32 tensors.

``hash_uniform`` is the port's counter-based generator of the terrain and
placement draws: a uniform in [0, 1) from (seed, column, slot) by integer
operations alone, which ``csrc/walker_terrain.cu`` repeats bit for bit.
It does not reproduce ``jax.random``'s threefry: a level (params, seed)
builds another terrain in the port than in the JAX package.
"""

from __future__ import annotations

import torch

SEED_MAX = 1 << 24   # exactly representable in float32
_U32 = 0xFFFFFFFF


def draw_seed(n: int, generator: torch.Generator = None, device=None,
              u: torch.Tensor = None) -> torch.Tensor:
    """(n,) int32 seeds in [0, SEED_MAX); from the uniforms ``u`` when
    given (floor(u * SEED_MAX)), else from ``generator``."""
    if u is None:
        return torch.randint(0, SEED_MAX, (n,), generator=generator,
                             device=device, dtype=torch.int32)
    return (u.double() * SEED_MAX).floor().clamp(max=SEED_MAX - 1).int()


def seed_to_f32(seed: torch.Tensor) -> torch.Tensor:
    """Lossless int → float32 for storage in a level vector."""
    return seed.float()


def f32_to_seed(x: torch.Tensor) -> torch.Tensor:
    """Inverse of seed_to_f32 (truncation toward zero, as ``astype``)."""
    return x.int()


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    return (a * m) & _U32


def hash_uniform(seed: torch.Tensor, col, slot) -> torch.Tensor:
    """float32 uniforms in [0, 1) of (seed, col, slot), broadcast.

    k = seed * 0x9E3779B1 + col * 0x7F4A7C15 + slot * 0x2545F491
    + 0x6A09E667 (mod 2^32), then murmur3's 32-bit finaliser; the top 24
    bits scaled by 2^-24 (exact in float32).  int64 arithmetic masked to
    32 bits, the kernel's uint32 wrap-around.
    """
    s = torch.as_tensor(seed).long()
    c = torch.as_tensor(col, device=s.device).long()
    k = torch.as_tensor(slot, device=s.device).long()
    h = (_mul32(s, 0x9E3779B1) + _mul32(c, 0x7F4A7C15)
         + _mul32(k, 0x2545F491) + 0x6A09E667) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).float() * (2.0 ** -24)
