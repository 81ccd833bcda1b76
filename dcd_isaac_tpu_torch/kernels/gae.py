"""Kernel 2: generalized advantage estimation.

Replaces ``dcd_isaac_tpu/algos/storage.py:compute_gae`` (:66-105), both
branches of ``use_proper_time_limits``.  The CUDA source is ``csrc/gae.cu``:
one thread per env column runs the reverse scan over T in registers.  It is
bound by bytes (each (T, N) input read once, the returns written once) and
at the main path's T = 256, N = 32 by its launch and the 256-step dependent
chain.

``gae`` takes the plain PyTorch twin (``gae_plain``) for CPU tensors and
launches the kernel or raises for CUDA tensors.  Both round every
operation in the same order, so they agree to the last bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def gae_plain(rewards, values, dones, bad_masks, trunc_values, next_value,
              gamma: float, gae_lambda: float,
              use_proper_time_limits: bool = False) -> torch.Tensor:
    """(T, N) returns = advantages + values (storage.py:compute_gae)."""
    values_next = torch.cat([values[1:], next_value[None]], 0)
    mask_next = 1.0 - dones.float()
    if use_proper_time_limits:
        trunc_boot = (1.0 - mask_next) * (1.0 - bad_masks) * trunc_values
    else:
        trunc_boot = torch.zeros_like(values)
    boot = mask_next * values_next + trunc_boot
    deltas = rewards + gamma * boot - values
    adv = torch.zeros_like(next_value)
    advs = []
    for t in reversed(range(rewards.shape[0])):
        adv = deltas[t] + gamma * gae_lambda * mask_next[t] * adv
        advs.append(adv)
    return torch.stack(advs[::-1]) + values


def gae(rewards, values, dones, bad_masks, trunc_values, next_value,
        gamma: float, gae_lambda: float,
        use_proper_time_limits: bool = False) -> torch.Tensor:
    """GAE returns for (T, N) float32 rollouts with (T, N) bool ``dones``.

    CPU tensors take :func:`gae_plain`; CUDA tensors launch the kernel
    (counted in ``gae.launches``) or raise.
    """
    if rewards.dim() != 2:
        raise ValueError(
            f'rewards: expected (T, N), got {tuple(rewards.shape)}')
    T, N = rewards.shape
    dev = rewards.device
    for name, t, dtype, shape in (
            ('rewards', rewards, torch.float32, (T, N)),
            ('values', values, torch.float32, (T, N)),
            ('dones', dones, torch.bool, (T, N)),
            ('bad_masks', bad_masks, torch.float32, (T, N)),
            ('trunc_values', trunc_values, torch.float32, (T, N)),
            ('next_value', next_value, torch.float32, (N,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f'{name}: expected {dtype} {shape} on {dev}, got {t.dtype} '
                f'{tuple(t.shape)} on {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: must be contiguous')
    if dev.type == 'cpu':
        return gae_plain(rewards, values, dones, bad_masks, trunc_values,
                         next_value, gamma, gae_lambda, use_proper_time_limits)
    returns = torch.empty((T, N), dtype=torch.float32, device=dev)
    lib = _build.library()
    rc = lib.dcd_gae(
        rewards.data_ptr(), values.data_ptr(), dones.data_ptr(),
        bad_masks.data_ptr(), trunc_values.data_ptr(), next_value.data_ptr(),
        returns.data_ptr(), T, N, ctypes.c_float(gamma),
        ctypes.c_float(gamma * gae_lambda), int(use_proper_time_limits),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'gae')
    gae.launches += 1
    return returns


gae.launches = 0
