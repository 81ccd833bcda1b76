"""Rollout storage and GAE (port of dcd_isaac_tpu/algos/storage.py:33-150).

A rollout is the (T, N, ...) tensors of one rollout phase, stacked from the
steps of ``algos/rollout.py``: the fields GAE and the PPO update read, and
the ones PLR's scoring reads (``level_replay/plr.py``): ``cliffhangers``,
``level_seeds`` and, for the strategies that score the policy's
distribution, ``log_dists``.  ``compute_gae`` is kernel B6
(``kernels/gae.py``).  Like the JAX package, proper-time-limit
bootstrapping adds ``γ·V(s_trunc)`` to the delta of the truncation step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..kernels.gae import gae


@dataclasses.dataclass(frozen=True)
class Rollout:
    """(T, N, ...) tensors from one rollout phase."""
    obs: Any                     # dict of (T, N, ...) tensors
    actions: torch.Tensor        # (T, N) int64
    log_probs: torch.Tensor      # (T, N)
    values: torch.Tensor         # (T, N)
    rewards: torch.Tensor        # (T, N)
    masks_pre: torch.Tensor      # (T, N) mask BEFORE step t (1 = same episode)
    dones: torch.Tensor          # (T, N) bool, episode ended AT step t
    bad_masks: torch.Tensor      # (T, N) 0 = time-limit (truncated) end at t
    trunc_values: torch.Tensor   # (T, N) V(truncated obs) at truncations
    cliffhangers: Optional[torch.Tensor] = None  # (T, N) bool, forced final
    #                                              done of a running episode
    level_seeds: Optional[torch.Tensor] = None   # (T, N) int32 seed at step t
    log_dists: Optional[torch.Tensor] = None     # (T, N, A) log-softmax,
    #                                              recorded when PLR reads it

    def replace_final_reward(self, returns: torch.Tensor) -> 'Rollout':
        """The teacher's return becomes the final-step reward
        (storage.py:61)."""
        rewards = self.rewards.clone()
        rewards[-1] = returns
        return dataclasses.replace(self, rewards=rewards)


def compute_gae(rollout: Rollout, next_value: torch.Tensor, gamma: float,
                gae_lambda: float, use_proper_time_limits: bool = False
                ) -> torch.Tensor:
    """Generalized advantage estimation → returns (T, N)."""
    return gae(rollout.rewards, rollout.values, rollout.dones,
               rollout.bad_masks, rollout.trunc_values, next_value, gamma,
               gae_lambda, use_proper_time_limits)


def batched_value_loss(returns: torch.Tensor, value_preds: torch.Tensor,
                       signed: bool = False, positive_only: bool = False,
                       power: int = 1, clipped: bool = True) -> torch.Tensor:
    """Per-env mean TD magnitude, (T, N) → (N,) (storage.py:126-150): the
    'easy' parent choice of ACCEL."""
    td = returns - value_preds
    if positive_only and not signed:
        td = td.clamp(min=0)
    elif not signed:
        td = td.abs()
    if power > 1:
        td = td ** power
    batch_td = td.mean(0)
    if clipped:
        batch_td = batch_td.clamp(-1, 1)
    return batch_td
