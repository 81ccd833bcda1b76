"""Rollout storage and GAE (port of dcd_isaac_tpu/algos/storage.py:33-150).

A rollout is the (T, N, ...) tensors of one rollout phase, stacked from the
steps of ``algos/rollout.py``: the fields GAE and the PPO update read.  The
JAX Rollout's ``log_dists``, ``cliffhangers`` and ``level_seeds`` feed PLR
scoring (level_replay/plr.py) and come with the PLR slice, as does
``batched_value_loss``.  ``compute_gae`` is kernel 2 (``kernels/gae.py``).  Like the JAX package, proper-time-limit
bootstrapping adds ``γ·V(s_trunc)`` to the delta of the truncation step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

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

