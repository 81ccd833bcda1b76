"""Student rollout (port of dcd_isaac_tpu/algos/rollout.py:29-298).

A Python loop over T steps of a batch of N envs replaces the JAX
``lax.scan``: policy forward, env step (kernel 1), the rollout-final forced
done and cliffhanger, the truncation-value forward, VecMonitor episode
accounting and the auto-reset select all run on the envs' device.  The
only host syncs are the "any slot finished" checks of a stochastic reset.

Auto-reset is pluggable through ``reset_fn(t, env_state, level_seeds) ->
(env_state, obs, level_seeds)``, called for the whole batch and selected
per slot where an episode really ended; the default replays the same level
against the rollout's initial state.  ``sample_action_fn(logits, t)`` lets
a caller (the parity tests) choose the actions; the default samples from
the policy with the rollout's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..models.distributions import categorical_log_prob, categorical_sample
from .storage import Rollout


@dataclasses.dataclass(frozen=True)
class StepCarry:
    env_state: Any
    obs: dict
    rnn_carry: Any
    mask: torch.Tensor          # (N,) mask entering the next step
    level_seeds: torch.Tensor   # (N,) int32
    # episode accounting (VecMonitor semantics)
    epi_return: torch.Tensor    # (N,) running (unclipped) episode return
    epi_count: torch.Tensor     # (N,) completed episodes this rollout
    ret_sum: torch.Tensor       # (N,) sum of completed episode returns
    ret_max: torch.Tensor       # (N,) max completed episode return


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    num_steps: int
    clip_reward: Optional[float] = None
    handle_timelimits: bool = False


def _select(mask: torch.Tensor, new: dict, old: dict) -> dict:
    return {k: torch.where(mask.reshape(mask.shape + (1,) * (v.dim() - 1)),
                           v, old[k]) for k, v in new.items()}


def make_student_rollout(env, model, cfg: RolloutConfig,
                         reset_fn: Callable = None,
                         sample_action_fn: Callable = None):
    """Build ``rollout(carry, generator) → (final, Rollout, next_value,
    stats)``."""
    T = cfg.num_steps

    def rollout(carry: StepCarry, generator: torch.Generator = None):
        if sample_action_fn is None:
            sample = lambda logits, t: categorical_sample(logits, generator)
        else:
            sample = sample_action_fn
        n = carry.mask.shape[0]
        dev = carry.mask.device
        init_state, init_obs, init_seeds = (
            carry.env_state, carry.obs, carry.level_seeds)
        steps = []
        with torch.no_grad():
            for t in range(T):
                logits, value, rnn_carry = model(
                    carry.obs, carry.rnn_carry, carry.mask)
                action = sample(logits, t)
                log_prob = categorical_log_prob(logits, action)

                env_state, next_obs, reward, done, info = env.step(
                    carry.env_state, action)
                truncated = info['truncated']

                # Rollout-final forced termination (rollout.py:129-134)
                if t == T - 1:
                    cliffhanger = ~done
                    if cfg.handle_timelimits:
                        truncated = truncated | ~done
                    done = torch.ones_like(done)
                else:
                    cliffhanger = torch.zeros_like(done)

                # V(s_trunc): the pre-reset next obs with the post-step
                # hidden state (rollout.py:138-144)
                if cfg.handle_timelimits:
                    _, trunc_value, _ = model(
                        next_obs, rnn_carry, torch.ones_like(carry.mask))
                else:
                    trunc_value = torch.zeros_like(value)

                epi_return = carry.epi_return + reward
                real_done = done & ~cliffhanger
                zero = torch.zeros_like(epi_return)
                epi_count = carry.epi_count + real_done.int()
                ret_sum = carry.ret_sum + torch.where(real_done, epi_return,
                                                      zero)
                ret_max = torch.where(
                    real_done, torch.maximum(carry.ret_max, epi_return),
                    carry.ret_max)
                if cfg.clip_reward:
                    reward = reward.clamp(-cfg.clip_reward, cfg.clip_reward)

                # Auto-reset finished slots.  A stochastic reset builds new
                # levels, so it runs only on steps where a slot finished.
                if reset_fn is None:
                    reset = (init_state, init_obs, init_seeds)
                elif bool(real_done.any()):
                    reset = reset_fn(t, env_state, carry.level_seeds)
                else:
                    reset = None
                next_seeds = carry.level_seeds
                if reset is not None:
                    env_state = reset[0].where(real_done, env_state)
                    next_obs = _select(real_done, reset[1], next_obs)
                    next_seeds = torch.where(real_done, reset[2], next_seeds)

                steps.append(dict(
                    obs=carry.obs, actions=action, log_probs=log_prob,
                    values=value, rewards=reward, masks_pre=carry.mask,
                    dones=done, bad_masks=1.0 - truncated.float(),
                    trunc_values=trunc_value))
                carry = StepCarry(
                    env_state=env_state, obs=next_obs, rnn_carry=rnn_carry,
                    mask=1.0 - done.float(), level_seeds=next_seeds,
                    epi_return=torch.where(real_done, zero, epi_return),
                    epi_count=epi_count, ret_sum=ret_sum, ret_max=ret_max)

            # Bootstrap value of the final obs (reference next_value).
            _, next_value, _ = model(carry.obs, carry.rnn_carry, carry.mask)

        stacked = {k: torch.stack([s[k] for s in steps])
                   for k in steps[0] if k != 'obs'}
        stacked['obs'] = {k: torch.stack([s['obs'][k] for s in steps])
                          for k in steps[0]['obs']}
        has_epi = carry.epi_count > 0
        zero = torch.zeros((n,), device=dev)
        stats = {
            'mean_return': torch.where(
                has_epi, carry.ret_sum / carry.epi_count.clamp(min=1), zero),
            'max_return': torch.where(has_epi, carry.ret_max, zero),
            'episode_count': carry.epi_count,
        }
        return carry, Rollout(**stacked), next_value, stats

    return rollout


def initial_step_carry(model, env_state, obs, level_seeds=None) -> StepCarry:
    """Fresh StepCarry for a batch of already-reset envs."""
    n = obs['image'].shape[0]
    dev = obs['image'].device
    if level_seeds is None:
        level_seeds = torch.full((n,), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros((n,), device=dev)
    return StepCarry(
        env_state=env_state,
        obs=obs,
        rnn_carry=model.initial_carry((n,), dev),
        mask=zeros,    # mask[0] = 0: fresh episodes
        level_seeds=level_seeds,
        epi_return=zeros,
        epi_count=torch.zeros((n,), dtype=torch.int32, device=dev),
        ret_sum=zeros,
        ret_max=torch.full((n,), float('-inf'), device=dev),
    )
