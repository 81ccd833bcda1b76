"""Student and teacher rollouts (port of dcd_isaac_tpu/algos/rollout.py).

A Python loop over T steps of a batch of N envs replaces the JAX
``lax.scan``: policy forward, env step (kernel B1 or B10), the
rollout-final forced done and cliffhanger, the truncation-value forward,
VecMonitor episode accounting, VecNormalize's return normalisation (with
``normalize_returns_gamma``; its running statistics are carried in
``StepCarry.ret_rms`` across cycles) and the auto-reset select all run on
the envs' device.  The policy is a categorical over logits (MultiGrid), a
diagonal Gaussian (the walker, ``model.dist_type == 'normal'``) or a Beta
per action (CarRacing, ``'beta'``: the model samples, scales the action
to the env's bounds and gives the raw sample's log-prob).  The
only host syncs are the "any slot finished" checks of a stochastic reset,
one a step on the card, counted in ``make_student_rollout.host_syncs``.

The MultiGrid student's three policy calls a step (the action, the
``handle_timelimits`` value of the pre-reset obs, and after the loop the
bootstrap value) are kernel B2 (``model.step``), its weights packed once
a rollout; a draw takes one uniform a row from the rollout's generator.

Auto-reset is pluggable through ``reset_fn(t, env_state, level_seeds) ->
(env_state, obs, level_seeds)``, called for the whole batch and selected
per slot where an episode really ended; the default replays the same level
against the rollout's initial state.  ``sample_action_fn(out, t)`` lets a
caller (the parity tests) choose the actions; the default samples from
the policy with the rollout's generator.  For a B2 student the actions
are chosen before its step, so ``out`` is None, and the kernel gives the
chosen action's log-prob.

The teacher's construction rollout (``make_adversary_rollout``) is the same
loop over ``adversary_max_steps`` moves of kernel B5, with zero rewards
until the runner writes the regret into the last step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..models.distributions import (
    categorical_log_prob, categorical_sample, normal_log_prob, normal_sample,
)
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
    # VecNormalize (vec_normalize.py:37-53): the discounted-return
    # accumulator (N,) and the returns' running mean, var, count (); None
    # without return normalisation
    ret_rms: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    num_steps: int
    clip_reward: Optional[float] = None
    handle_timelimits: bool = False
    # record the policy's log-softmax at every step (PLR's entropy and
    # margin strategies read it; one more launch a step)
    record_log_dists: bool = False
    normalize_returns_gamma: Optional[float] = None  # VecNormalize's gamma


def _select(mask: torch.Tensor, new: dict, old: dict) -> dict:
    return {k: torch.where(mask.reshape(mask.shape + (1,) * (v.dim() - 1)),
                           v, old[k]) for k, v in new.items()}


def _stack(steps) -> Rollout:
    """The Rollout of a list of per-step dicts (obs a dict of its own)."""
    stacked = {k: torch.stack([s[k] for s in steps])
               for k in steps[0] if k != 'obs'}
    stacked['obs'] = {k: torch.stack([s['obs'][k] for s in steps])
                      for k in steps[0]['obs']}
    return Rollout(**stacked)


def _normalize_returns(ret_rms, reward, real_done, gamma):
    """VecNormalize's step (JAX rollout.py:157-176): the returns' running
    variance updated with this step's discounted returns, the reward
    divided by its std; the accumulator reset where an episode ended."""
    ret_accum, mean, var, count = ret_rms
    ret_accum = ret_accum * gamma + reward
    b_mean = ret_accum.mean()
    b_var = ret_accum.var(correction=0)
    bc = ret_accum.shape[0]
    delta = b_mean - mean
    tot = count + bc
    new_mean = mean + delta * bc / tot
    m2 = var * count + b_var * bc + delta ** 2 * count * bc / tot
    new_var = m2 / tot
    reward = reward / torch.sqrt(new_var + 1e-8)
    ret_accum = torch.where(real_done, torch.zeros_like(ret_accum),
                            ret_accum)
    return (ret_accum, new_mean, new_var, tot), reward


def make_student_rollout(env, model, cfg: RolloutConfig,
                         reset_fn: Callable = None,
                         sample_action_fn: Callable = None):
    """Build ``rollout(carry, generator) → (final, Rollout, next_value,
    stats)``.  ``sample_action_fn(out, t)`` gets the policy's output
    (logits, the Gaussian's ``{'mean', 'log_std'}`` or the Beta's
    ``{'alpha', 'beta'}``; None for a B2 student) and returns the action
    (a Beta's scaled)."""
    T = cfg.num_steps
    normal = model.dist_type == 'normal'
    beta = model.dist_type == 'beta'
    fused = model.fused_policy_step

    def rollout(carry: StepCarry, generator: torch.Generator = None):
        if sample_action_fn is not None:
            sample = sample_action_fn
        elif normal:
            sample = lambda out, t: normal_sample(
                out['mean'], out['log_std'], generator)
        else:
            sample = lambda logits, t: categorical_sample(logits, generator)
        n = carry.mask.shape[0]
        dev = carry.mask.device
        init_state, init_obs, init_seeds = (
            carry.env_state, carry.obs, carry.level_seeds)
        steps = []
        with torch.no_grad():
            weights = model.policy_weights() if fused else None
            for t in range(T):
                if fused:
                    if sample_action_fn is None:
                        u = torch.rand((n,), generator=generator, device=dev)
                        out = model.step(carry.obs, carry.rnn_carry,
                                         carry.mask, weights, 'sample', u=u)
                    else:
                        out = model.step(carry.obs, carry.rnn_carry,
                                         carry.mask, weights, 'action',
                                         action=sample_action_fn(None, t))
                    action, log_prob, logits, value, rnn_carry = out
                else:
                    logits, value, rnn_carry = model(
                        carry.obs, carry.rnn_carry, carry.mask)
                    if beta and sample_action_fn is None:
                        action, log_prob = model.sample_action(logits,
                                                               generator)
                    elif beta:
                        action = sample(logits, t)
                        log_prob = model.log_prob(logits, action)
                    elif normal:
                        action = sample(logits, t)
                        log_prob = normal_log_prob(logits['mean'],
                                                   logits['log_std'], action)
                    else:
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
                if cfg.handle_timelimits and fused:
                    trunc_value = model.step(
                        next_obs, rnn_carry, torch.ones_like(carry.mask),
                        weights, 'value').value
                elif cfg.handle_timelimits:
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
                ret_rms = carry.ret_rms
                if cfg.normalize_returns_gamma is not None:
                    ret_rms, reward = _normalize_returns(
                        ret_rms, reward, real_done,
                        cfg.normalize_returns_gamma)
                if cfg.clip_reward:
                    reward = reward.clamp(-cfg.clip_reward, cfg.clip_reward)

                # Auto-reset finished slots.  A stochastic reset builds new
                # levels, so it runs only on steps where a slot finished.
                if reset_fn is None:
                    reset = (init_state, init_obs, init_seeds)
                else:
                    if real_done.is_cuda:
                        make_student_rollout.host_syncs += 1
                    reset = (reset_fn(t, env_state, carry.level_seeds)
                             if bool(real_done.any()) else None)
                next_seeds = carry.level_seeds
                if reset is not None:
                    env_state = reset[0].where(real_done, env_state)
                    next_obs = _select(real_done, reset[1], next_obs)
                    next_seeds = torch.where(real_done, reset[2], next_seeds)

                step = dict(
                    obs=carry.obs, actions=action, log_probs=log_prob,
                    values=value, rewards=reward, masks_pre=carry.mask,
                    dones=done, bad_masks=1.0 - truncated.float(),
                    trunc_values=trunc_value, cliffhangers=cliffhanger,
                    level_seeds=carry.level_seeds)
                if cfg.record_log_dists:
                    step['log_dists'] = (log_prob if normal or beta else
                                         torch.log_softmax(logits, -1))
                steps.append(step)
                carry = StepCarry(
                    env_state=env_state, obs=next_obs, rnn_carry=rnn_carry,
                    mask=1.0 - done.float(), level_seeds=next_seeds,
                    epi_return=torch.where(real_done, zero, epi_return),
                    epi_count=epi_count, ret_sum=ret_sum, ret_max=ret_max,
                    ret_rms=ret_rms)

            # Bootstrap value of the final obs (reference next_value).
            if fused:
                next_value = model.step(carry.obs, carry.rnn_carry,
                                        carry.mask, weights, 'value').value
            else:
                _, next_value, _ = model(carry.obs, carry.rnn_carry,
                                         carry.mask)

        has_epi = carry.epi_count > 0
        zero = torch.zeros((n,), device=dev)
        stats = {
            'mean_return': torch.where(
                has_epi, carry.ret_sum / carry.epi_count.clamp(min=1), zero),
            'max_return': torch.where(has_epi, carry.ret_max, zero),
            'episode_count': carry.epi_count,
        }
        return carry, _stack(steps), next_value, stats

    return rollout


make_student_rollout.host_syncs = 0


def initial_step_carry(model, env_state, obs, level_seeds=None,
                       ret_rms=None) -> StepCarry:
    """Fresh StepCarry for a batch of already-reset envs; ``ret_rms`` the
    VecNormalize statistics carried over from the last rollout."""
    first = next(iter(obs.values()))
    n, dev = first.shape[0], first.device
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
        ret_rms=ret_rms,
    )


def make_adversary_rollout(env, model, adv_steps: int,
                           sample_action_fn: Callable = None,
                           draws_fn: Callable = None):
    """Build ``rollout(env_state, obs, generator) → (env_state, Rollout,
    next_value)``, the teacher's construction (rollout.py:300-364).

    Rewards are zero (the runner replaces the last by the teacher's
    return), masks follow ``done``, ``bad_masks`` are 1 and
    ``trunc_values`` 0; a teacher without a core carries ``()``.
    ``sample_action_fn(logits, t)`` chooses the moves and ``draws_fn(t)``
    gives ``step_adversary``'s draws (the parity tests inject both); by
    default the moves are sampled from the policy and the draws taken,
    with ``generator``.
    """
    T = adv_steps

    def rollout(env_state, obs: dict, generator: torch.Generator = None):
        if sample_action_fn is None:
            sample = lambda logits, t: categorical_sample(logits, generator)
        else:
            sample = sample_action_fn
        n = obs['image'].shape[0]
        dev = obs['image'].device
        rnn_carry = model.initial_carry((n,), dev)
        mask = torch.zeros((n,), device=dev)
        zeros = torch.zeros((n,), device=dev)
        steps = []
        with torch.no_grad():
            for t in range(T):
                logits, value, rnn_carry = model(obs, rnn_carry, mask)
                action = sample(logits, t)
                log_prob = categorical_log_prob(logits, action)
                env_state, next_obs, done = env.step_adversary(
                    env_state, action, generator,
                    draws_fn(t) if draws_fn is not None else None)
                steps.append(dict(
                    obs=obs, actions=action, log_probs=log_prob,
                    values=value, rewards=zeros, masks_pre=mask, dones=done,
                    bad_masks=torch.ones_like(zeros), trunc_values=zeros))
                mask = 1.0 - done.float()
                obs = next_obs
            _, next_value, _ = model(obs, rnn_carry, mask)

        return env_state, _stack(steps), next_value

    return rollout
