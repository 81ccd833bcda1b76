"""PPO, recurrent minibatch branch (port of dcd_isaac_tpu/algos/ppo.py).

The epoch × minibatch loop is a Python loop over permutation indices with
sequential optimizer steps, as in the reference: each minibatch sees the
parameters the previous one produced.  Recurrent minibatches group whole
envs and replay the BPTT chunk through the model's ``sequence``.  The
model's parameters and the optimizer's moments are updated in place.

The optimizer is optax's ``chain(clip_by_global_norm, adam)`` written out:
PyTorch's ``clip_grad_norm_`` divides by ``norm + 1e-6`` and its Adam puts
``eps`` after a differently ordered bias correction, so neither matches
the reference's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..models.distributions import categorical_entropy, categorical_log_prob


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_param: float = 0.2
    ppo_epoch: int = 5
    num_mini_batch: int = 1
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.0
    lr: float = 1e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.5
    clip_value_loss: bool = True


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of all entries (optax.global_norm)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class ClipAdam:
    """optax ``chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))``.

    ``step(grads)`` applies one update to ``params`` in place and returns
    the global norm of the unclipped gradients (optax.global_norm).
    """

    b1, b2 = 0.9, 0.999     # optax.adam's defaults

    def __init__(self, params, lr: float, eps: float = 1e-8,
                 max_grad_norm: Optional[float] = None):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.eps, self.max_grad_norm = lr, eps, max_grad_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        gnorm = global_norm(grads)
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            keep = gnorm < self.max_grad_norm
            grads = [torch.where(keep, g, (g / gnorm) * self.max_grad_norm)
                     for g in grads]
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self.lr * update)
        return gnorm


def make_optimizer(params, cfg: PPOConfig) -> ClipAdam:
    return ClipAdam(params, cfg.lr, cfg.eps, cfg.max_grad_norm)


@dataclasses.dataclass
class AgentTrainState:
    model: torch.nn.Module
    opt: ClipAdam


def init_agent_state(model: torch.nn.Module, cfg: PPOConfig
                     ) -> AgentTrainState:
    return AgentTrainState(model, make_optimizer(model.parameters(), cfg))


def smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)


def loss_fn(model, cfg: PPOConfig, obs, init_carry, masks_pre, actions,
            old_log_probs, old_values, returns, advs):
    """Clipped-surrogate PPO loss (ppo.py:82-114) → (loss, (vloss, aloss,
    entropy))."""
    logits, values, _ = model.sequence(obs, init_carry, masks_pre)
    new_log_probs = categorical_log_prob(logits, actions)
    entropy = categorical_entropy(logits).mean()

    ratio = torch.exp(new_log_probs - old_log_probs)
    surr1 = ratio * advs
    surr2 = ratio.clamp(1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * advs
    action_loss = -torch.minimum(surr1, surr2).mean()

    if cfg.clip_value_loss:
        clipped = old_values + (values - old_values).clamp(
            -cfg.clip_param, cfg.clip_param)
        vloss = 0.5 * torch.maximum((values - returns) ** 2,
                                    (clipped - returns) ** 2).mean()
    else:
        vloss = smooth_l1(values, returns).mean()

    loss = (vloss * cfg.value_loss_coef + action_loss
            - entropy * cfg.entropy_coef)
    return loss, (vloss, action_loss, entropy)


def make_ppo_update(model, cfg: PPOConfig, num_actors: int):
    """Build ``update(train_state, rollout, returns, init_carry, generator,
    discard_grad, perms=None) → stats``.

    ``perms`` ((ppo_epoch, N) env permutations) may be injected; otherwise
    each epoch draws ``torch.randperm`` from ``generator``.  With
    ``discard_grad`` the gradients are computed and the step is skipped.
    """
    if not model.is_recurrent:
        raise NotImplementedError(
            'the flat (non-recurrent) PPO branch is not ported yet')
    if num_actors % cfg.num_mini_batch:
        raise ValueError(f'num_processes={num_actors} is not divisible by '
                         f'num_mini_batch={cfg.num_mini_batch}')
    envs_per_mb = num_actors // cfg.num_mini_batch

    def update(train_state: AgentTrainState, rollout, returns, init_carry,
               generator: torch.Generator = None, discard_grad: bool = False,
               perms: torch.Tensor = None):
        old_values = rollout.values
        advantages = returns - old_values
        advantages = (advantages - advantages.mean()) / (
            advantages.std(correction=0) + 1e-5)
        N = returns.shape[1]
        if perms is None:
            perms = torch.stack([
                torch.randperm(N, generator=generator,
                               device=returns.device)
                for _ in range(cfg.ppo_epoch)])
        mb_idx = perms.reshape(cfg.ppo_epoch * cfg.num_mini_batch,
                               envs_per_mb).to(returns.device)

        params = [p for p in train_state.model.parameters()]
        auxes, gnorms = [], []
        for idx in mb_idx:
            mb_obs = {k: v[:, idx] for k, v in rollout.obs.items()}
            mb_carry = tuple(c[idx] for c in init_carry)
            loss, aux = loss_fn(
                train_state.model, cfg, mb_obs, mb_carry,
                rollout.masks_pre[:, idx], rollout.actions[:, idx],
                rollout.log_probs[:, idx], old_values[:, idx],
                returns[:, idx], advantages[:, idx])
            grads = torch.autograd.grad(loss, params)
            if discard_grad:
                gnorm = global_norm(grads)
            else:
                gnorm = train_state.opt.step(grads)
            auxes.append(torch.stack([a.detach() for a in aux]))
            gnorms.append(gnorm)

        means = torch.stack(auxes).mean(0)
        return {
            'value_loss': means[0],
            'action_loss': means[1],
            'dist_entropy': means[2],
            'grad_norm': torch.stack(gnorms).mean(),
        }

    return update
