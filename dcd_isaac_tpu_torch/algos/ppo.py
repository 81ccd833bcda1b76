"""PPO (port of dcd_isaac_tpu/algos/ppo.py): the recurrent and the flat
minibatch branches.

The epoch × minibatch loop is a Python loop over permutation indices with
sequential optimizer steps, as in the reference: each minibatch sees the
parameters the previous one produced.  Recurrent minibatches group whole
envs and replay the BPTT chunk through the model's ``sequence``; a
non-recurrent model (the walker's MLP) takes the flat branch (:189-236):
each epoch permutes the T·N rows and cuts them into minibatches.  The
model's parameters and the optimizer's moments are updated in place.

The loss after the model's forward and the advantage normalisation are
kernel B7 (``kernels/ppo_loss.py``: the categorical branch for logits,
the diagonal-Gaussian branch for a ``dist_type == 'normal'`` model, the
Beta branch for a ``'beta'`` one, which takes the actions unscaled to
[0, 1]); the model's BPTT runs kernel B3.

The optimizer is optax's ``chain(clip_by_global_norm, adam)`` written out:
PyTorch's ``clip_grad_norm_`` divides by ``norm + 1e-6`` and its Adam puts
``eps`` after a differently ordered bias correction, so neither matches
the reference's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..kernels.ppo_loss import (
    normalize_advantages, ppo_loss, ppo_loss_beta, ppo_loss_gaussian,
)


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


def loss_fn(model, cfg: PPOConfig, obs, init_carry, masks_pre, actions,
            old_log_probs, old_values, returns, advs):
    """Clipped-surrogate PPO loss (ppo.py:82-114) → (loss, (vloss, aloss,
    entropy)): the model's (BPTT) forward, then kernel B7."""
    out, values, _ = model.sequence(obs, init_carry, masks_pre)
    if model.dist_type == 'normal':
        loss, vloss, action_loss, entropy = ppo_loss_gaussian(
            out['mean'], out['log_std'], values, actions, old_log_probs,
            old_values, returns, advs, cfg.clip_param, cfg.clip_value_loss,
            cfg.value_loss_coef, cfg.entropy_coef)
        return loss, (vloss, action_loss, entropy)
    if model.dist_type == 'beta':
        loss, vloss, action_loss, entropy = ppo_loss_beta(
            out['alpha'], out['beta'], values, model.unscale(actions),
            old_log_probs, old_values, returns, advs, cfg.clip_param,
            cfg.clip_value_loss, cfg.value_loss_coef, cfg.entropy_coef)
        return loss, (vloss, action_loss, entropy)
    loss, vloss, action_loss, entropy = ppo_loss(
        out, values, actions, old_log_probs, old_values, returns, advs,
        cfg.clip_param, cfg.clip_value_loss, cfg.value_loss_coef,
        cfg.entropy_coef)
    return loss, (vloss, action_loss, entropy)


def make_ppo_update(model, cfg: PPOConfig, num_actors: int):
    """Build ``update(train_state, rollout, returns, init_carry, generator,
    discard_grad, perms=None) → stats``.

    ``perms`` ((ppo_epoch, N) env permutations, or (ppo_epoch, T·N) row
    permutations for a non-recurrent model) may be injected; otherwise
    each epoch draws ``torch.randperm`` from ``generator``.  With
    ``discard_grad`` the gradients are computed and the step is skipped.
    """
    recurrent = model.is_recurrent
    if recurrent and num_actors % cfg.num_mini_batch:
        raise ValueError(f'num_processes={num_actors} is not divisible by '
                         f'num_mini_batch={cfg.num_mini_batch}')

    def update(train_state: AgentTrainState, rollout, returns, init_carry,
               generator: torch.Generator = None, discard_grad: bool = False,
               perms: torch.Tensor = None):
        old_values = rollout.values
        advantages = normalize_advantages(returns, old_values)
        T, N = returns.shape
        rows = N if recurrent else T * N
        if rows % cfg.num_mini_batch:
            raise ValueError(f'{rows} rows are not divisible by '
                             f'num_mini_batch={cfg.num_mini_batch}')
        if perms is None:
            perms = torch.stack([
                torch.randperm(rows, generator=generator,
                               device=returns.device)
                for _ in range(cfg.ppo_epoch)])
        mb_idx = perms.reshape(cfg.ppo_epoch * cfg.num_mini_batch,
                               rows // cfg.num_mini_batch).to(returns.device)
        if recurrent:    # minibatches of whole envs, (T, envs) slices
            pick = lambda x, idx: x[:, idx]
            mb_carry = lambda idx: tuple(c[idx] for c in init_carry)
        else:            # minibatches of rows of the flattened (T·N) batch
            flat = lambda x: x.reshape(T * N, *x.shape[2:])
            rollout = dataclasses.replace(
                rollout, obs={k: flat(v) for k, v in rollout.obs.items()},
                **{f: flat(getattr(rollout, f)) for f in (
                    'masks_pre', 'actions', 'log_probs', 'values')})
            returns, advantages = flat(returns), flat(advantages)
            old_values = rollout.values
            pick = lambda x, idx: x[idx]
            mb_carry = lambda idx: ()

        params = [p for p in train_state.model.parameters()]
        auxes, gnorms = [], []
        for idx in mb_idx:
            mb_obs = {k: pick(v, idx) for k, v in rollout.obs.items()}
            loss, aux = loss_fn(
                train_state.model, cfg, mb_obs, mb_carry(idx),
                pick(rollout.masks_pre, idx), pick(rollout.actions, idx),
                pick(rollout.log_probs, idx), pick(old_values, idx),
                pick(returns, idx), pick(advantages, idx))
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
