"""Policy distributions (dcd_isaac_tpu/models/distributions.py): the
categorical of the MultiGrid models, the walker's diagonal Gaussian and
CarRacing's Beta.

Sampling takes an explicit ``torch.Generator``: its stream differs from
``jax.random``'s, so tests inject actions instead of sharing seeds.  A
categorical draw is the inverse CDF of softmax(logits) at one uniform a
row, the rule kernel B2 (``kernels/policy_step.py``) applies in its
epilogue to the same uniforms.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def categorical_inverse_cdf(logits: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
    """The action whose CDF interval of softmax(logits) holds ``u`` in
    [0, 1): the number of CDF entries (but the last) at or below ``u``."""
    cdf = F.softmax(logits, dim=-1).cumsum(-1)
    return (cdf[..., :-1] <= u[..., None]).sum(-1)


def categorical_sample(logits: torch.Tensor, generator: torch.Generator
                       ) -> torch.Tensor:
    u = torch.rand(logits.shape[:-1], generator=generator,
                   device=logits.device)
    return categorical_inverse_cdf(logits, u)


def categorical_log_prob(logits: torch.Tensor, actions: torch.Tensor
                         ) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return logp.gather(-1, actions.long()[..., None]).squeeze(-1)


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(-1)


def categorical_mode(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(-1)


# --------------------------- Diagonal Gaussian ------------------------------
# (dcd_isaac_tpu/models/distributions.py:39-53); ``log_std`` broadcasts
# against ``mean``.

def normal_sample(mean: torch.Tensor, log_std: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + torch.exp(log_std) * noise


def normal_log_prob(mean: torch.Tensor, log_std: torch.Tensor,
                    actions: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    lp = (-((actions - mean) ** 2) / (2 * var) - log_std
          - 0.5 * math.log(2 * math.pi))
    return lp.sum(-1)


def normal_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


# --------------------------- Beta -------------------------------------------
# (dcd_isaac_tpu/models/distributions.py:56-91); one Beta per action dim.

def beta_sample(alpha: torch.Tensor, beta: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """Ga / (Ga + Gb) of two standard Gamma draws."""
    ga = torch._standard_gamma(alpha, generator=generator)
    gb = torch._standard_gamma(beta, generator=generator)
    return ga / (ga + gb)


def beta_log_b(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return (torch.lgamma(alpha) + torch.lgamma(beta)) - torch.lgamma(
        alpha + beta)


# the sample's clip bounds as float32 (JAX's): a float64 twin clips alike
BETA_LO = float(np.float32(1e-6))
BETA_HI = float(np.float32(1 - 1e-6))


def beta_log_prob(alpha: torch.Tensor, beta: torch.Tensor,
                  actions: torch.Tensor) -> torch.Tensor:
    """Log-density summed over the last axis, the sample clipped to
    [1e-6, 1 - 1e-6] (their float32 values)."""
    x = actions.clamp(BETA_LO, BETA_HI)
    lp = ((alpha - 1) * torch.log(x) + (beta - 1) * torch.log1p(-x)
          - beta_log_b(alpha, beta))
    return lp.sum(-1)


def beta_entropy(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    ent = ((beta_log_b(alpha, beta) - (alpha - 1) * torch.digamma(alpha))
           - (beta - 1) * torch.digamma(beta)
           + (alpha + beta - 2) * torch.digamma(alpha + beta))
    return ent.sum(-1)


def beta_mode(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
    return torch.where(
        (alpha > 1) & (beta > 1), (alpha - 1) / (alpha + beta - 2),
        torch.where(alpha > beta, one,
                    torch.where(beta > alpha, zero, 0.5 * one)))
