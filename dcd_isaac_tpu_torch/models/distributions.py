"""Policy distributions (dcd_isaac_tpu/models/distributions.py): the
categorical of the MultiGrid models and the walker's diagonal Gaussian.

Sampling takes an explicit ``torch.Generator``: its stream differs from
``jax.random``'s, so tests inject actions instead of sharing seeds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def categorical_sample(logits: torch.Tensor, generator: torch.Generator
                       ) -> torch.Tensor:
    probs = F.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    a = torch.multinomial(flat, 1, generator=generator)
    return a.reshape(probs.shape[:-1])


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
