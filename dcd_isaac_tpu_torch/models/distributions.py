"""Categorical policy helpers (dcd_isaac_tpu/models/distributions.py:17-37).

Sampling takes an explicit ``torch.Generator``: its stream differs from
``jax.random``'s, so tests inject actions instead of sharing seeds.
"""

from __future__ import annotations

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
