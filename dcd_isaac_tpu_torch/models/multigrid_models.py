"""MultiGrid actor-critic network, student configuration.

Port of ``dcd_isaac_tpu/models/multigrid_models.py:29-191``: image/10, a
3x3 VALID conv with ReLU, a one-hot of the direction through a small dense
layer, an LSTM core, and 32-32 tanh actor and critic trunks giving logits
and a value.  The conv runs NCHW and its output is permuted back to
(h, w, c) before flattening, so the features come in the JAX model's NHWC
flatten order and ``convert.from_flax`` needs no permutation of the LSTM
input kernel.  The teacher configuration (conv-128 with the hoisted input
projection, :120-152) comes with the PAIRED slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import RNNCore, mlp, orthogonal_


class MultigridNetwork(nn.Module):
    def __init__(self, num_actions: int, scalar_dim: int = 4,
                 scalar_fc: int = 5, conv_filters: int = 16,
                 conv_kernel: int = 3, view_size: int = 5,
                 recurrent_arch: str = 'lstm',
                 recurrent_hidden_size: int = 256,
                 actor_fc_layers: Sequence[int] = (32, 32),
                 value_fc_layers: Sequence[int] = (32, 32),
                 generator: torch.Generator = None):
        super().__init__()
        self.scalar_dim = scalar_dim
        self.recurrent_arch = recurrent_arch
        self.recurrent_hidden_size = H = recurrent_hidden_size
        self.image_conv = nn.Conv2d(3, conv_filters, conv_kernel)
        nn.init.xavier_uniform_(self.image_conv.weight, generator=generator)
        nn.init.zeros_(self.image_conv.bias)
        self.scalar_embed = nn.Linear(scalar_dim, scalar_fc)
        # flax's default Dense init: lecun normal truncated at 2 std
        std = math.sqrt(1.0 / scalar_dim) / .87962566103423978
        nn.init.trunc_normal_(self.scalar_embed.weight, std=std, a=-2 * std,
                              b=2 * std, generator=generator)
        nn.init.zeros_(self.scalar_embed.bias)
        side = view_size - conv_kernel + 1
        embed_dim = side * side * conv_filters + scalar_fc
        self.core = RNNCore(embed_dim, H, recurrent_arch, generator)
        self.actor_trunk = mlp((H, *actor_fc_layers), generator)
        self.actor_head = nn.Linear(actor_fc_layers[-1], num_actions)
        orthogonal_(self.actor_head.weight, 0.01, generator)
        nn.init.zeros_(self.actor_head.bias)
        self.critic_trunk = mlp((H, *value_fc_layers), generator)
        self.critic_head = nn.Linear(value_fc_layers[-1], 1)
        orthogonal_(self.critic_head.weight, 1.0, generator)
        nn.init.zeros_(self.critic_head.bias)

    @property
    def is_recurrent(self) -> bool:
        return True

    def initial_carry(self, batch_dims, device=None):
        return self.core.initial_carry(batch_dims, device)

    def _embed(self, obs: dict) -> torch.Tensor:
        """(..., v, v, 3) uint8 image and (...,) direction → (..., embed)."""
        img = obs['image']
        lead = img.shape[:-3]
        x = img.reshape(-1, *img.shape[-3:]).float() / 10.0
        x = self.image_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = F.relu(x.reshape(*lead, -1))
        onehot = F.one_hot(obs['direction'].long(), self.scalar_dim).float()
        return torch.cat([x, self.scalar_embed(onehot)], -1)

    def _heads(self, core: torch.Tensor):
        logits = self.actor_head(self.actor_trunk(core))
        value = self.critic_head(self.critic_trunk(core)).squeeze(-1)
        return logits, value

    def forward(self, obs: dict, carry, mask: torch.Tensor):
        """One step: obs (B, ...), mask (B,) → (logits, value, carry)."""
        carry, core = self.core(carry, self._embed(obs), mask)
        logits, value = self._heads(core)
        return logits, value, carry

    def sequence(self, obs: dict, carry, masks: torch.Tensor):
        """(T, B, ...) BPTT forward → (logits, values (T, B), carry)."""
        carry, core = self.core.sequence(carry, self._embed(obs), masks)
        logits, value = self._heads(core)
        return logits, value, carry
