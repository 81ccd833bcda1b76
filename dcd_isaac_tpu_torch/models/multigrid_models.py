"""MultiGrid actor-critic network: the students and the teacher.

Port of ``dcd_isaac_tpu/models/multigrid_models.py:29-191``: image/10, a
3x3 VALID conv with ReLU, a one-hot scalar (the student's direction, the
teacher's time step) through a small dense layer, the teacher's
``random_z``, an LSTM core (or none: the non-recurrent teacher), and 32-32
tanh actor and critic trunks giving logits and a value; without a core the
trunks' first layers take the embed (flax infers their input width).  The
conv runs NCHW and its output is permuted back to (h, w, c) before
flattening, so the features come in the JAX model's NHWC flatten order and
``convert.from_flax`` needs no permutation of the LSTM input kernel.

The teacher configuration (``make_agent``: conv-128 over the 15x15 grid,
scalar_fc 10, random_z 50) has a 21 692-wide embed.  Where the conv embed
is at least 4096 wide (JAX's threshold, :124) the product of the embed
with the next layer is kernel B4 (``kernels/teacher_proj.py``), in the
one-step forward and in ``sequence`` alike, so the embed never reaches
device memory: the LSTM's input projection (N = 4H), or, without a core,
the two trunks' first layers stacked into one (64, 21 692) weight, their
biases and tanh applied after.

The student's one step (a rollout's policy step, and ``forward``) is
kernel B2 (``kernels/policy_step.py``): embed, LSTM cell, heads and, in
``step``, the action's draw or log-prob.  ``sequence`` (the PPO update's
BPTT) keeps the plain embed and heads around kernel B3's recurrence.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import policy_step as b2
from ..kernels.teacher_proj import teacher_proj
from .common import RNNCore, mlp, orthogonal_

# Conv embeds at least this wide take the fused projection (kernel B4).
HOIST_MIN_CONV_DIM = 4096


class MultigridNetwork(nn.Module):
    dist_type = 'categorical'

    def __init__(self, num_actions: int, scalar_dim: int = 4,
                 scalar_fc: int = 5, conv_filters: int = 16,
                 conv_kernel: int = 3, view_size: int = 5,
                 random_z_dim: int = 0,
                 recurrent_arch: str = 'lstm',
                 recurrent_hidden_size: int = 256,
                 actor_fc_layers: Sequence[int] = (32, 32),
                 value_fc_layers: Sequence[int] = (32, 32),
                 generator: torch.Generator = None):
        """``view_size`` is the side of the square image: the student's
        view or the teacher's whole grid."""
        super().__init__()
        self.scalar_dim = scalar_dim
        self.random_z_dim = random_z_dim
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
        conv_dim = side * side * conv_filters
        self.fused_projection = conv_dim >= HOIST_MIN_CONV_DIM
        embed_dim = conv_dim + scalar_fc + random_z_dim
        self.core = RNNCore(embed_dim, H, recurrent_arch, generator)
        trunk_in = H if self.core.is_recurrent else embed_dim
        self.actor_trunk = mlp((trunk_in, *actor_fc_layers), generator)
        self.actor_head = nn.Linear(actor_fc_layers[-1], num_actions)
        orthogonal_(self.actor_head.weight, 0.01, generator)
        nn.init.zeros_(self.actor_head.bias)
        self.critic_trunk = mlp((trunk_in, *value_fc_layers), generator)
        self.critic_head = nn.Linear(value_fc_layers[-1], 1)
        orthogonal_(self.critic_head.weight, 1.0, generator)
        nn.init.zeros_(self.critic_head.bias)
        # The student (an LSTM over its view, no random_z) steps through
        # kernel B2.
        self.fused_policy_step = (self.core.is_recurrent
                                  and not self.fused_projection
                                  and not random_z_dim)

    @property
    def is_recurrent(self) -> bool:
        return self.core.is_recurrent

    def initial_carry(self, batch_dims, device=None):
        return self.core.initial_carry(batch_dims, device)

    def _scalar_and_z(self, obs: dict) -> torch.Tensor:
        """(..., scalar_fc + random_z_dim): the embedded one-hot scalar
        (``direction``, else ``time_step``) and ``random_z``."""
        scalar = obs['direction'] if 'direction' in obs else obs['time_step']
        onehot = F.one_hot(scalar.long(), self.scalar_dim).float()
        parts = [self.scalar_embed(onehot)]
        if self.random_z_dim:
            parts.append(obs['random_z'].float())
        return torch.cat(parts, -1)

    def _embed(self, obs: dict) -> torch.Tensor:
        """(..., s, s, 3) uint8 image and the scalars → (..., embed)."""
        img = obs['image']
        lead = img.shape[:-3]
        x = img.reshape(-1, *img.shape[-3:]).float() / 10.0
        x = self.image_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = F.relu(x.reshape(*lead, -1))
        return torch.cat([x, self._scalar_and_z(obs)], -1)

    def _project(self, obs: dict, w: torch.Tensor) -> torch.Tensor:
        """(..., N) = embed @ w^T by kernel B4, the embed not stored."""
        img = obs['image']
        lead = img.shape[:-3]
        e = self._scalar_and_z(obs)
        out = teacher_proj(
            img.reshape(-1, *img.shape[-3:]).contiguous(),
            self.image_conv.weight, self.image_conv.bias,
            e.reshape(-1, e.shape[-1]).contiguous(), w)
        return out.reshape(*lead, -1)

    def _zx(self, obs: dict) -> torch.Tensor:
        """(..., 4H) input projection of the LSTM."""
        if not self.fused_projection:
            return self.core.w_i(self._embed(obs))
        return self._project(obs, self.core.w_i.weight)

    def _heads(self, core: torch.Tensor):
        logits = self.actor_head(self.actor_trunk(core))
        value = self.critic_head(self.critic_trunk(core)).squeeze(-1)
        return logits, value

    def _heads_of_embed(self, obs: dict):
        """Without a core: the trunks on the embed; for a wide embed their
        first layers are one B4 product with the stacked weights."""
        if not self.fused_projection:
            return self._heads(self._embed(obs))
        a0, c0 = self.actor_trunk[0], self.critic_trunk[0]
        y = self._project(obs, torch.cat([a0.weight, c0.weight]))
        y = torch.tanh(y + torch.cat([a0.bias, c0.bias]))
        ya, yc = y.split([a0.out_features, c0.out_features], -1)
        logits = self.actor_head(self.actor_trunk[2:](ya))
        value = self.critic_head(self.critic_trunk[2:](yc)).squeeze(-1)
        return logits, value

    def policy_weights(self) -> b2.PolicyWeights:
        """The student's weights for kernel B2 (made once a rollout)."""
        trunk = lambda t, head: (t[0].weight, t[0].bias, t[2].weight,
                                 t[2].bias, head.weight, head.bias)
        return b2.make_weights(
            self.image_conv.weight, self.image_conv.bias,
            self.scalar_embed.weight, self.scalar_embed.bias,
            self.core.w_i.weight, self.core.w_h.weight, self.core.w_h.bias,
            trunk(self.actor_trunk, self.actor_head),
            trunk(self.critic_trunk, self.critic_head))

    def step(self, obs: dict, carry, mask: torch.Tensor,
             weights: b2.PolicyWeights, mode: str, u=None,
             action=None) -> b2.PolicyOut:
        """The student's policy step by kernel B2 (``mode`` 'sample',
        'action', 'value' or 'forward'; see ``kernels/policy_step.py``)."""
        if action is not None:
            action = action.long().contiguous()
        return b2.policy_step(obs['image'].contiguous(), obs['direction'],
                              carry[0], carry[1], mask, weights, mode, u,
                              action)

    def forward(self, obs: dict, carry, mask: torch.Tensor):
        """One step: obs (B, ...), mask (B,) → (logits, value, carry)."""
        if self.fused_policy_step:
            out = self.step(obs, carry, mask, self.policy_weights(),
                            'forward')
            return out.logits, out.value, out.carry
        if not self.is_recurrent:
            logits, value = self._heads_of_embed(obs)
            return logits, value, carry
        carry, core = self.core.forward_zx(carry, self._zx(obs), mask)
        logits, value = self._heads(core)
        return logits, value, carry

    def sequence(self, obs: dict, carry, masks: torch.Tensor):
        """(T, B, ...) BPTT forward → (logits, values (T, B), carry)."""
        if not self.is_recurrent:
            logits, value = self._heads_of_embed(obs)
            return logits, value, carry
        carry, core = self.core.sequence_zx(carry, self._zx(obs), masks)
        logits, value = self._heads(core)
        return logits, value, carry
