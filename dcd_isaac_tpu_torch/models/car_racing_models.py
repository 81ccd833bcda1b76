"""CarRacing student network (port of dcd_isaac_tpu/models/
car_racing_models.py:30-123).

Six VALID convolutions with strides over the stacked frames (96 × 96, or
84 × 84 with ``crop``), a 100-wide ReLU actor layer with α, β = 1 +
softplus heads (one Beta per action: steer, gas, brake), a 100-wide ReLU
critic layer and the value head.  The convs and fcs are plain
``nn.Conv2d``/``nn.Linear`` (cuDNN and cuBLAS with TF32 off, fp32): the JAX
package computes them as plain flax layers (kernel B14, to port by hand
once the CarRacing phase split says so).  The frames come in NHWC and the
conv stack's output is flattened in (h, w, c) order, as flax does.
``sample_action`` returns the action scaled to the env's bounds and the
log-prob of the raw Beta sample; ``unscale`` maps actions back to [0, 1].
The CarRacing teacher (``CarRacingAdversaryNetwork``) waits for its slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import orthogonal_
from .distributions import beta_log_prob, beta_sample

# (filters, kernel, stride) of the six convs (car_racing_models.py:53-58)
CONV_SPECS = ((8, 4, 2), (16, 3, 2), (32, 3, 2), (64, 3, 2), (128, 3, 1),
              (256, 3, 1))
CROP_SPECS = ((8, 2, 2), (16, 2, 2), (32, 2, 2), (64, 2, 2), (128, 3, 1),
              (256, 3, 1))


def _dense(fan_in, fan_out, gain, generator):
    lin = nn.Linear(fan_in, fan_out)
    orthogonal_(lin.weight, gain, generator)
    nn.init.zeros_(lin.bias)
    return lin


class CarRacingNetwork(nn.Module):
    """Student CNN + Beta policy (car_racing_models.py:30-123)."""

    dist_type = 'beta'
    # Kernel B2 steps MultiGrid's students only.
    fused_policy_step = False

    def __init__(self, obs_shape=(96, 96, 12), action_dim: int = 3,
                 hidden_size: int = 100, crop: bool = False,
                 action_low=(-1.0, 0.0, 0.0), action_high=(1.0, 1.0, 1.0),
                 generator=None):
        super().__init__()
        h, w, c = obs_shape
        convs = []
        for f, k, s in (CROP_SPECS if crop else CONV_SPECS):
            conv = nn.Conv2d(c, f, k, stride=s)
            nn.init.xavier_uniform_(conv.weight, generator=generator)
            nn.init.constant_(conv.bias, 0.1)
            convs.append(conv)
            c, h, w = f, (h - k) // s + 1, (w - k) // s + 1
        self.convs = nn.ModuleList(convs)
        flat = c * h * w
        g = math.sqrt(2)
        self.actor_fc = _dense(flat, hidden_size, g, generator)
        self.fc_alpha = _dense(hidden_size, action_dim, g, generator)
        self.fc_beta = _dense(hidden_size, action_dim, g, generator)
        self.critic_fc = _dense(flat, hidden_size, g, generator)
        self.critic_head = _dense(hidden_size, 1, 1.0, generator)
        self.register_buffer('action_low', torch.tensor(action_low),
                             persistent=False)
        self.register_buffer('action_range', torch.tensor(action_high)
                             - torch.tensor(action_low), persistent=False)

    @property
    def is_recurrent(self) -> bool:
        return False

    def initial_carry(self, batch_dims, device=None):
        return ()

    def _embed(self, frames: torch.Tensor) -> torch.Tensor:
        lead = frames.shape[:-3]
        x = frames.reshape(-1, *frames.shape[-3:]).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)

    def forward(self, obs: dict, carry=(), mask=None):
        """obs ``{'obs': (..., H, W, C)}`` → ({'alpha', 'beta'} (..., 3),
        value (...), carry)."""
        x = self._embed(obs['obs'])
        ha = F.relu(self.actor_fc(x))
        alpha = 1.0 + F.softplus(self.fc_alpha(ha))
        beta = 1.0 + F.softplus(self.fc_beta(ha))
        value = self.critic_head(F.relu(self.critic_fc(x))).squeeze(-1)
        return {'alpha': alpha, 'beta': beta}, value, carry

    def sequence(self, obs: dict, carry=(), masks=None):
        return self(obs, carry, masks)

    # --- distribution protocol ----------------------------------------------
    def scale(self, u: torch.Tensor) -> torch.Tensor:
        return u * self.action_range + self.action_low

    def unscale(self, actions: torch.Tensor) -> torch.Tensor:
        return (actions - self.action_low) / self.action_range

    def sample_action(self, out: dict, generator: torch.Generator):
        """(scaled action, log-prob of the raw Beta sample)."""
        u = beta_sample(out['alpha'], out['beta'], generator)
        return self.scale(u), beta_log_prob(out['alpha'], out['beta'], u)

    def log_prob(self, out: dict, actions: torch.Tensor) -> torch.Tensor:
        return beta_log_prob(out['alpha'], out['beta'], self.unscale(actions))


def make_carracing_model(args, env, agent_type: str = 'agent',
                         generator: torch.Generator = None):
    """The CarRacing student (car_racing_models.py:323-338); the teacher
    waits for its slice."""
    if agent_type == 'adversary_env':
        raise NotImplementedError(
            'the CarRacing teacher (CarRacingAdversaryNetwork: PAIRED, '
            'REPAIRED) is not ported yet; it waits for its slice')
    return CarRacingNetwork(obs_shape=env.obs_shapes,
                            action_dim=env.num_actions,
                            crop=args.crop_frame, generator=generator)
