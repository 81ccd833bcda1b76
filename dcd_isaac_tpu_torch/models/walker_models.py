"""BipedalWalker student network (port of dcd_isaac_tpu/models/
walker_models.py:23-101, :165-173).

Twin 64-64 tanh trunks (actor and critic) over the 24-d observation, a
value head, and a diagonal Gaussian over the 4 motor torques whose
log-std is a free parameter, zero at init.  The student is not recurrent:
``initial_carry`` is an empty tuple and ``sequence`` is the forward over
(T, B) rows.  Its outputs are ``{'mean': (..., 4), 'log_std': (4,)}``;
the log-std is the parameter itself (JAX broadcasts it to the mean's
shape), so the PPO loss (kernel B7) takes it as one (4,) vector.

The walker teacher (``WalkerAdversaryPolicy``) and the GRU core wait for
their slices (ROADMAP queue A).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .common import orthogonal_


def _dense(fan_in, fan_out, gain, generator):
    lin = nn.Linear(fan_in, fan_out)
    orthogonal_(lin.weight, gain, generator)
    nn.init.zeros_(lin.bias)
    return lin


class DiagGaussianHead(nn.Module):
    """Mean (Dense, orthogonal gain 1) and a state-independent log-std."""

    def __init__(self, num_inputs: int, num_outputs: int, generator=None):
        super().__init__()
        self.mean = _dense(num_inputs, num_outputs, 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(num_outputs))

    def forward(self, x):
        return {'mean': self.mean(x), 'log_std': self.log_std}


class WalkerStudentPolicy(nn.Module):
    """MLPBase + DiagGaussian (walker_models.py:113-167)."""

    dist_type = 'normal'
    # Kernel B2 steps MultiGrid's students only.
    fused_policy_step = False

    def __init__(self, obs_dim: int = 24, action_dim: int = 4,
                 hidden_size: int = 64, generator=None):
        super().__init__()
        h, g = hidden_size, math.sqrt(2)
        self.actor1 = _dense(obs_dim, h, g, generator)
        self.actor2 = _dense(h, h, g, generator)
        self.critic1 = _dense(obs_dim, h, g, generator)
        self.critic2 = _dense(h, h, g, generator)
        self.critic_head = _dense(h, 1, 1.0, generator)
        self.dist = DiagGaussianHead(h, action_dim, generator)

    @property
    def is_recurrent(self) -> bool:
        return False

    def initial_carry(self, batch_dims, device=None):
        return ()

    def forward(self, obs: dict, carry=(), mask=None):
        """obs ``{'obs': (..., 24)}`` → (dist params, value (...), carry)."""
        x = obs['obs']
        ha = torch.tanh(self.actor2(torch.tanh(self.actor1(x))))
        hc = torch.tanh(self.critic2(torch.tanh(self.critic1(x))))
        value = self.critic_head(hc).squeeze(-1)
        return self.dist(ha), value, carry

    def sequence(self, obs: dict, carry=(), masks=None):
        return self(obs, carry, masks)


def make_walker_model(args, env, agent_type: str = 'agent',
                      generator: torch.Generator = None):
    """The walker student (walker_models.py:165-173): an MLP, as in the
    JAX package unless ``--recurrent_arch gru`` (the GRU waits for its
    slice, and so does the teacher)."""
    if agent_type == 'adversary_env':
        raise NotImplementedError(
            'the walker teacher (WalkerAdversaryPolicy: PAIRED, minimax) is '
            'not ported yet')
    if args.recurrent_agent and args.recurrent_arch == 'gru':
        raise NotImplementedError(
            'a recurrent walker student (the GRU core) is not ported yet')
    return WalkerStudentPolicy(obs_dim=env.obs_shapes[0],
                               action_dim=env.num_actions,
                               generator=generator)
