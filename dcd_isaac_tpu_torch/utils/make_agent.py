"""Model factory (port of dcd_isaac_tpu/utils/make_agent.py), student only."""

from __future__ import annotations

import torch

from ..envs.registry import env_family
from ..models.multigrid_models import MultigridNetwork


def make_model(args, env, agent_type: str = 'agent',
               generator: torch.Generator = None) -> MultigridNetwork:
    """The MultiGrid student network (utils/make_agent.py:45-56)."""
    family = env_family(args.env_name)
    if family != 'multigrid':
        raise NotImplementedError(f'{family} models are not ported yet')
    if agent_type != 'agent':
        raise NotImplementedError(
            f'{agent_type} models come with the PAIRED slice')
    if not args.recurrent_agent:
        raise NotImplementedError(
            'a non-recurrent student is not ported yet')
    if args.use_global_critic or args.use_global_policy:
        raise NotImplementedError(
            'MultigridGlobalCriticNetwork is not ported yet')
    return MultigridNetwork(
        num_actions=env.num_actions,
        scalar_fc=5,
        scalar_dim=4,
        view_size=env.params.agent_view_size,
        recurrent_arch=args.recurrent_arch,
        recurrent_hidden_size=args.recurrent_hidden_size,
        generator=generator)
