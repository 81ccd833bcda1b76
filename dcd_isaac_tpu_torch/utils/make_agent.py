"""Model factory (port of dcd_isaac_tpu/utils/make_agent.py:15-66).

The MultiGrid roles: the student ``agent``, the PAIRED antagonist
``adversary_agent`` (a second student) and the teacher ``adversary_env``
(with an LSTM, or none with ``--recurrent_adversary_env false``);
the walker's student (``models/walker_models.py``) and CarRacing's
(``models/car_racing_models.py``).
"""

from __future__ import annotations

import torch

from ..envs.registry import env_family
from ..models.car_racing_models import make_carracing_model
from ..models.multigrid_models import MultigridNetwork
from ..models.walker_models import make_walker_model


def make_model(args, env, agent_type: str = 'agent',
               generator: torch.Generator = None) -> torch.nn.Module:
    """The network of a role (utils/make_agent.py:27-56)."""
    family = env_family(args.env_name)
    if family == 'walker':
        return make_walker_model(args, env, agent_type, generator)
    if family == 'carracing':
        return make_carracing_model(args, env, agent_type, generator)
    if family != 'multigrid':
        raise NotImplementedError(f'{family} models are not ported yet')
    if agent_type == 'adversary_env':
        # --recurrent_adversary_env false: no core, the trunks on the embed
        p = env.params
        return MultigridNetwork(
            num_actions=env.adversary_num_actions,
            conv_filters=128,
            scalar_fc=10,
            scalar_dim=p.adversary_max_steps + 1,
            view_size=p.width,
            random_z_dim=p.random_z_dim,
            recurrent_arch=(args.recurrent_arch
                            if args.recurrent_adversary_env else 'none'),
            recurrent_hidden_size=args.recurrent_hidden_size,
            generator=generator)
    if agent_type not in ('agent', 'adversary_agent'):
        raise ValueError(f'unknown agent type {agent_type!r}')
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


def make_all_models(args, env, generator: torch.Generator = None) -> dict:
    """The models ``--ued_algo`` trains, by role (make_agent.py:60-66)."""
    models = {'agent': make_model(args, env, 'agent', generator)}
    if args.ued_algo in ('paired', 'flexible_paired'):
        models['adversary_agent'] = make_model(
            args, env, 'adversary_agent', generator)
    if args.ued_algo in ('paired', 'flexible_paired', 'minimax'):
        models['adversary_env'] = make_model(
            args, env, 'adversary_env', generator)
    return models
