"""Environment names (the MultiGrid ones of dcd_isaac_tpu/envs/registry.py)."""

from __future__ import annotations

from .multigrid.adversarial import AdversarialMultiGrid
from .multigrid.core import MultiGridParams

_MG = {
    'MultiGrid-Adversarial-v0': dict(
        n_clutter=50, size=15, agent_view_size=5, max_steps=250),
    'MultiGrid-MiniAdversarial-v0': dict(
        n_clutter=7, size=6, agent_view_size=5, max_steps=50),
    'MultiGrid-NoisyAdversarial-v0': dict(
        n_clutter=50, size=15, max_steps=250, goal_noise=0.3),
    'MultiGrid-MediumAdversarial-v0': dict(
        n_clutter=30, size=10, agent_view_size=5, max_steps=200),
    'MultiGrid-GoalLastAdversarial-v0': dict(
        choose_goal_last=True, max_steps=250),
    'MultiGrid-GoalLastOpaqueWallsAdversarial-v0': dict(
        choose_goal_last=True, see_through_walls=False, max_steps=250),
    'MultiGrid-GoalLastFewerBlocksAdversarial-v0': dict(
        choose_goal_last=True, n_clutter=25, max_steps=250),
    'MultiGrid-GoalLastFewerBlocksAdversarial-EditWN-v0': dict(
        choose_goal_last=True, n_clutter=25, max_steps=250,
        editor_actions='walls_none'),
    'MultiGrid-GoalLastFewerBlocksAdversarial-EditWNG-v0': dict(
        choose_goal_last=True, n_clutter=25, max_steps=250,
        editor_actions='walls_none_goal'),
    'MultiGrid-GoalLastVariableBlocksAdversarialEnv-v0': dict(
        choose_goal_last=True, n_clutter=60, resample_n_clutter=True,
        max_steps=250),
    'MultiGrid-GoalLastVariableBlocksAdversarialEnv-Edit-v0': dict(
        choose_goal_last=True, n_clutter=60, resample_n_clutter=True,
        max_steps=250, editor_actions='walls_none_goal'),
    'MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0': dict(
        choose_goal_last=True, n_clutter=0, max_steps=250,
        editor_actions='walls_none_goal'),
    'MultiGrid-GoalLastFewerBlocksOpaqueWallsAdversarial-v0': dict(
        choose_goal_last=True, n_clutter=25, see_through_walls=False,
        max_steps=250),
    'MultiGrid-MiniGoalLastAdversarial-v0': dict(
        n_clutter=7, size=6, agent_view_size=5, max_steps=50,
        choose_goal_last=True),
    'MultiGrid-GoalLastAdversarialEnv30-v0': dict(
        choose_goal_last=True, n_clutter=30, max_steps=250),
    'MultiGrid-GoalLastAdversarialEnv60-v0': dict(
        choose_goal_last=True, n_clutter=60, max_steps=250),
}


def make_env(env_name: str) -> AdversarialMultiGrid:
    """env id → batched MultiGrid env; the other families wait."""
    if env_name in _MG:
        return AdversarialMultiGrid(MultiGridParams(**_MG[env_name]))
    if env_name.startswith(('BipedalWalker', 'CarRacing')):
        raise NotImplementedError(
            f'{env_name}: the walker and CarRacing families are not ported '
            'yet')
    raise ValueError(f'Unknown env {env_name}')


def env_family(env_name: str) -> str:
    if env_name.startswith('MultiGrid') or env_name.startswith('MiniGrid'):
        return 'multigrid'
    if env_name.startswith('BipedalWalker'):
        return 'walker'
    if env_name.startswith('CarRacing'):
        return 'carracing'
    raise ValueError(env_name)
