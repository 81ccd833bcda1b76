"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; without a card each test skips.  On a machine with one
(and without JAX, whose conftest this file does not need):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from dcd_isaac_tpu_torch import resolve_device
    return resolve_device('cuda')


@pytest.mark.parametrize('n', [1, 32, 1000])
def test_multigrid_step_and_obs_bit_exact(device, n):
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels.multigrid_step import (
        multigrid_obs, multigrid_step, obs_plain, step_plain,
    )
    env = make_env('MultiGrid-GoalLastFewerBlocksAdversarial-v0')
    p = env.params
    g = torch.Generator(device=device).manual_seed(n)
    start, _ = env.reset_random(n, g, device)
    state = start
    before = multigrid_step.launches
    for _ in range(60):
        action = torch.randint(0, 7, (n,), generator=g, device=device).int()
        args = (state.grid, state.agent_pos, state.agent_dir,
                state.step_count, state.agent_done, action,
                p.agent_view_size, p.max_steps)
        got, want = multigrid_step(*args), step_plain(*args)
        for a, b in zip(got, want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)
        pos, d, sc, agent_done, image, _, done, _ = got
        state = start.where(done, state.replace(
            agent_pos=pos, agent_dir=d, step_count=sc, agent_done=agent_done))
        assert torch.equal(
            multigrid_obs(state.grid, state.agent_pos, state.agent_dir, 5),
            obs_plain(state.grid, state.agent_pos, state.agent_dir, 5))
    torch.cuda.synchronize()
    assert multigrid_step.launches == before + 60


@pytest.mark.parametrize('proper', [True, False])
@pytest.mark.parametrize('shape', [(1, 1), (256, 32), (33, 300)])
def test_gae_matches_plain(device, shape, proper):
    from dcd_isaac_tpu_torch.kernels.gae import gae, gae_plain
    T, N = shape
    g = torch.Generator(device=device).manual_seed(T * N)
    r = lambda *s: torch.rand(s, generator=g, device=device)
    x = dict(rewards=r(T, N), values=r(T, N) - 0.5, dones=r(T, N) < 0.1,
             bad_masks=(r(T, N) < 0.5).float(), trunc_values=r(T, N),
             next_value=r(N))
    kw = dict(gamma=0.995, gae_lambda=0.95, use_proper_time_limits=proper)
    torch.testing.assert_close(gae(**x, **kw), gae_plain(**x, **kw),
                               atol=1e-5, rtol=1e-5)
