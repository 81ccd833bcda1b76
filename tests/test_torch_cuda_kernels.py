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


@pytest.mark.parametrize('n', [1, 32, 1000])
@pytest.mark.parametrize('env_name', [
    'MultiGrid-GoalLastFewerBlocksAdversarial-v0', 'MultiGrid-Adversarial-v0',
    'MultiGrid-GoalLastVariableBlocksAdversarialEnv-v0',
    'MultiGrid-NoisyAdversarial-v0'])
def test_adversary_step_bit_exact(device, env_name, n):
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary as ma
    env = make_env(env_name)
    p = env.params
    g = torch.Generator(device=device).manual_seed(n)
    state, _ = env.reset(n, g, device)
    before = ma.step.launches
    for t in range(p.adversary_max_steps):
        loc = torch.randint(0, p.adversary_action_dim, (n,), generator=g,
                            device=device, dtype=torch.int32)
        u = torch.rand((n, 3), generator=g, device=device)
        got, want = ma.step(state, loc, u, p), ma.step_plain(state, loc, u, p)
        for k in want:
            assert torch.equal(got[k], want[k]), (t, k)
        state = state.replace(**{k: got[k] for k in ma.STATE_OUT})
    torch.cuda.synchronize()
    assert got['done'].all()
    assert ma.step.launches == before + p.adversary_max_steps


def test_shortest_path_bit_exact(device):
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary as ma
    g = torch.Generator(device=device).manual_seed(0)
    n = 2000
    grid = torch.where(torch.rand((n, 15, 15), generator=g, device=device)
                       < 0.35, 2, 1).to(torch.uint8)
    grid[:, 0] = grid[:, -1] = grid[:, :, 0] = grid[:, :, -1] = 2
    start = torch.randint(1, 14, (n, 2), generator=g, device=device,
                          dtype=torch.int32)
    goal = torch.randint(1, 14, (n, 2), generator=g, device=device,
                         dtype=torch.int32)
    start[::7] = -1
    got = ma.shortest_path(grid, start, goal, 170)
    want = ma.shortest_path_plain(grid, start, goal, 170)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < int(got[0].sum()) < n


@pytest.mark.parametrize('batch', [1, 32, 864])
def test_teacher_proj_and_gradients(device, batch):
    """Within rtol = atol = 1e-4: each output sums 21 692 fp32 products in
    another order than cuBLAS and cuDNN."""
    from dcd_isaac_tpu_torch.kernels.teacher_proj import (
        teacher_proj, teacher_proj_plain,
    )
    g = torch.Generator(device=device).manual_seed(batch)
    img = torch.randint(0, 11, (batch, 15, 15, 3), generator=g,
                        device=device, dtype=torch.uint8)
    shapes = ((128, 3, 3, 3), (128,), (batch, 60), (1024, 21692))
    scales = (0.15, 0.05, 1.0, 0.007)
    weights = [torch.randn(s, generator=g, device=device) * k
               for s, k in zip(shapes, scales)]
    g_out = torch.randn((batch, 1024), generator=g, device=device)
    results = []
    for fn in (teacher_proj, teacher_proj_plain):
        leaves = [w.clone().requires_grad_() for w in weights]
        out = fn(img, *leaves)
        results.append((out, torch.autograd.grad(out, leaves, g_out)))
    (out, grads), (want, want_grads) = results
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
