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


@pytest.mark.parametrize('batch, n_out', [(1, 1024), (32, 1024),
                                          (864, 1024), (864, 64)])
def test_teacher_proj_and_gradients(device, batch, n_out):
    """Within rtol = atol = 1e-4, at the recurrent teacher's N = 1024 and
    the teacher without a core's N = 64: each output sums 21 692 fp32
    products in another order than cuBLAS and cuDNN.  The conv gradients
    are held against the same computation in float64 with the kernels'
    ReLU' (chip_smoke.kernel_conv_grads: a pre-activation within rounding
    of zero may take the other side in cuDNN's order, and an fp32
    reference of these heavily cancelling sums is itself off by up to
    the tolerance)."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels.teacher_proj import (
        teacher_proj, teacher_proj_plain,
    )
    g = torch.Generator(device=device).manual_seed(batch)
    img = torch.randint(0, 11, (batch, 15, 15, 3), generator=g,
                        device=device, dtype=torch.uint8)
    shapes = ((128, 3, 3, 3), (128,), (batch, 60), (n_out, 21692))
    scales = (0.15, 0.05, 1.0, 0.007)
    weights = [torch.randn(s, generator=g, device=device) * k
               for s, k in zip(shapes, scales)]
    g_out = torch.randn((batch, n_out), generator=g, device=device)
    results = []
    for fn in (teacher_proj, teacher_proj_plain):
        leaves = [w.clone().requires_grad_() for w in weights]
        out = fn(img, *leaves)
        results.append((out, torch.autograd.grad(out, leaves, g_out)))
    (out, grads), (want, want_grads) = results
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    *ref_conv, _ = chip_smoke.kernel_conv_grads(img, *weights, g_out,
                                                exact=True)
    for a, b in zip(grads, (*ref_conv, *want_grads[2:])):
        torch.testing.assert_close(a.to(b.dtype), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('shape', [(256, 32), (52, 1024), (256, 1000),
                                   (1, 1), (16, 40, 32), (16, 200, 96)])
def test_lstm_seq_matches_plain(device, shape):
    """Kernel B3 at LSTM-256 with random mask resets, at the students' and
    the teacher's shapes, a ragged N and one row of one step, and at two
    narrower widths whose K does not split into whole 16-blocks per warp:
    outputs within 1e-5, gradients within atol + rtol * |ref| = 1e-4 +
    1e-4 * |ref| (each z sums H products in another order than cuBLAS;
    dW_h in float64 on both sides), one launch a pass, and two runs
    bit-identical."""
    from dcd_isaac_tpu_torch.kernels.lstm_seq import (
        lstm_seq, lstm_seq_plain_backward, lstm_seq_plain_forward,
    )
    from dcd_isaac_tpu_torch.models.common import RNNCore
    T, N, H = (*shape, 256)[:3]
    g = torch.Generator(device=device).manual_seed(T + N)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    masks = (torch.rand((T, N), generator=g, device=device) > 0.05).float()
    masks[0, ::2] = 0.0
    core = RNNCore(4, H, generator=torch.Generator().manual_seed(T))
    x = dict(zx=rn(T, N, 4 * H), masks=masks,
             w_h=core.w_h.weight.detach().to(device), b=rn(4 * H) * 0.1,
             c0=rn(N, H), h0=rn(N, H))
    g_h, g_c = rn(T, N, H), rn(N, H)
    names = ('zx', 'w_h', 'b', 'c0', 'h0')
    runs = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_(k != 'masks')
                  for k, v in x.items()}
        before = (lstm_seq.launches, lstm_seq.backward_launches)
        h_all, (c_T, _) = lstm_seq(*leaves.values())
        grads = torch.autograd.grad((h_all, c_T),
                                    [leaves[k] for k in names], (g_h, g_c))
        torch.cuda.synchronize()
        # one launch forward, one backward (which also gives d(h0))
        assert (lstm_seq.launches, lstm_seq.backward_launches) == (
            before[0] + 2, before[1] + 1)
        runs.append((h_all.detach(), c_T.detach(), grads))
    for a, b in zip(runs[0][:2] + runs[0][2], runs[1][:2] + runs[1][2]):
        assert torch.equal(a, b)
    h_all, c_T, grads = runs[0]
    with torch.no_grad():
        want_h, want_c, (want_cT, _) = lstm_seq_plain_forward(**x)
        want_grads = lstm_seq_plain_backward(g_h, g_c, *x.values(), want_h,
                                             want_c)
    torch.testing.assert_close(h_all, want_h, atol=1e-5, rtol=0)
    torch.testing.assert_close(c_T, want_cT, atol=1e-5, rtol=0)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_lstm_seq_wide_after_narrow(device):
    """B3 at H = 32, then at H = 256 in the same process: a plan made for a
    narrower H must not lower the shared memory a wider launch may take
    (the smoke's CPU sequences run H = 32 before its H = 256 cycles)."""
    from dcd_isaac_tpu_torch.kernels.lstm_seq import (
        lstm_seq, lstm_seq_plain_forward,
    )
    g = torch.Generator(device=device).manual_seed(7)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    for T, N, H in ((4, 40, 32), (4, 1000, 256), (4, 40, 32), (4, 40, 256)):
        masks = torch.ones((T, N), device=device)
        x = dict(zx=rn(T, N, 4 * H), masks=masks, w_h=rn(4 * H, H) * 0.05,
                 b=rn(4 * H) * 0.1, c0=rn(N, H), h0=rn(N, H))
        h_all, (c_T, _) = lstm_seq(*x.values())
        want_h, _, (want_cT, _) = lstm_seq_plain_forward(**x)
        torch.testing.assert_close(h_all, want_h, atol=1e-5, rtol=0)
        torch.testing.assert_close(c_T, want_cT, atol=1e-5, rtol=0)


@pytest.mark.parametrize('clip_value_loss', [True, False])
@pytest.mark.parametrize('rows,actions', [(8192, 7), (2097152, 7),
                                          (425984, 169)])
def test_ppo_loss_matches_plain_and_repeats(device, rows, actions,
                                            clip_value_loss):
    """Kernel B7 at the students' 7 actions and the teacher's 169: the
    means within 1e-6 relative of the twin in float64; dlogits and dvalues
    within 1e-5 of the largest entry of the twin's backward plus 1e-5
    relative (the loss is a mean, so every entry scales as 1/R and a fixed
    atol would pass a backward that writes zeros); bit-identical over two
    runs; the advantage normalisation within 1e-6."""
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        normalize_advantages, normalize_advantages_plain, ppo_loss,
        ppo_loss_plain, ppo_loss_plain_backward,
    )
    from dcd_isaac_tpu_torch.models.distributions import categorical_log_prob
    R, A = rows, actions
    g = torch.Generator(device=device).manual_seed(R)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    logits, values = rn(R, A), rn(R)
    acts = torch.randint(0, A, (R,), generator=g, device=device)
    tie = torch.rand((R,), generator=g, device=device) < 0.25
    old_lp = torch.where(tie, categorical_log_prob(logits, acts),
                         rn(R) * 0.3 - 2.0)
    old_v = torch.where(tie, values, values + rn(R) * 0.3)
    data = (logits, values, acts, old_lp, old_v, values + rn(R), rn(R))
    cfg = (0.2, clip_value_loss, 0.5, 0.01)
    runs = []
    before = (ppo_loss.launches, ppo_loss.backward_launches,
              normalize_advantages.launches)
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in data[:2]]
        out = ppo_loss(*leaves, *data[2:], *cfg)
        runs.append((torch.stack(out).detach(),
                     *torch.autograd.grad(out[0], leaves)))
    # two kernels a forward pass (rows, then the fold), one a backward
    assert (ppo_loss.launches, ppo_loss.backward_launches) == (
        before[0] + 6, before[1] + 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    wide = [t.double() if t.is_floating_point() else t for t in data]
    torch.testing.assert_close(runs[0][0].double(),
                               torch.stack(ppo_loss_plain(*wide, *cfg)),
                               rtol=1e-6, atol=1e-9)
    upstream = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    for a, b in zip(runs[0][1:],
                    ppo_loss_plain_backward(upstream, *data, *cfg)):
        scale = float(b.abs().max())
        assert scale > 0
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=1e-5)
    adv = normalize_advantages(data[5], data[1])
    assert normalize_advantages.launches == before[2] + 2
    torch.testing.assert_close(
        adv.double(), normalize_advantages_plain(data[5].double(),
                                                 data[1].double()),
        atol=1e-6, rtol=1e-6)


# Kernels B8 and B9: the checks are chip_smoke.py's, at more shapes.

@pytest.mark.parametrize('strategy', [
    'grounded_signed_value_loss', 'positive_value_loss', 'value_l1',
    'one_step_td_error', 'uniform'])
@pytest.mark.parametrize('shape', [(256, 32, 4000), (16, 8, 64),
                                   (64, 1024, 300)])
def test_plr_score_fold_matches_plain_and_repeats(device, shape, strategy):
    """Kernel B8 (a): scores, grounded values and staged scores within 1e-6
    of the twin, unseen, staleness and staged counts exact, two runs
    bit-identical; one launch a fold."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import plr as pk
    before = pk.score_fold.launches
    out = chip_smoke.check_plr_fold(*shape, device, strategy)
    torch.cuda.synchronize()
    assert pk.score_fold.launches == before + 2
    assert out['seeds_scored'] > 0 and out['staged'] > 0


@pytest.mark.parametrize('transforms', [
    ('rank', 0.1, 'power', 0.3), ('rank', 0.3, 'rank', 0.3),
    ('rank', 1.0, 'power', 0.3),
    ('power', 0.3, 'power', 0.0), ('constant', 1.0, 'power', 0.3)])
@pytest.mark.parametrize('S', [64, 4000, 5000])
def test_plr_sample_weights_match_plain(device, S, transforms):
    """Kernel B8 (b) within a few ulps of each of the twin's weights
    (chip_smoke.WEIGHT_RTOL), identical over two runs, at buffer sizes
    below, at and above the block's 1024 threads."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import plr as pk
    t, temp, st, c = transforms
    before = pk.sample_weights.launches
    chip_smoke.check_plr_weights(S, device, score_transform=t,
                                 temperature=temp, staleness_transform=st,
                                 staleness_coef=c)
    assert pk.sample_weights.launches == before + 2


@pytest.mark.parametrize('case', [
    (4000, 32, 0.0, {}), (4000, 32, 0.5, {}), (4000, 32, 1.0, {}),
    (64, 8, 0.97, {}), (4000, 2000, 0.7, {}),
    (4000, 32, 0.5, dict(seed_buffer_priority='score')),
    (4000, 32, 0.5, dict(dedup=False))])
def test_plr_promote_matches_plain(device, case):
    """Kernel B8 (c): levels, ids, masks and counters exact, scores within
    1e-6, bit-identical over two runs; two launches (hash, promotion),
    one without the dedup."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import plr as pk
    S, N, filled, kw = case
    before = pk.promote.launches
    chip_smoke.check_plr_promote(S, N, device, filled, **kw)
    assert pk.promote.launches == before + (2 if kw.get('dedup', True)
                                            else 1) * 2


def test_multigrid_edit_bit_exact(device):
    """Kernel B9: mutate (5 and 40 edits, every editor action set) and
    reset_random (four env variants) bit-exact at N = 32 and 4096."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import multigrid_edit as me
    before = (me.mutate.launches, me.reset_random.launches)
    chip_smoke.check_multigrid_edit(device)
    torch.cuda.synchronize()
    n_env = len(chip_smoke.EDIT_ENVS)
    # reset_random: the check's own, then the state's for the mutations
    assert (me.mutate.launches, me.reset_random.launches) == (
        before[0] + 4 * n_env, before[1] + 4 * n_env)


# The walker's kernels: the checks are chip_smoke.py's.

def test_walker_terrain_bit_exact(device):
    """Kernel B11: the heightfield, boxes, box count and bodies of 1024
    levels each from the full, easy and POET ranges and the five terrain
    kinds, bit for bit against the twins; one launch a batch."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import walker_terrain
    before = walker_terrain.generate.launches
    out = chip_smoke.check_walker_terrain(device)
    torch.cuda.synchronize()
    assert walker_terrain.generate.launches == before + 4
    assert out['max_abs_err'] == 0.0


@pytest.mark.parametrize('n', [16, 64, 512])
def test_walker_step_matches_plain(device, n):
    """Kernel B10 one step at a time from 120 states of a random walk,
    some of them on boxes (chip_smoke.WALKER_STEP_ATOL on floats, flags
    exact); one launch a step, and B11 and B10 again for each reset."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import walker_step
    before = walker_step.step.launches
    out = chip_smoke.check_walker_step(n, 120, device)
    torch.cuda.synchronize()
    # 120 steps, and the first step of the levels' reset
    assert walker_step.step.launches == before + 121
    assert out['foot_contacts'] > 0 and out['episodes_ended'] > 0
    assert out['box_contacts'] > 0


@pytest.mark.parametrize('clip_value_loss', [True, False])
@pytest.mark.parametrize('rows', [1024, 32768])
def test_ppo_loss_gaussian_matches_plain_and_repeats(device, rows,
                                                     clip_value_loss):
    """Kernel B7's Gaussian branch at the walker's minibatch and rollout:
    means 1e-6 relative, gradients within 1e-5 of the twin's largest entry
    plus 1e-5 relative, bit-identical runs; two launches a forward pass
    (rows, fold) and two a backward pass (rows, the log-std's fold)."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels.ppo_loss import ppo_loss_gaussian
    before = (ppo_loss_gaussian.launches,
              ppo_loss_gaussian.backward_launches)
    chip_smoke.check_ppo_loss_gaussian(rows, clip_value_loss, device)
    assert (ppo_loss_gaussian.launches,
            ppo_loss_gaussian.backward_launches) == (before[0] + 8,
                                                     before[1] + 4)


def test_plr_promote_float_levels(device):
    """Kernel B8 (c) with the walker's float levels: exact against the
    twin, duplicates folded by the value-cast hash."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import plr as pk
    before = pk.promote.launches
    out = chip_smoke.check_plr_promote_float(device)
    assert pk.promote.launches == before + 8
    assert out['max_abs_err'] == 0.0


# CarRacing's kernels: the checks are chip_smoke.py's, at more shapes.
@pytest.mark.parametrize('n', [1, 37, 4096])
def test_carracing_track_bit_exact(device, n):
    """Kernel B13b (track build, start tile, car) against
    ``build_level_plain`` bit for bit, n in [3, 12], start set and not."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import carracing_track
    before = carracing_track.build.launches
    out = chip_smoke.check_carracing_track(device, n)
    torch.cuda.synchronize()
    assert out['max_abs_err'] == 0.0
    assert carracing_track.build.launches > before


@pytest.mark.parametrize('tracks,cars', [(1, 3), (8, 64)])
def test_carracing_render_bit_exact(device, tracks, cars):
    """Kernel B12 against ``stack_frames_plain`` bit for bit: stack shift
    and reset, t = 0, 0.5, 2, RGB and crop + grayscale."""
    import chip_smoke
    out = chip_smoke.check_carracing_render(device, tracks, cars)
    assert out['max_abs_err'] == 0.0


@pytest.mark.parametrize('sparse', [False, True])
def test_carracing_step_matches_plain(device, sparse):
    """Kernel B13a against ``step_dynamics_plain`` one control step at a
    time (chip_smoke.CR_STEP_TOL on floats, the rest exact)."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels import carracing_step
    before = carracing_step.step.launches
    out = chip_smoke.check_carracing_step(device, 40 if sparse else 125,
                                          sparse)
    assert out['max_abs_err'] <= chip_smoke.CR_STEP_TOL
    assert carracing_step.step.launches == before + out['steps']


@pytest.mark.parametrize('rows', [1, 500, 2000, 70_000])
@pytest.mark.parametrize('clip_value_loss', [True, False])
def test_ppo_loss_beta_matches_plain_and_repeats(device, rows,
                                                 clip_value_loss):
    """Kernel B7's Beta branch: the means within 1e-6 relative of the
    float64 twin, the gradients at B7's tolerance, identical over two
    runs."""
    import chip_smoke
    chip_smoke.check_ppo_loss_beta(rows, clip_value_loss, device)


@pytest.mark.parametrize('batch', [1, 32, 2049, 8192])
def test_policy_step_matches_plain(device, batch):
    """Kernel B2 in its four modes against the twin, at
    chip_smoke.check_policy_step's tolerance (1e-5 relative; the sampled
    actions equal away from a CDF entry); one launch a mode."""
    import chip_smoke
    from dcd_isaac_tpu_torch.kernels.policy_step import policy_step
    before = policy_step.launches
    chip_smoke.check_policy_step(batch, device)
    assert policy_step.launches == before + 4


@pytest.mark.parametrize('batch,n_out', [(1, 64), (864, 64), (864, 1024),
                                         (1664, 1024)])
def test_teacher_proj_backward_matches_plain_and_repeats(device, batch,
                                                         n_out):
    """Kernel B4's backward against the chunked twin at
    chip_smoke.check_teacher_proj_backward's tolerance (1e-5 of the
    largest entry plus 1e-5 relative), identical over two runs."""
    import chip_smoke
    chip_smoke.check_teacher_proj_backward(batch, n_out, device)
