"""CarRacing's training path of the port against the JAX package, on the
CPU: whole DR, PLR⊥ and PLR cycles (generate and replay) at a small size
(N = 4, T = 8, 2 epochs of 2 minibatches, 5-step episodes), and the
training entry point at the three configurations' flags.

Randomness is injected, never shared: numpy draws the levels, the
mid-rollout reset levels and the action scripts (scaled actions; both
sides take the log-prob of the unscaled action), the JAX package draws the
replay levels and PPO permutations and both sides get them.  The JAX env,
model and rollout run through ``no_fma`` (``test_torch_walker.py``), and
(fixture ``same_arithmetic``) the JAX Bézier sum and nearest-point cross
term are computed elementwise in the port's order instead of as dot
products: otherwise a few pixels near a class boundary differ
(``test_torch_carracing.py`` bounds them), and one such pixel moves a
value of the random CNN by ~1e-3, which Adam's sign-like first steps
carry into the weights far beyond 1e-4.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcd_isaac_tpu.envs.carracing.bezier as jax_bezier
import dcd_isaac_tpu.envs.carracing.track as jax_track
from dcd_isaac_tpu.algos import ppo as jax_ppo
from dcd_isaac_tpu.algos import rollout as jax_rollout
from dcd_isaac_tpu.algos.storage import compute_gae as jax_compute_gae
from dcd_isaac_tpu.envs.carracing import AdversarialCarRacing as JaxCarRacing
from dcd_isaac_tpu.envs.carracing import CarRacingUEDParams as JaxParams
from dcd_isaac_tpu.envs.carracing.env import (
    CarRacingConfig as JaxCarRacingConfig,
)
from dcd_isaac_tpu.level_replay import plr as jplr
from dcd_isaac_tpu.models import distributions as jdist
from dcd_isaac_tpu.models.car_racing_models import (
    CarRacingNetwork as JaxNetwork,
)
from dcd_isaac_tpu.utils.geo_complexity import batch_track_complexity
from dcd_isaac_tpu_torch import train
from dcd_isaac_tpu_torch.arguments import parser
from dcd_isaac_tpu_torch.convert import from_flax_carracing
from dcd_isaac_tpu_torch.envs import registry
from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
    AdversarialCarRacing, CarRacingUEDParams,
)
from dcd_isaac_tpu_torch.envs.carracing.env import CarRacingConfig
from dcd_isaac_tpu_torch.models.car_racing_models import CarRacingNetwork
from dcd_isaac_tpu_torch.runner.adversarial_runner import AdversarialRunner
from test_torch_algos import rollout_keys
from test_torch_walker import no_fma
from test_torch_walker_cycle import assert_buffers_close

T, N, S = 8, 4, 16
MAX_INNER = 40          # 5 control steps an episode
# cr_dr.json's student settings at the test's sizes
DR_FLAGS = [
    '--env_name', 'CarRacing-Bezier-Adversarial-v0',
    '--ued_algo', 'domain_randomization', '--num_processes', str(N),
    '--num_steps', str(T), '--ppo_epoch', '2', '--num_mini_batch', '2',
    '--grayscale', 'false', '--crop_frame', 'false',
    '--num_action_repeat', '8', '--frame_stack', '4',
    '--normalize_returns', 'true', '--use_popart', 'false',
    '--handle_timelimits', 'true', '--recurrent_agent', 'false',
    '--recurrent_adversary_env', 'false', '--recurrent_hidden_size', '1',
    '--lr', '3e-4', '--max_grad_norm', '0.5', '--gamma', '0.99',
    '--gae_lambda', '0.9', '--value_loss_coef', '0.5',
    '--entropy_coef', '0.0', '--clip_value_loss', 'false',
    '--clip_param', '0.2', '--reward_shaping', 'true', '--seed', '1']
PLR_FLAGS = DR_FLAGS + [
    '--use_plr', 'true', '--level_replay_strategy', 'positive_value_loss',
    '--level_replay_score_transform', 'power',
    '--level_replay_temperature', '1.0', '--staleness_coef', '0.7',
    '--level_replay_prob', '0.5', '--level_replay_rho', '0.5',
    '--level_replay_seed_buffer_size', str(S),
    '--log_replay_complexity', 'true']
ROBUST_PLR_FLAGS = PLR_FLAGS + ['--no_exploratory_grad_updates', 'true']
LOW = np.array([-1.0, 0.0, 0.0], np.float32)
RANGE = np.array([2.0, 1.0, 1.0], np.float32)

JENV = JaxCarRacing(JaxParams(cfg=JaxCarRacingConfig(
    max_inner_steps=MAX_INNER)))
JNET = JaxNetwork()
RO_CFG = jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True,
                                   normalize_returns_gamma=0.99)


def t(x):
    return torch.tensor(np.asarray(x))


def bezier_curve_elementwise(control4, num):
    """JAX ``bezier_curve`` (its own Bernstein table, bezier.py:26-29) with
    the einsum written out as the port's sum order."""
    t = jnp.linspace(0.0, 1.0, num)
    b = jnp.stack([
        (1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t), t ** 3,
    ], -1)  # (num, 4)
    c = control4[..., None, :, :]                     # (..., 1, 4, 2)
    return (((b[:, 0, None] * c[..., 0, :] + b[:, 1, None] * c[..., 1, :])
             + b[:, 2, None] * c[..., 2, :]) + b[:, 3, None] * c[..., 3, :])


def nearest_tile_elementwise(track, q):
    """JAX ``nearest_tile`` with the cross term elementwise, as the port's
    twin and kernels compute it."""
    q2 = q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
    px, py = track.points[:, 0], track.points[:, 1]
    p2 = px * px + py * py
    qp = q[..., 0, None] * px + q[..., 1, None] * py
    d2 = (q2[..., None] + p2) - 2.0 * qp
    d2 = jnp.where(track.valid, d2, jnp.inf)
    idx = jnp.argmin(d2, axis=-1)
    return idx, jnp.sqrt(jnp.maximum(jnp.min(d2, axis=-1), 0.0))


@pytest.fixture(autouse=True)
def same_arithmetic(monkeypatch):
    monkeypatch.setattr(jax_bezier, 'bezier_curve', bezier_curve_elementwise)
    monkeypatch.setattr(jax_track, 'nearest_tile', nearest_tile_elementwise)


def car_env():
    return AdversarialCarRacing(CarRacingUEDParams(cfg=CarRacingConfig(
        max_inner_steps=MAX_INNER)))


class ScriptedJaxCar:
    """The flax student whose action draw returns the script's (scaled)
    action of step t, t found from the step's action key, with the
    log-prob of the unscaled action; the script rides in the params."""
    dist_type = 'beta'
    is_recurrent = False

    def __init__(self, net):
        self.net = net

    def apply(self, params, *args, **kw):
        out, value, carry = self.net.apply(params['net'], *args, **kw)
        return ({**out, 'keys': params['keys'],
                 'actions': params['actions']}, value, carry)

    def initial_carry(self, batch_dims):
        return ()

    def sample_action(self, rng, out):
        t_ = jnp.argmax(jnp.all(out['keys'] == rng[None], axis=-1))
        a = out['actions'][t_]
        return a, jdist.beta_log_prob(out['alpha'], out['beta'],
                                      (a - LOW) / RANGE)


_COMPILED = {}


def compiled(name, make):
    if name not in _COMPILED:
        _COMPILED[name] = jax.jit(no_fma(make()))
    return _COMPILED[name]


def jax_rollout_fn():
    """The JAX student rollout of the scripted car, compiled once: each
    finished slot takes level ``table[i]`` and seed ``seeds[i]`` of its
    (step, slot) reset key i."""
    model = ScriptedJaxCar(JNET)

    def make():
        def fn(params, carry, reset_keys, table, seeds):
            def reset_fn(rng, state, seed):
                i = jnp.argmax(jnp.all(reset_keys == rng[None], -1))
                st, obs = JENV.reset_to_level(table[i])
                return st, obs, seeds[i]
            return jax_rollout.make_student_rollout(
                JENV, model, RO_CFG, reset_fn=reset_fn)(params, carry)
        return fn
    return compiled('rollout', make)


def jax_reset_to_level(levels):
    return compiled('reset_to_level', lambda: jax.vmap(JENV.reset_to_level))(
        jnp.asarray(levels))


def random_levels(rng, n, seed0=100):
    """n 12-point levels on the playfield (numpy (n, 28))."""
    lv = np.zeros((n, 28), np.float32)
    lv[:, :24] = rng.random((n, 24)) * (2000 / 6)
    lv[:, 24], lv[:, 25], lv[:, 26] = 12, -1, -1
    lv[:, 27] = seed0 + np.arange(n)
    return lv


def action_script(rng):
    a = rng.random((T, N, 3)).astype(np.float32)
    a[..., 0] = a[..., 0] * 2 - 1
    return a


def student_pair(seed=0):
    params = JNET.init(jax.random.PRNGKey(seed), jnp.zeros((N, 96, 96, 12)),
                       (), jnp.ones(N))
    net = CarRacingNetwork()
    net.load_state_dict(from_flax_carracing(jax.tree.map(np.asarray,
                                                         params)))
    return params, net


def assert_params_close(jax_params, net, atol):
    want = from_flax_carracing(jax.tree.map(np.asarray, jax_params))
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


class JaxSequence:
    """The runner's CarRacing cycles rebuilt from the JAX package's public
    functions: the student, a PLR buffer and VecNormalize's statistics
    carried across cycles."""

    def __init__(self, args, params):
        self.args = args
        self.cfg = jax_ppo.PPOConfig(
            clip_param=args.clip_param, ppo_epoch=args.ppo_epoch,
            num_mini_batch=args.num_mini_batch,
            value_loss_coef=args.value_loss_coef,
            entropy_coef=args.entropy_coef, lr=args.lr, eps=args.eps,
            max_grad_norm=args.max_grad_norm,
            clip_value_loss=args.clip_value_loss)
        self.state = jax_ppo.AgentTrainState(
            params=params,
            opt_state=jax_ppo.make_optimizer(self.cfg).init(params))
        self.plr_cfg = jplr.PLRConfig(
            capacity=S, num_actors=N, strategy=args.level_replay_strategy,
            score_transform=args.level_replay_score_transform,
            temperature=args.level_replay_temperature,
            rho=args.level_replay_rho, replay_prob=args.level_replay_prob,
            staleness_coef=args.staleness_coef, gamma=args.gamma)
        self.buf = jplr.init_plr(self.plr_cfg, (28,), jnp.float32)
        self.ret_rms = (jnp.zeros(N), jnp.float32(0.0), jnp.float32(1.0),
                        jnp.float32(1e-4))

    def phase(self, levels, seeds, actions, key, discard, plr=True,
              reset_table=None, reset_seeds=None):
        """Rollout, GAE, PLR fold, PPO update → (staged scores, counts,
        the update's stats, its row permutations)."""
        args = self.args
        r_ro, r_upd = jax.random.split(key)
        act_keys, reset_keys = rollout_keys(r_ro, T, N)
        st, obs = jax_reset_to_level(levels)
        carry = jax_rollout.initial_step_carry(
            JENV, JNET, st, obs, r_ro, level_seeds=seeds,
            ret_rms=self.ret_rms)
        params = {'net': self.state.params, 'keys': act_keys,
                  'actions': jnp.asarray(actions)}
        if reset_table is None:
            # the same level again (JAX _ro_same) through the one compiled
            # rollout: slot n of every step resets to level n
            reset_table = np.tile(np.asarray(levels), (T, 1))
            reset_seeds = np.tile(np.asarray(seeds), T)
        final, steps, next_value, ro = jax_rollout_fn()(
            params, carry, reset_keys, jnp.asarray(reset_table),
            jnp.asarray(reset_seeds, jnp.int32))
        self.ret_rms = (final.ret_accum, final.rms_mean, final.rms_var,
                        final.rms_count)
        returns = jax_compute_gae(steps, next_value, args.gamma,
                                  args.gae_lambda,
                                  use_proper_time_limits=True)
        st_s = st_c = None
        if plr:
            self.buf, st_s, st_c = jplr.update_with_rollout(
                self.buf, self.plr_cfg, steps, returns, steps.values)
        update = _COMPILED.setdefault(
            ('update', self.cfg), jax.jit(jax_ppo.make_ppo_update(
                JNET, self.cfg, N)))
        self.state, stats = update(self.state, steps, returns, (), r_upd,
                                   discard)
        perms = jax.vmap(lambda r: jax.random.permutation(r, T * N))(
            jax.random.split(r_upd, self.cfg.ppo_epoch))
        return st_s, st_c, stats, ro, torch.tensor(np.asarray(perms))

    def promote(self, levels, st_s, st_c):
        self.buf = jplr.promote_staged(self.buf, self.plr_cfg,
                                       jnp.asarray(levels), st_s, st_c)


def script(actions):
    return lambda out, k: torch.tensor(actions[k])


def assert_stats_close(stats, jstats):
    for k, j in (('agent_value_loss', 'value_loss'),
                 ('agent_pg_loss', 'action_loss'),
                 ('agent_dist_entropy', 'dist_entropy'),
                 ('agent_grad_norm', 'grad_norm')):
        np.testing.assert_allclose(stats[k], float(jstats[j]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_dr_cycle_matches_jax():
    """A DR cycle: a rollout whose finished episodes take new levels
    mid-rollout (injected), GAE with time-limit bootstrapping, VecNormalize
    and the flat PPO update: weights within 1e-4, update stats within
    1e-4, the track stats of the cycle's levels as the JAX package
    computes them, the VecNormalize statistics within 1e-5."""
    args = parser.parse_args(DR_FLAGS)
    params, net = student_pair(1)
    rng = np.random.default_rng(2)
    levels = random_levels(rng, N)
    table = random_levels(rng, T * N, seed0=500)
    acts = action_script(rng)
    ref = JaxSequence(args, params)
    _, _, jstats, jro, perms = ref.phase(
        levels, -np.ones(N, np.int32), acts, jax.random.PRNGKey(4),
        False, plr=False, reset_table=table,
        reset_seeds=-np.ones(T * N, np.int32))
    env = car_env()
    runner = AdversarialRunner(args, env, {'agent': net}, 'cpu')
    reset = lambda k, st, seeds: (*env.reset_to_level(
        t(table.reshape(T, N, 28)[k])), seeds)
    stats = runner.run(levels=t(levels), sample_action_fn=script(acts),
                       reset_fn=reset, perms={'agent': perms})
    assert_params_close(ref.state.params, net, atol=1e-4)
    assert_stats_close(stats, jstats)
    for a, b in zip(runner.ret_rms, ref.ret_rms):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert stats['episodes'] == int(np.asarray(jro['episode_count']).sum())
    assert stats['episodes'] >= N            # 5-step episodes in 8 steps
    jt, _ = jax_reset_to_level(levels)
    want = batch_track_complexity(np.asarray(jt.track.points),
                                  np.asarray(jt.track.valid))
    for k, v in want.items():
        np.testing.assert_allclose(stats['track_' + k], v, rtol=1e-4)


@pytest.mark.parametrize('robust', [True, False], ids=['robust_plr', 'plr'])
def test_plr_sequence_matches_jax(robust):
    """PLR⊥ (gradients of the generate cycle discarded) or PLR (kept): a
    generate cycle (levels staged and promoted into a 16-slot buffer) then
    a replay cycle (levels drawn from the buffer, mid-rollout replay
    resets, scores folded, a gradient step): the buffer's levels, ids and
    masks equal and its floats within 1e-5, the weights within 1e-4, the
    replay cycle's stats within 1e-4, its env stats 'plr_'-prefixed."""
    args = parser.parse_args(ROBUST_PLR_FLAGS if robust else PLR_FLAGS)
    params, net = student_pair(7)
    rng = np.random.default_rng(40)
    acts = [action_script(rng) for _ in range(2)]
    k_gen, k_rep, k_draw = jax.random.split(jax.random.PRNGKey(3), 3)
    ref = JaxSequence(args, params)
    levels0 = random_levels(rng, N)
    st_s, st_c, _, _, perms_gen = ref.phase(
        levels0, np.arange(N, dtype=np.int32) + S, acts[0], k_gen,
        discard=robust)
    ref.promote(levels0, st_s, st_c)
    assert int(np.asarray(ref.buf.filled).sum()) == N
    seeds, rep_levels, ref.buf = jplr.sample_replay_levels(
        ref.buf, ref.plr_cfg, k_draw, N)
    filled = np.flatnonzero(np.asarray(ref.buf.filled))
    reset_seeds = rng.choice(filled, (T, N)).astype(np.int32)
    table = np.asarray(ref.buf.levels)[reset_seeds.reshape(-1)]
    _, _, jstats, _, perms_rep = ref.phase(
        np.asarray(rep_levels), seeds, acts[1], k_rep, discard=False,
        reset_table=table, reset_seeds=reset_seeds.reshape(-1))

    runner = AdversarialRunner(args, car_env(), {'agent': net}, 'cpu')
    before = {k: v.clone() for k, v in net.state_dict().items()}
    s_gen = runner.run(levels=t(levels0), replay=False,
                       sample_action_fn=script(acts[0]),
                       perms={'agent': perms_gen})
    changed = any(not torch.equal(v, before[k])
                  for k, v in net.state_dict().items())
    assert changed != robust
    s_rep = runner.run(replay=True, replay_seeds=t(seeds),
                       replay_reset_seeds=lambda k: t(reset_seeds[k]),
                       sample_action_fn=script(acts[1]),
                       perms={'agent': perms_rep})
    assert_buffers_close(runner.plr_buffer, ref.buf)
    assert_params_close(ref.state.params, net, atol=1e-4)
    assert_stats_close(s_rep, jstats)
    assert (s_gen['level_replay'], s_rep['level_replay']) == (0, 1)
    assert 'track_complexity' in s_gen and 'plr_track_complexity' in s_rep
    assert s_gen['total_student_grad_updates'] == (0 if robust else 1)


# -- the training entry point ------------------------------------------------

@pytest.fixture
def short_episodes(monkeypatch):
    """The registry's CarRacing with 5-step episodes, so 8-step rollouts
    end episodes and stage levels."""
    make = registry.make_carracing_env

    def short(name, args=None):
        env = make(name, args)
        env.params = dataclasses.replace(env.params, cfg=dataclasses.replace(
            env.params.cfg, max_inner_steps=MAX_INNER))
        env.cfg = env.params.cfg
        return env
    monkeypatch.setattr(registry, 'make_carracing_env', short)


@pytest.mark.parametrize('config', ['dr', 'plr', 'robust_plr'])
def test_train_runs_carracing_configs(short_episodes, capsys, config):
    """train.main at cr_dr, cr_plr and cr_robust_plr's flags (small,
    checkpointing off) for one cycle: every stat finite, the track stats
    in the line, the evaluation settings named on stderr."""
    flags = {'dr': DR_FLAGS, 'plr': PLR_FLAGS,
             'robust_plr': ROBUST_PLR_FLAGS}[config]
    runner, history = train.main(flags + ['--no_cuda', 'true',
                                          '--num_env_steps', str(N * T)])
    assert len(history) == 1
    for s in history:
        assert all(math.isfinite(float(v)) for v in s.values()), s
        assert any(k.endswith('track_complexity') for k in s)
    assert float(runner.ret_rms[3]) > 1.0
    assert 'test_env_names' in capsys.readouterr().err
    if config != 'dr':
        assert history[-1]['proportion_filled'] > 0


@pytest.mark.parametrize('flags,match', [
    (['--env_name', 'CarRacing-Vanilla-v0'], 'evaluation tracks'),
    (['--env_name', 'CarRacingF1-Italy-v0'], 'evaluation tracks'),
    (['--ued_algo', 'paired'], 'CarRacing teacher'),
    (['--use_editor', 'true'], 'mutate_level'),
    (['--checkpoint', 'true'], 'checkpoint'),
])
def test_unported_carracing_settings_are_refused(flags, match):
    """Refused before a cycle runs, naming what waits."""
    with pytest.raises(NotImplementedError, match=match):
        train.main(PLR_FLAGS + ['--no_cuda', 'true', '--num_env_steps',
                                str(4 * N * T)] + flags)


def test_unported_carracing_env_methods_raise():
    env = car_env()
    for call in (lambda: env.reset(4), lambda: env.step_adversary(None, None),
                 lambda: env.mutate_level(None, 3)):
        with pytest.raises(NotImplementedError):
            call()
