"""Kernel B2's plain twin, the student's fused policy step, against the JAX
package, on the CPU.

``policy_step_plain`` at weights converted from the flax student
(LSTM-256, conv-16, 32-32 heads) is held against JAX
``MultigridNetwork.__call__`` and ``categorical_log_prob`` on seeded numpy
inputs within 1e-5, in each of its modes; its inverse-CDF draw against a
numpy reference on the same uniforms; a student rollout through it against
the same rollout through the model's plain forward; and the wrapper takes
the twin only for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.models.distributions import categorical_log_prob
from dcd_isaac_tpu.models.multigrid_models import (
    MultigridNetwork as JaxNetwork,
)
from dcd_isaac_tpu_torch.algos.rollout import (
    RolloutConfig, initial_step_carry, make_student_rollout,
)
from dcd_isaac_tpu_torch.convert import from_flax
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
    AdversarialMultiGrid,
)
from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
from dcd_isaac_tpu_torch.kernels import _build
from dcd_isaac_tpu_torch.kernels import policy_step as ps
from dcd_isaac_tpu_torch.models.distributions import (
    categorical_inverse_cdf, categorical_sample,
)
from dcd_isaac_tpu_torch.models.multigrid_models import MultigridNetwork
from test_torch_algos import (
    SHORT_EPISODES, action_script, near_goal_levels,
)

H, B, A = 256, 16, 7
TOL = 1e-5


@pytest.fixture(scope='module')
def student():
    """The flax student, its params, the port's at those params, and
    seeded inputs: views, directions, a carry and masks of 0 and 1."""
    rng = np.random.default_rng(0)
    obs = {'image': rng.integers(0, 11, (B, 5, 5, 3)).astype(np.uint8),
           'direction': rng.integers(0, 4, B).astype(np.int32)}
    carry = tuple(rng.normal(size=(B, H)).astype(np.float32)
                  for _ in range(2))
    mask = (np.arange(B) % 3 != 0).astype(np.float32)
    jnet = JaxNetwork(num_actions=A, recurrent_hidden_size=H)
    params = jnet.init(jax.random.PRNGKey(3), obs, jnet.initial_carry((B,)),
                       jnp.ones((B,)))
    net = MultigridNetwork(A, recurrent_hidden_size=H)
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return jnet, params, net, obs, carry, mask


def port_step(net, obs, carry, mask, mode, **kw):
    with torch.no_grad():
        return ps.policy_step_plain(
            torch.tensor(obs['image']), torch.tensor(obs['direction']),
            *(torch.tensor(c) for c in carry), torch.tensor(mask),
            net.policy_weights(), mode, **kw)


def close(a, b):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=TOL)


def test_forward_matches_jax(student):
    """logits, value and the new carry within 1e-5 (absolute and
    relative); the mask-0 rows start from a zero carry."""
    jnet, params, net, obs, carry, mask = student
    jl, jv, (jc, jh) = jnet.apply(params, obs, carry, jnp.asarray(mask))
    out = port_step(net, obs, carry, mask, 'forward')
    assert out.action is None and out.log_prob is None
    for a, b in ((jl, out.logits), (jv, out.value), (jc, out.carry[0]),
                 (jh, out.carry[1])):
        close(a, b)
    assert (mask == 0).any() and (mask == 1).any()
    # the model's forward is the same step
    with torch.no_grad():
        tl, tv, (tc, th) = net({k: torch.tensor(v) for k, v in obs.items()},
                               tuple(torch.tensor(c) for c in carry),
                               torch.tensor(mask))
    for a, b in ((tl, out.logits), (tv, out.value), (tc, out.carry[0]),
                 (th, out.carry[1])):
        assert torch.equal(a, b)


def test_given_action_log_prob_matches_jax(student):
    jnet, params, net, obs, carry, mask = student
    actions = np.random.default_rng(1).integers(0, A, B)
    jl, _, _ = jnet.apply(params, obs, carry, jnp.asarray(mask))
    want = categorical_log_prob(jl, jnp.asarray(actions))
    out = port_step(net, obs, carry, mask, 'action',
                    action=torch.tensor(actions))
    assert torch.equal(out.action, torch.tensor(actions))
    close(want, out.log_prob)
    close(jl, out.logits)


def test_value_only_mode(student):
    """The value of the forward, and nothing else."""
    jnet, params, net, obs, carry, mask = student
    _, jv, _ = jnet.apply(params, obs, carry, jnp.ones((B,)))
    out = port_step(net, obs, carry, np.ones(B, np.float32), 'value')
    assert out.logits is None and out.carry is None and out.action is None
    close(jv, out.value)


def test_sample_is_the_inverse_cdf_of_the_uniforms(student):
    """The sample mode's actions against a float64 numpy inverse CDF of
    softmax(logits) at the same uniforms, wherever the uniform is more than
    1e-5 from a CDF entry; its log-probs against JAX's at those actions."""
    jnet, params, net, obs, carry, mask = student
    u = np.random.default_rng(2).random(B).astype(np.float32)
    out = port_step(net, obs, carry, mask, 'sample', u=torch.tensor(u))
    logits = out.logits.numpy().astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    cdf = np.cumsum(p / p.sum(-1, keepdims=True), -1)
    want = (cdf[:, :-1] <= u[:, None].astype(np.float64)).sum(-1)
    clear = np.abs(cdf - u[:, None]).min(-1) > 1e-5
    assert clear.sum() >= B - 1
    np.testing.assert_array_equal(out.action.numpy()[clear], want[clear])
    jl, _, _ = jnet.apply(params, obs, carry, jnp.asarray(mask))
    close(categorical_log_prob(jl, jnp.asarray(out.action.numpy())),
          out.log_prob)


def test_inverse_cdf_covers_every_action():
    """Uniforms spread over [0, 1) draw each action in proportion to its
    probability, the last one included (u past the next-to-last CDF
    entry)."""
    logits = torch.tensor([[0.3, -1.0, 2.0, 0.0, -0.5, 1.0, 0.2]])
    u = (torch.arange(100000, dtype=torch.float32) + 0.5) / 100000
    acts = categorical_inverse_cdf(logits.expand(len(u), -1), u)
    freq = torch.bincount(acts, minlength=7).double() / len(u)
    torch.testing.assert_close(freq, torch.softmax(logits[0].double(), -1),
                               atol=2e-5, rtol=0)
    g = torch.Generator().manual_seed(0)
    drawn = categorical_sample(logits.expand(50000, -1), g)
    freq = torch.bincount(drawn, minlength=7).double() / 50000
    torch.testing.assert_close(freq, torch.softmax(logits[0].double(), -1),
                               atol=0.01, rtol=0)


@pytest.mark.parametrize('timelimits', [True, False])
def test_rollout_through_b2_matches_the_plain_forward(timelimits):
    """A 16-step rollout of 8 students (LSTM-32, injected actions, 6-step
    episodes so masks reset and truncation values are taken) through the
    B2 step equals, field for field, the same rollout through the model's
    plain forward and ``categorical_log_prob`` (the path before B2)."""
    T, N = 16, 8
    env = AdversarialMultiGrid(MultiGridParams(**SHORT_EPISODES))
    acts = action_script(np.random.default_rng(5), T, N)
    levels = torch.tensor(near_goal_levels(N, seed=6))
    net = MultigridNetwork(A, recurrent_hidden_size=32,
                           generator=torch.Generator().manual_seed(7))
    cfg = RolloutConfig(num_steps=T, handle_timelimits=timelimits,
                        record_log_dists=True)
    out = []
    for fused in (True, False):
        net.fused_policy_step = fused
        st, _ = env.reset_to_level(levels)
        st, obs = env.reset_agent(st)
        carry = initial_step_carry(net, st, obs)
        out.append(make_student_rollout(
            env, net, cfg,
            sample_action_fn=lambda logits, t: torch.tensor(acts[t]),
        )(carry, None))
    (f_final, f_steps, f_next, f_stats), (p_final, p_steps, p_next,
                                          p_stats) = out
    assert (f_steps.masks_pre == 0).sum() > N      # resets happened
    for k in ('actions', 'dones', 'masks_pre', 'bad_masks', 'rewards'):
        assert torch.equal(getattr(f_steps, k), getattr(p_steps, k)), k
    for k in ('log_probs', 'values', 'trunc_values', 'log_dists'):
        assert torch.equal(getattr(f_steps, k), getattr(p_steps, k)), k
    assert torch.equal(f_next, p_next)
    for a, b in zip(f_final.rnn_carry, p_final.rnn_carry):
        assert torch.equal(a, b)
    for k in f_stats:
        assert torch.equal(f_stats[k], p_stats[k]), k


# -- the wrapper: the twin on the CPU, no fallback off it -------------------

def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError('kernel build requested')
    monkeypatch.setattr(_build, 'build', refuse)
    monkeypatch.setattr(_build, 'library', refuse)


def test_wrapper_takes_the_twin_on_the_cpu(monkeypatch, student):
    _no_build(monkeypatch)
    _, _, net, obs, carry, mask = student
    count = ps.policy_step.launches
    args = (torch.tensor(obs['image']), torch.tensor(obs['direction']),
            *(torch.tensor(c) for c in carry), torch.tensor(mask))
    u = torch.rand(B, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        w = net.policy_weights()
        assert w.packed is None
        got = ps.policy_step(*args, w, 'sample', u=u)
        want = ps.policy_step_plain(*args, w, 'sample', u=u)
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)
    assert ps.policy_step.launches == count


def test_wrapper_never_falls_back_off_the_cpu(monkeypatch, student):
    _no_build(monkeypatch)
    _, _, net, _, _, _ = student
    meta = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                       device='meta')
    w = ps.make_weights(*(meta(*t.shape) for t in (
        net.image_conv.weight, net.image_conv.bias, net.scalar_embed.weight,
        net.scalar_embed.bias, net.core.w_i.weight, net.core.w_h.weight,
        net.core.w_h.bias)),
        *((meta(*p.weight.shape), meta(*p.bias.shape), meta(
            *q.weight.shape), meta(*q.bias.shape), meta(*hd.weight.shape),
           meta(*hd.bias.shape)) for p, q, hd in (
            (net.actor_trunk[0], net.actor_trunk[2], net.actor_head),
            (net.critic_trunk[0], net.critic_trunk[2], net.critic_head))))
    assert w.packed is not None
    args = (meta(4, 5, 5, 3, dtype=torch.uint8), meta(4, dtype=torch.int32),
            meta(4, H), meta(4, H), meta(4))
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match='kernel build requested'):
        ps.policy_step(*args, w, 'value')
    with pytest.raises(ValueError, match='needs the uniforms'):
        ps.policy_step(*args, w, 'sample')
    with pytest.raises(TypeError, match='int32'):
        ps.policy_step(args[0], meta(4, dtype=torch.int64), *args[2:], w,
                       'value')
