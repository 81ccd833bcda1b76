"""The port's student network against the flax one at converted weights.

Full width (LSTM-256, conv-16, 32-32 heads), fp32 on the CPU: one step and
the BPTT ``sequence`` within atol 1e-5, gradients of a scalar loss against
``jax.grad`` within atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.models.multigrid_models import (
    MultigridNetwork as JaxNetwork,
)
from dcd_isaac_tpu_torch.convert import from_flax
from dcd_isaac_tpu_torch.models.multigrid_models import MultigridNetwork

H, B, T = 256, 8, 12


@pytest.fixture(scope='module')
def nets():
    rng = np.random.default_rng(0)
    obs = {'image': rng.integers(0, 11, (T, B, 5, 5, 3)).astype(np.uint8),
           'direction': rng.integers(0, 4, (T, B)).astype(np.int32)}
    masks = (rng.random((T, B)) > 0.2).astype(np.float32)
    carry = tuple(rng.normal(size=(B, H)).astype(np.float32)
                  for _ in range(2))
    jnet = JaxNetwork(num_actions=7, recurrent_hidden_size=H)
    params = jnet.init(jax.random.PRNGKey(0),
                       jax.tree.map(lambda x: x[0], obs),
                       jnet.initial_carry((B,)), jnp.ones((B,)))
    net = MultigridNetwork(7, recurrent_hidden_size=H)
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return jnet, params, net, obs, masks, carry


def tt(tree):
    return jax.tree.map(torch.tensor, tree)


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                               rtol=0)


def test_converted_state_dict_is_complete(nets):
    _, params, net, *_ = nets
    sd = from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(net.state_dict())
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in net.parameters())


def test_one_step_matches(nets):
    jnet, params, net, obs, masks, carry = nets
    o0 = jax.tree.map(lambda x: x[0], obs)
    jl, jv, (jc, jh) = jnet.apply(params, o0, carry, masks[0])
    with torch.no_grad():
        tl, tv, (tc, th) = net(tt(o0), tt(carry), torch.tensor(masks[0]))
    for a, b in ((jl, tl), (jv, tv), (jc, tc), (jh, th)):
        close(a, b, 1e-5)


def test_sequence_matches(nets):
    jnet, params, net, obs, masks, carry = nets
    jl, jv, (jc, jh) = jnet.apply(params, obs, carry, masks,
                                  method='sequence')
    with torch.no_grad():
        tl, tv, (tc, th) = net.sequence(tt(obs), tt(carry),
                                        torch.tensor(masks))
    assert tl.shape == (T, B, 7) and tv.shape == (T, B)
    for a, b in ((jl, tl), (jv, tv), (jc, tc), (jh, th)):
        close(a, b, 1e-5)


def test_gradients_match(nets):
    jnet, params, net, obs, masks, carry = nets
    rng = np.random.default_rng(1)
    wl = rng.normal(size=(T, B, 7)).astype(np.float32)
    wv = rng.normal(size=(T, B)).astype(np.float32)

    def jloss(p):
        logits, values, (c, h) = jnet.apply(p, obs, carry, masks,
                                            method='sequence')
        return (jnp.sum(jax.nn.log_softmax(logits) * wl)
                + jnp.sum(values * wv) + jnp.sum(h))

    jgrads = from_flax(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    logits, values, (c, h) = net.sequence(tt(obs), tt(carry),
                                          torch.tensor(masks))
    loss = ((torch.log_softmax(logits, -1) * torch.tensor(wl)).sum()
            + (values * torch.tensor(wv)).sum() + h.sum())
    np.testing.assert_allclose(float(loss.detach()), float(jloss(params)),
                               rtol=1e-5)
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)
