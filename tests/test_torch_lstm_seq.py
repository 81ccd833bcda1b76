"""Kernel B3's plain twins and ``LSTMSeq`` against the JAX LSTM recurrence.

T = 16, N = 8, H = 32, fp32 on the CPU, inputs from a numpy seed: the
twins against ``RNNCore.sequence_zx`` of the JAX package and its
``jax.vjp`` (outputs and final carry within 1e-5, gradients within 1e-4),
with masks that reset mid-sequence and at t = 0; ``LSTMSeq``'s hand
backward against autograd of the plain forward; and what BPTT saves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.models.common import RNNCore as JaxCore
from dcd_isaac_tpu_torch.kernels import _build
from dcd_isaac_tpu_torch.kernels import lstm_seq as ls
from dcd_isaac_tpu_torch.models.common import RNNCore

T, N, H = 16, 8, 32
GATES = ('hi', 'hf', 'hg', 'ho')


def make_inputs(seed=0, reset_first=True):
    """zx, masks, flax params of the hidden side, carry, and cotangents of
    (h_all, c_T, h_T).  Masks reset about one step in five, and at t = 0
    for every env when ``reset_first``."""
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    masks = (rng.random((T, N)) > 0.2).astype(np.float32)
    if reset_first:
        masks[0] = 0.0
    else:
        masks[0, ::2] = 0.0
    hidden = {g: {'kernel': f(H, H, k=0.3), 'bias': f(H, k=0.3)}
              for g in GATES}
    return dict(zx=f(T, N, 4 * H), masks=masks, hidden=hidden,
                carry=(f(N, H), f(N, H)), g_h=f(T, N, H), g_c=f(N, H),
                g_hT=f(N, H))


def torch_weights(hidden):
    """flax (H, H) kernels and (H,) biases → Linear weight (4H, H), bias."""
    w = np.concatenate([hidden[g]['kernel'] for g in GATES], 1).T
    b = np.concatenate([hidden[g]['bias'] for g in GATES])
    return torch.tensor(np.ascontiguousarray(w)), torch.tensor(b)


def jax_reference(x):
    """Outputs and the VJP of the JAX ``sequence_zx`` at the cotangents."""
    core = JaxCore(hidden_size=H)
    carry0 = core.initial_carry((N,))
    params = core.init(jax.random.PRNGKey(0), carry0,
                       jnp.zeros((N, 4)), jnp.ones((N,)))
    cell = dict(params['params']['cell'])

    def fwd(zx, hidden, carry):
        p = {'params': {'cell': {**cell, **hidden}}}
        return core.apply(p, carry, zx, x['masks'], method='sequence_zx')

    (cT, hs), vjp = jax.vjp(fwd, x['zx'], x['hidden'], x['carry'])
    (c_T, h_T) = cT
    g_zx, g_hidden, (g_c0, g_h0) = vjp(((x['g_c'], x['g_hT']), x['g_h']))
    g_w, g_b = torch_weights(jax.tree.map(np.asarray, g_hidden))
    return {'h_all': np.asarray(hs), 'c_T': np.asarray(c_T),
            'h_T': np.asarray(h_T), 'dzx': np.asarray(g_zx), 'dw': g_w.numpy(),
            'db': g_b.numpy(), 'dc0': np.asarray(g_c0),
            'dh0': np.asarray(g_h0)}


def close(a, b, atol, name):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize('reset_first', [True, False])
def test_plain_twins_match_jax(reset_first):
    x = make_inputs(1, reset_first)
    want = jax_reference(x)
    w_h, b = torch_weights(x['hidden'])
    zx, masks = torch.tensor(x['zx']), torch.tensor(x['masks'])
    c0, h0 = (torch.tensor(a) for a in x['carry'])
    h_all, c_all, (c_T, h_T) = ls.lstm_seq_plain_forward(zx, masks, w_h, b,
                                                         c0, h0)
    for name, got in (('h_all', h_all), ('c_T', c_T), ('h_T', h_T)):
        close(got, want[name], 1e-5, name)
    # the gradient of h_T reaches the twin through h_all's last step
    g_h = torch.tensor(x['g_h'])
    g_h[-1] += torch.tensor(x['g_hT'])
    grads = ls.lstm_seq_plain_backward(g_h, torch.tensor(x['g_c']), zx,
                                       masks, w_h, b, c0, h0, h_all, c_all)
    for name, got in zip(('dzx', 'dw', 'db', 'dc0', 'dh0'), grads):
        close(got, want[name], 1e-4, name)


@pytest.mark.parametrize('reset_first', [True, False])
def test_lstm_seq_matches_jax_vjp(reset_first):
    """The autograd path the model takes (``RNNCore.sequence_zx`` →
    ``LSTMSeq``) against ``jax.vjp``."""
    x = make_inputs(2, reset_first)
    want = jax_reference(x)
    core = RNNCore(4, H)
    w_h, b = torch_weights(x['hidden'])
    with torch.no_grad():
        core.w_h.weight.copy_(w_h)
        core.w_h.bias.copy_(b)
    zx = torch.tensor(x['zx'], requires_grad=True)
    c0, h0 = (torch.tensor(a, requires_grad=True) for a in x['carry'])
    (c_T, h_T), h_all = core.sequence_zx((c0, h0), zx,
                                         torch.tensor(x['masks']))
    for name, got in (('h_all', h_all), ('c_T', c_T), ('h_T', h_T)):
        close(got, want[name], 1e-5, name)
    leaves = (zx, core.w_h.weight, core.w_h.bias, c0, h0)
    grads = torch.autograd.grad(
        (h_all, c_T, h_T), leaves,
        tuple(torch.tensor(x[k]) for k in ('g_h', 'g_c', 'g_hT')))
    for name, got in zip(('dzx', 'dw', 'db', 'dc0', 'dh0'), grads):
        close(got, want[name], 1e-4, name)


def test_hand_backward_matches_autograd_of_the_plain_forward():
    x = make_inputs(3, reset_first=False)
    w_h, b = torch_weights(x['hidden'])
    inputs = [torch.tensor(x['zx']), torch.tensor(x['masks']), w_h, b,
              *(torch.tensor(a) for a in x['carry'])]
    cot = [torch.tensor(x[k]) for k in ('g_h', 'g_c', 'g_hT')]
    grads = {}
    for name in ('hand', 'autograd'):
        leaves = [t.clone().requires_grad_(k != 1)
                  for k, t in enumerate(inputs)]
        if name == 'hand':
            h_all, (c_T, h_T) = ls.lstm_seq(*leaves)
        else:
            h_all, _, (c_T, h_T) = ls.lstm_seq_plain_forward(*leaves)
        diff = [leaves[k] for k in (0, 2, 3, 4, 5)]
        grads[name] = torch.autograd.grad((h_all, c_T, h_T), diff, cot)
    for a, b_ in zip(grads['hand'], grads['autograd']):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)


def saved_floats(fn, inputs):
    """Floats of the tensors autograd saves while ``fn`` runs, split into
    those of the inputs (saved by reference) and all others."""
    ids = {t.data_ptr() for t in inputs}
    counts = {'inputs': 0, 'other': 0}

    def pack(t):
        key = 'inputs' if t.data_ptr() in ids else 'other'
        counts[key] += t.numel()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*inputs)
    return counts


def test_bptt_saves_only_the_carries():
    """``LSTMSeq`` saves its inputs by reference and allocates for the
    backward only the per-step carries (c, h): 2 T N H floats, where the
    plain loop under autograd saves a graph of every step."""
    x = make_inputs(4)
    w_h, b = torch_weights(x['hidden'])
    inputs = [torch.tensor(x['zx']).requires_grad_(),
              torch.tensor(x['masks']), w_h.requires_grad_(),
              b.requires_grad_(),
              *(torch.tensor(a).requires_grad_() for a in x['carry'])]
    kernel = saved_floats(ls.lstm_seq, inputs)
    plain = saved_floats(ls.lstm_seq_plain_forward, inputs)
    assert kernel['other'] == 2 * T * N * H
    assert kernel['inputs'] <= sum(t.numel() for t in inputs)
    assert plain['other'] >= 8 * T * N * H


def test_cpu_takes_the_twins_without_building(monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError('kernel build requested')
    monkeypatch.setattr(_build, 'build', refuse)
    monkeypatch.setattr(_build, 'library', refuse)
    x = make_inputs(5)
    w_h, b = torch_weights(x['hidden'])
    args = (torch.tensor(x['zx']), torch.tensor(x['masks']), w_h, b,
            *(torch.tensor(a) for a in x['carry']))
    counts = (ls.lstm_seq.launches, ls.lstm_seq.backward_launches)
    h_all, (c_T, h_T) = ls.lstm_seq(*args)
    want, _, (c_want, _) = ls.lstm_seq_plain_forward(*args)
    assert torch.equal(h_all, want) and torch.equal(c_T, c_want)
    assert counts == (ls.lstm_seq.launches, ls.lstm_seq.backward_launches)
    meta = [a.to('meta') for a in args]
    with pytest.raises(RuntimeError, match='kernel build requested'):
        ls.lstm_seq(*meta)
    odd = [torch.zeros((2, 3, 64), device='meta'),
           torch.zeros((2, 3), device='meta'),
           torch.zeros((64, 16), device='meta'),
           torch.zeros((64,), device='meta'),
           torch.zeros((3, 16), device='meta'),
           torch.zeros((3, 16), device='meta')]
    with pytest.raises(ValueError, match='multiple of 32'):
        ls.lstm_seq(*odd)
    with pytest.raises(ValueError):
        ls.lstm_seq(args[0], args[1][:, :4], *args[2:])
