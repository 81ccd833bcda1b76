"""The precision scheme of kernel B3 (``csrc/lstm_seq.cu``) on the CPU.

The kernels take each recurrent product as three TF32 products on the
tensor cores: W_h is split once into a TF32 high and low part
(``tf32_split``, the rounding of ``cvt.rna.tf32.f32``), each step's operand
(m·h, or the backward's dz) is split as it is loaded, and each product is
hi hi + hi lo + lo hi, accumulated in fp32.  Here the three products are
taken exactly in float64 and rounded once to fp32, the cell runs in fp32,
and the recurrence over T = 256 steps at N = 8, H = 256 (the students'
LSTM-256 with ``RNNCore``'s initialisation, resets at t = 0 and mid-
sequence) is held against the JAX package's ``RNNCore.sequence_zx`` and its
``jax.vjp`` at the tolerances ``chip_smoke.py`` holds the kernels to: the
outputs within 1e-5, the gradients within 1e-4 + 1e-4·|ref|.  One TF32
product a step misses the outputs' tolerance, which is why the kernels take
three.  The card runs the kernels themselves (``test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.models.common import RNNCore as JaxCore
from dcd_isaac_tpu_torch.kernels.teacher_proj import tf32_split
from dcd_isaac_tpu_torch.models.common import RNNCore

T, N, H = 256, 8, 256
GATES = ('hi', 'hf', 'hg', 'ho')


def three_tf32(a, w):
    """a @ w.T as the kernels take it: hi hi + hi lo + lo hi, each product
    exact in float64, the sum rounded once to fp32."""
    (ah, al), (wh, wl) = (tuple(p.double() for p in tf32_split(x))
                          for x in (a, w))
    return (ah @ wh.T + ah @ wl.T + al @ wh.T).float()


def one_tf32(a, w):
    """a @ w.T as one TF32 product, hi hi, exact in float64."""
    ah, wh = (tf32_split(x)[0].double() for x in (a, w))
    return (ah @ wh.T).float()


def make_inputs(seed=0):
    """zx, masks, carry and cotangents from numpy; W_h from a fresh
    ``RNNCore`` (orthogonal gate blocks) and a small random bias."""
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    masks = (rng.random((T, N)) > 0.05).astype(np.float32)
    masks[0, ::2] = 0.0
    core = RNNCore(4, H, generator=torch.Generator().manual_seed(seed))
    return dict(zx=f(T, N, 4 * H), masks=masks,
                w_h=core.w_h.weight.detach().numpy().copy(),
                b=f(4 * H, k=0.1), c0=f(N, H), h0=f(N, H), g_h=f(T, N, H),
                g_c=f(N, H))


def jax_reference(x):
    """h_all, c_T and the VJP (dzx, dc0, dh0) of the JAX ``sequence_zx`` at
    the cotangents of h_all and c_T."""
    core = JaxCore(hidden_size=H)
    carry0 = core.initial_carry((N,))
    params = core.init(jax.random.PRNGKey(0), carry0, jnp.zeros((N, 4)),
                       jnp.ones((N,)))
    cell = dict(params['params']['cell'])
    hidden = {g: {'kernel': x['w_h'][q * H:(q + 1) * H].T,
                  'bias': x['b'][q * H:(q + 1) * H]}
              for q, g in enumerate(GATES)}

    def fwd(zx, carry):
        p = {'params': {'cell': {**cell, **hidden}}}
        return core.apply(p, carry, zx, x['masks'], method='sequence_zx')

    ((c_T, _), hs), vjp = jax.vjp(fwd, x['zx'], (x['c0'], x['h0']))
    zeros = np.zeros((N, H), np.float32)
    g_zx, (g_c0, g_h0) = vjp(((x['g_c'], zeros), x['g_h']))
    return {k: np.asarray(v) for k, v in (
        ('h_all', hs), ('c_T', c_T), ('dzx', g_zx), ('dc0', g_c0),
        ('dh0', g_h0))}


def step(product, zx_t, m, w_h, b, c, h):
    """One masked cell step with the recurrent product ``product``, the
    kernels' order: z = (hp @ W_h^T + b) + zx_t."""
    m = m[:, None]
    cp = c * m
    z = (product(h * m, w_h) + b) + zx_t
    i, f, g, o = z.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
        torch.sigmoid(o)
    c2 = f * cp + i * g
    return c2, o * torch.tanh(c2), (i, f, g, o), cp


def emulate(x, product):
    """The kernels' forward and backward with ``product`` for both
    recurrent products (z_t, and dz_{t+1} @ W_h as dz @ (W_h^T)^T)."""
    zx, masks, w_h, b, c0, h0, g_h, g_c = (
        torch.from_numpy(x[k]) for k in ('zx', 'masks', 'w_h', 'b', 'c0',
                                         'h0', 'g_h', 'g_c'))
    c, h = c0, h0
    cs, hs = [], []
    for t in range(T):
        c, h, _, _ = step(product, zx[t], masks[t], w_h, b, c, h)
        cs.append(c)
        hs.append(h)
    w_hT = w_h.T.contiguous()
    dzx = torch.empty_like(zx)
    dc, dh_rec = g_c, torch.zeros_like(h0)
    for t in reversed(range(T)):
        c_prev, h_prev = (cs[t - 1], hs[t - 1]) if t else (c0, h0)
        c2, _, (i, f, g, o), cp = step(product, zx[t], masks[t], w_h, b,
                                       c_prev, h_prev)
        tc = torch.tanh(c2)
        dh = g_h[t] + dh_rec
        dct = dc + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], -1)
        dzx[t] = dz
        m = masks[t][:, None]
        dc = m * (dct * f)
        dh_rec = m * product(dz, w_hT)
    return {'h_all': torch.stack(hs).numpy(), 'c_T': c.numpy(),
            'dzx': dzx.numpy(), 'dc0': dc.numpy(), 'dh0': dh_rec.numpy()}


@pytest.fixture(scope='module')
def case():
    x = make_inputs(3)
    return x, jax_reference(x)


def test_three_tf32_products_hold_the_output_tolerance(case):
    """Over 256 dependent steps, each step's rounding feeding the next: the
    3xTF32 recurrence within 1e-5 of JAX's fp32 one (and well inside it);
    one TF32 product a step misses 1e-5."""
    x, want = case
    got = emulate(x, three_tf32)
    for k in ('h_all', 'c_T'):
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-5, (k, err)
        assert err < 0.5e-5, (k, err)
    one = emulate(x, one_tf32)
    assert np.abs(one['h_all'] - want['h_all']).max() > 1e-5


@pytest.mark.parametrize('name', ['dzx', 'dc0', 'dh0'])
def test_three_tf32_products_hold_the_gradient_tolerance(case, name):
    """The recompute backward with both of its products in 3xTF32 within
    1e-4 + 1e-4·|ref| of ``jax.vjp``."""
    x, want = case
    got = emulate(x, three_tf32)[name]
    np.testing.assert_allclose(got, want[name], atol=1e-4, rtol=1e-4)
