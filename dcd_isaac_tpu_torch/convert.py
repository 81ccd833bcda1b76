"""Carry weights and level buffers from the JAX package to the port.

``from_flax`` takes the flax parameter tree of a ``MultigridNetwork``, the
student's or the teacher's (as numpy arrays, with or without the top-level
``'params'`` key), and returns a state dict of the port's
``MultigridNetwork`` that computes the same function.  The teacher's tree
has the same names at other widths: the conv-128 kernel, a scalar embed of
``adversary_max_steps + 1`` → 10 and a 21 692-row input kernel whose rows
are the conv features in (h, w, c) order, then the scalar embed, then
``random_z``, the order of the port's embed and of kernel B4.  A tree
without ``core`` (the non-recurrent teacher, ``--recurrent_adversary_env
false``) has no LSTM weights, and its trunks' first kernels take the
embed's rows in that order.

``from_flax_walker`` does the same for the walker student
(``WalkerStudentPolicy``): its four trunk layers, value head, Gaussian
mean and ``log_std``.

``from_flax_carracing`` does the same for the CarRacing student
(``CarRacingNetwork``): the six conv kernels HWIO → OIHW, and the fcs
transposed.  The port flattens the conv stack's output in (h, w, c)
order, as flax does, so the first fc's rows need no permutation.

``from_jax_plr`` takes the fields of a JAX ``PLRBuffer`` (as numpy arrays,
an object with those attributes or a dict) and returns the port's
``PLRBuffer`` with the same contents on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .level_replay.plr import PLRBuffer


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _dense(sd: dict, prefix: str, node: dict) -> None:
    sd[f'{prefix}.weight'] = _t(node['kernel']).T.contiguous()
    if 'bias' in node:
        sd[f'{prefix}.bias'] = _t(node['bias'])


def from_flax(params_np: dict) -> dict:
    """flax param tree → port state dict.

    * conv kernel HWIO → OIHW.  The port's conv output is permuted to
      (h, w, c) before flattening (models/multigrid_models.py), so the
      flatten order of ``_embed`` already matches and the LSTM input kernel
      needs no permutation.
    * Dense (in, out) → Linear (out, in).
    * ``OptimizedLSTMCell``: ``ii/if/ig/io`` (no bias) stacked into
      ``core.w_i``, ``hi/hf/hg/ho`` (with bias) into ``core.w_h``, gate
      order i, f, g, o; no ``core`` in the tree, no core weights.
    """
    p = params_np.get('params', params_np)
    sd = {}
    conv = p['image_conv']
    kernel = _t(conv['kernel'])                     # (kh, kw, in, out)
    sd['image_conv.weight'] = kernel.permute(3, 2, 0, 1).contiguous()
    sd['image_conv.bias'] = _t(conv['bias'])
    _dense(sd, 'scalar_embed', p['scalar_embed'])
    if 'core' in p:
        _lstm(sd, p['core']['cell'])
    for side in ('actor', 'critic'):
        i = 0
        while f'{side}_fc{i}' in p:
            # nn.Sequential(Linear, Tanh, Linear, Tanh, ...)
            _dense(sd, f'{side}_trunk.{2 * i}', p[f'{side}_fc{i}'])
            i += 1
        _dense(sd, f'{side}_head', p[f'{side}_head'])
    return sd


def _lstm(sd: dict, cell: dict) -> None:
    sd['core.w_i.weight'] = torch.cat(
        [_t(cell[k]['kernel']) for k in ('ii', 'if', 'ig', 'io')], 1
    ).T.contiguous()
    sd['core.w_h.weight'] = torch.cat(
        [_t(cell[k]['kernel']) for k in ('hi', 'hf', 'hg', 'ho')], 1
    ).T.contiguous()
    sd['core.w_h.bias'] = torch.cat(
        [_t(cell[k]['bias']) for k in ('hi', 'hf', 'hg', 'ho')])


def from_flax_walker(params_np: dict) -> dict:
    """flax ``WalkerStudentPolicy`` params → the port's state dict."""
    p = params_np.get('params', params_np)
    sd = {}
    for name in ('actor1', 'actor2', 'critic1', 'critic2', 'critic_head'):
        _dense(sd, name, p[name])
    _dense(sd, 'dist.mean', p['dist']['mean'])
    sd['dist.log_std'] = _t(p['dist']['log_std'])
    return sd


def from_flax_carracing(params_np: dict) -> dict:
    """flax ``CarRacingNetwork`` params → the port's state dict."""
    p = params_np.get('params', params_np)
    sd = {}
    i = 0
    while f'conv{i}' in p:
        kernel = _t(p[f'conv{i}']['kernel'])           # (kh, kw, in, out)
        sd[f'convs.{i}.weight'] = kernel.permute(3, 2, 0, 1).contiguous()
        sd[f'convs.{i}.bias'] = _t(p[f'conv{i}']['bias'])
        i += 1
    for name in ('actor_fc', 'fc_alpha', 'fc_beta', 'critic_fc',
                 'critic_head'):
        _dense(sd, name, p[name])
    return sd


def from_jax_plr(buf, device='cpu') -> PLRBuffer:
    """JAX PLRBuffer fields (numpy arrays, by attribute or key) → the
    port's PLRBuffer on ``device``, with the same dtypes (float32 scores,
    int32 ids and counts, bool masks, uint8 levels)."""
    get = buf.get if isinstance(buf, dict) else (
        lambda k: getattr(buf, k))
    out = {}
    for f in dataclasses.fields(PLRBuffer):
        a = np.asarray(get(f.name))
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out[f.name] = torch.tensor(a, device=device)
    return PLRBuffer(**out)
