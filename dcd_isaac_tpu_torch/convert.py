"""Carry weights from the JAX student to the port.

``from_flax`` takes the flax parameter tree of a student ``MultigridNetwork``
(as numpy arrays, with or without the top-level ``'params'`` key) and
returns a state dict of the port's ``MultigridNetwork`` that computes the
same function.
"""

from __future__ import annotations

import numpy as np
import torch


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
      order i, f, g, o.
    """
    p = params_np.get('params', params_np)
    sd = {}
    conv = p['image_conv']
    kernel = _t(conv['kernel'])                     # (kh, kw, in, out)
    sd['image_conv.weight'] = kernel.permute(3, 2, 0, 1).contiguous()
    sd['image_conv.bias'] = _t(conv['bias'])
    _dense(sd, 'scalar_embed', p['scalar_embed'])
    cell = p['core']['cell']
    sd['core.w_i.weight'] = torch.cat(
        [_t(cell[k]['kernel']) for k in ('ii', 'if', 'ig', 'io')], 1
    ).T.contiguous()
    sd['core.w_h.weight'] = torch.cat(
        [_t(cell[k]['kernel']) for k in ('hi', 'hf', 'hg', 'ho')], 1
    ).T.contiguous()
    sd['core.w_h.bias'] = torch.cat(
        [_t(cell[k]['bias']) for k in ('hi', 'hf', 'hg', 'ho')])
    for side in ('actor', 'critic'):
        i = 0
        while f'{side}_fc{i}' in p:
            # nn.Sequential(Linear, Tanh, Linear, Tanh, ...)
            _dense(sd, f'{side}_trunk.{2 * i}', p[f'{side}_fc{i}'])
            i += 1
        _dense(sd, f'{side}_head', p[f'{side}_head'])
    return sd
