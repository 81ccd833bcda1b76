"""Shared model components (port of dcd_isaac_tpu/models/common.py:31-154).

The LSTM is flax's ``OptimizedLSTMCell`` written out: carry ``(c, h)``, gate
order i, f, g, o, input kernels without bias and hidden kernels with bias.
The carry is multiplied by the mask (0 at episode starts) before every
cell step, which reproduces the reference's zero-reset chunking.

Initialization follows the JAX package: orthogonal (gain 1) input and
recurrent kernels per gate, zero biases; tanh MLP layers orthogonal with
gain sqrt(2) and zero bias.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

Carry = Tuple[torch.Tensor, torch.Tensor]


def rnn_initial_carry(arch: str, hidden_size: int, batch_dims,
                      device=None) -> Carry:
    """Zero ``(c, h)`` carry of an LSTM core."""
    if arch != 'lstm':
        raise NotImplementedError(
            f'recurrent arch {arch!r}: only the LSTM is ported')
    shape = (*batch_dims, hidden_size)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


def orthogonal_(weight: torch.Tensor, gain: float, generator) -> None:
    """Orthogonal init of a Linear weight (out, in), as flax on (in, out)."""
    with torch.no_grad():
        w = torch.empty(weight.shape[::-1])
        nn.init.orthogonal_(w, gain, generator=generator)
        weight.copy_(w.T)


def mlp(sizes: Sequence[int], generator=None) -> nn.Sequential:
    """Tanh MLP trunk (make_fc_layers_with_hidden_sizes): Linear, Tanh, ..."""
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        lin = nn.Linear(fan_in, fan_out)
        orthogonal_(lin.weight, math.sqrt(2), generator)
        nn.init.zeros_(lin.bias)
        layers += [lin, nn.Tanh()]
    return nn.Sequential(*layers)


class RNNCore(nn.Module):
    """LSTM core with mask-reset semantics.

    ``w_i`` is the concatenation of flax's ``ii, if, ig, io`` kernels (no
    bias), ``w_h`` of ``hi, hf, hg, ho`` with their biases.
    """

    def __init__(self, input_size: int, hidden_size: int = 256,
                 arch: str = 'lstm', generator=None):
        super().__init__()
        if arch != 'lstm':
            raise NotImplementedError(
                f'recurrent arch {arch!r}: only the LSTM is ported')
        self.arch = arch
        self.hidden_size = H = hidden_size
        self.w_i = nn.Linear(input_size, 4 * H, bias=False)
        self.w_h = nn.Linear(H, 4 * H)
        for g in range(4):
            orthogonal_(self.w_i.weight[g * H:(g + 1) * H], 1.0, generator)
            orthogonal_(self.w_h.weight[g * H:(g + 1) * H], 1.0, generator)
        nn.init.zeros_(self.w_h.bias)

    def initial_carry(self, batch_dims, device=None) -> Carry:
        return rnn_initial_carry(self.arch, self.hidden_size, batch_dims,
                                 device)

    def _cell(self, carry: Carry, zx: torch.Tensor, mask: torch.Tensor):
        m = mask[..., None]
        c, h = carry[0] * m, carry[1] * m
        z = self.w_h(h) + zx
        i, f, g, o = z.chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return (c2, h2), h2

    def forward(self, carry: Carry, x: torch.Tensor, mask: torch.Tensor):
        """One step: (carry, (B, F) input, (B,) mask) → (carry, (B, H))."""
        return self._cell(carry, self.w_i(x), mask)

    def sequence(self, carry: Carry, xs: torch.Tensor, masks: torch.Tensor):
        """Over time: ((T, B, F), (T, B)) → (carry, (T, B, H)).

        The input projection has no time dependence and runs for all T at
        once; the loop carries only the recurrence.
        """
        zx = self.w_i(xs)
        outs = []
        for t in range(xs.shape[0]):
            carry, h = self._cell(carry, zx[t], masks[t])
            outs.append(h)
        return carry, torch.stack(outs)
