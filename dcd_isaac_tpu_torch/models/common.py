"""Shared model components (port of dcd_isaac_tpu/models/common.py:31-154).

The core is an LSTM or, with arch ``'none'`` (or None), the identity with
an empty carry ``()`` (the non-recurrent teacher).  The LSTM is flax's
``OptimizedLSTMCell`` written out: carry ``(c, h)``, gate
order i, f, g, o, input kernels without bias and hidden kernels with bias.
The carry is multiplied by the mask (0 at episode starts) before every
cell step, which reproduces the reference's zero-reset chunking.

Initialization follows the JAX package: orthogonal (gain 1) input and
recurrent kernels per gate, zero biases; tanh MLP layers orthogonal with
gain sqrt(2) and zero bias.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
from torch import nn

from ..kernels.lstm_seq import lstm_seq

Carry = Union[Tuple[torch.Tensor, torch.Tensor], Tuple[()]]
# The archs of the identity core (JAX common.py:71).
NO_CORE = (None, 'none', '')


def _check_arch(arch) -> None:
    if arch != 'lstm' and arch not in NO_CORE:
        raise NotImplementedError(
            f'recurrent arch {arch!r}: only the LSTM and no core are ported')


def rnn_initial_carry(arch: str, hidden_size: int, batch_dims,
                      device=None) -> Carry:
    """Zero ``(c, h)`` carry of an LSTM core, ``()`` without a core."""
    _check_arch(arch)
    if arch in NO_CORE:
        return ()
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
    """LSTM core with mask-reset semantics, or the identity (no weights,
    carry ``()``) when ``arch`` is ``'none'``.

    ``w_i`` is the concatenation of flax's ``ii, if, ig, io`` kernels (no
    bias), ``w_h`` of ``hi, hf, hg, ho`` with their biases.  The model
    applies ``w_i`` itself (for the teacher through kernel B4) and passes
    the projection in.
    """

    def __init__(self, input_size: int, hidden_size: int = 256,
                 arch: str = 'lstm', generator=None):
        super().__init__()
        _check_arch(arch)
        self.arch = arch
        self.hidden_size = H = hidden_size
        if not self.is_recurrent:
            return
        self.w_i = nn.Linear(input_size, 4 * H, bias=False)
        self.w_h = nn.Linear(H, 4 * H)
        for g in range(4):
            orthogonal_(self.w_i.weight[g * H:(g + 1) * H], 1.0, generator)
            orthogonal_(self.w_h.weight[g * H:(g + 1) * H], 1.0, generator)
        nn.init.zeros_(self.w_h.bias)

    @property
    def is_recurrent(self) -> bool:
        return self.arch not in NO_CORE

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

    def forward_zx(self, carry: Carry, zx: torch.Tensor, mask: torch.Tensor):
        """One step on the input projection ``zx`` = x @ w_i^T (B, 4H) and
        the (B,) mask → (carry, (B, H))."""
        return self._cell(carry, zx, mask)

    def sequence_zx(self, carry: Carry, zx: torch.Tensor,
                    masks: torch.Tensor):
        """The recurrence over the input projections ``zx`` (T, B, 4H) and
        the (T, B) masks → (carry, (T, B, H)) (common.py:sequence_zx).

        The caller projects all T steps at once (the projection has no time
        dependence).  The recurrence is kernel B3 (``kernels/lstm_seq.py``),
        whose backward recomputes the gates from the stored carries.
        """
        h_all, carry = lstm_seq(zx, masks, self.w_h.weight, self.w_h.bias,
                                *carry)
        return carry, h_all
