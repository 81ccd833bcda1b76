"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on: the card unless the caller asks for the CPU.

    Raises when CUDA is absent and the caller did not pass ``'cpu'``: the
    port never moves work to the CPU on its own.  Turns TF32 off for
    matmuls and cuDNN convolutions, so the model computes in fp32 as the
    JAX reference does (cuDNN's default is TF32 on).
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
