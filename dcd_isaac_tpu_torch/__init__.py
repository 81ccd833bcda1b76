"""PyTorch/CUDA port of dcd_isaac_tpu for an NVIDIA H100.

The JAX package ``dcd_isaac_tpu`` is the reference; this package keeps its
module names so each part can be found beside its counterpart.  It imports
torch and numpy only.  Its entry points run on the card unless the caller
asks for ``device='cpu'``; the hand-written CUDA kernels under ``csrc/`` are
built by ``kernels/_build.py`` at their first launch.
"""

from .device import resolve_device

__all__ = ['resolve_device']
