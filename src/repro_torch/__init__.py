"""PyTorch/CUDA port of the camera-systems reproduction.

Mirrors ``src/repro`` (the JAX package, which stays the reference): the
same module layout, the same public functions, held against the JAX
package by ``tests/test_torch_*.py``.  Each Pallas kernel of the JAX
package becomes a CUDA C++ kernel for Hopper (``csrc/``) with a plain
PyTorch version beside it (``kernels/<name>/ref.py``); ``ops.py`` sends a
CUDA tensor to the kernel and a CPU tensor to the plain version.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card, asking for the default device raises.

The package imports torch and numpy only — never jax, never ``repro``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
