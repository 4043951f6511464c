"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

``launches`` counts kernel launches by kernel name; ``reset_launches``
zeroes it; ``build`` compiles every kernel library ahead of first use.
"""

from ._build import build, launches, reset_launches

__all__ = ["build", "launches", "reset_launches"]
