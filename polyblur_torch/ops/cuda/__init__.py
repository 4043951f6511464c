"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

``launches`` counts kernel launches by kernel name; ``reset_launches``
zeroes it; ``build`` compiles every kernel library ahead of first use;
``plain_versions`` runs every wrapper called from its thread in its plain
version on any device (the reference the kernels are held against on the
card).
"""

from ._build import build, launches, plain_versions, reset_launches

__all__ = ["build", "launches", "plain_versions", "reset_launches"]
