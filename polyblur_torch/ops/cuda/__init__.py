"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

``launches`` counts kernel launches by kernel name, ``feeds`` the
``spectral_gemm`` mode-1 launches by feed (``"tma"``, ``"gather"``),
``backward_launches`` the backward kernels' launches by wrapper (the
blend's); ``reset_launches`` zeroes all three; ``build`` compiles every
kernel library ahead of first use; ``plain_versions`` runs every wrapper
called from its thread in its plain version on any device (the reference
the kernels are held against on the card).
"""

from ._build import (backward_launches, build, feeds, launches,
                     plain_versions, reset_launches)

__all__ = ["backward_launches", "build", "feeds", "launches",
           "plain_versions", "reset_launches"]
