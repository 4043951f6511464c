"""Central configuration for the Polyblur pipeline.

The reference threads ~17 keyword arguments through every API level with
inconsistent defaults (functional b=0.768/beta=3 vs module b=0.468/beta=4).
Here there is one config dataclass; every entry point accepts per-call
overrides. Continuous fields (c, b, alpha, beta, sigma_s, sigma_r) are the
"traced" set of the JAX package; the rest select the code path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["PolyblurConfig", "FUNCTIONAL_DEFAULTS", "MODULE_DEFAULTS"]


@dataclasses.dataclass(frozen=True)
class PolyblurConfig:
    """All pipeline knobs in one place.

    Continuous:
        c, b:            affine blur-model slope / intercept (Eq. 24)
        alpha, beta:     mid / high frequency gains of the degree-3 filter
        sigma_s, sigma_r: spatial / range scales of the edge-aware prefilter

    Structural (select the code path):
        n_iter, ker_size, q, n_angles, n_interpolated_angles, and the
        boolean/str feature switches — same names as the reference surface.
    """

    # --- continuous ---
    c: Any = 0.352
    b: Any = 0.468
    alpha: Any = 2.0
    beta: Any = 4.0
    sigma_s: Any = 2.0
    sigma_r: Any = 0.4

    # --- structural ---
    n_iter: int = dataclasses.field(default=1, metadata={"static": True})
    ker_size: int = dataclasses.field(default=25, metadata={"static": True})
    q: float = dataclasses.field(default=0.0, metadata={"static": True})
    n_angles: int = dataclasses.field(default=6, metadata={"static": True})
    n_interpolated_angles: int = dataclasses.field(
        default=30, metadata={"static": True})
    remove_halo: bool = dataclasses.field(default=False, metadata={"static": True})
    edgetaping: bool = dataclasses.field(default=False, metadata={"static": True})
    prefiltering: bool = dataclasses.field(default=False, metadata={"static": True})
    discard_saturation: bool = dataclasses.field(
        default=False, metadata={"static": True})
    multichannel_kernel: bool = dataclasses.field(
        default=False, metadata={"static": True})
    method: str = dataclasses.field(default="fft", metadata={"static": True})
    smoother: str = dataclasses.field(default="bilateral", metadata={"static": True})
    remat: bool = dataclasses.field(default=False, metadata={"static": True})

    def replace(self, **kw) -> "PolyblurConfig":
        return dataclasses.replace(self, **kw)

    def static_kwargs(self) -> dict:
        """The structural subset, keyed like the pipeline's arguments."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.metadata.get("static")
        }

    def traced_kwargs(self) -> dict:
        """The continuous subset."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if not f.metadata.get("static")
        }


#: Defaults of the reference *functional* API (deblurring.py:23-25).
FUNCTIONAL_DEFAULTS = PolyblurConfig(b=0.768, beta=3.0, sigma_r=0.8)

#: Defaults of the reference *module* API (deblurring.py:266-268) — the
#: pinned framework-wide default set.
MODULE_DEFAULTS = PolyblurConfig()
