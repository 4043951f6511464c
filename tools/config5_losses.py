#!/usr/bin/env python3
"""BASELINE config 5's training losses in both packages, on the CPU.

Fits ``PolyblurLayer(learnable=True, remat=True)`` of the JAX package and
of the port with Adam at lr 5e-3 for 6 steps on tests/test_runtime.py's
problem (150-180: a thresholded smooth random field, seed 0, blurred by
an anisotropic Gaussian with wrap-around) at 1024 x 1024, for config 5's
layer (bench_suite.py:247-273: 3 iterations, ``direct_separable``) and
the test's own (2 iterations, ``'fft'``), and prints each package's loss
sequence and fitted scalars. Run from the repository root:
``python3 tools/config5_losses.py [size]``. Imports JAX (CPU).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def problem(n: int):
    from scipy import ndimage

    from polyblur_torch.ops.gaussian import gaussian_filter_np

    rng = np.random.default_rng(0)
    base = ndimage.gaussian_filter(rng.uniform(size=(n, n)), 1.0)
    sharp = (base > base.mean()).astype(np.float32)
    k = gaussian_filter_np((1.7, 0.9), 0.6, k_size=np.array([25, 25]))
    blurry = np.clip(ndimage.convolve(sharp, k, mode="wrap"), 0,
                     1).astype(np.float32)
    return blurry[None, None], sharp[None, None]


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import polyblur_torch as pt
    from polyblur_tpu.layers import PolyblurLayer as JaxLayer
    from polyblur_tpu.training import fit_layer as jax_fit

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    blurry, sharp = problem(n)
    for n_iter, method in ((3, "direct_separable"), (2, "fft")):
        jparams, jlosses = jax_fit(
            JaxLayer(n_iter=n_iter, learnable=True, remat=True,
                     method=method), jnp.asarray(blurry), jnp.asarray(sharp),
            steps=6, learning_rate=5e-3)
        params, losses = pt.fit_layer(
            pt.PolyblurLayer(n_iter=n_iter, learnable=True, remat=True,
                             method=method, device="cpu"),
            blurry, sharp, steps=6, learning_rate=5e-3)
        print(f"{n}^2, n_iter {n_iter}, {method}:")
        print(f"  jax   losses {[f'{v:.8e}' for v in jlosses]}, params "
              f"{ {k: float(v) for k, v in jparams['params'].items()} }")
        print(f"  torch losses {[f'{v:.8e}' for v in losses]}, params "
              f"{params['params']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
