"""polyblur_torch — Polyblur blind deblurring in PyTorch with hand-written
CUDA kernels for Hopper (sm_90a).

The port of ``polyblur_tpu`` (JAX/Pallas on TPU), which stays the
reference. The patch engine's main path — pad + cast, per-tile blur
estimate, kernel spectrum, spectral polynomial, windowed overlap-add —,
the whole-image routes and the feature flags run through the kernels in
``csrc/``; every kernel has a plain PyTorch version beside it, which CPU
tensors take. :class:`PolyblurLayer` and the training functions make the
pipeline a trainable layer: the kernels run forward, autograd of their
plain versions backward.

``set_f32_dot_mode`` / ``f32_dot_mode_scope`` select the precision of the
kernels' f32 tensor-core products, ``'compensated'`` (3xTF32, the default)
or ``'highest'`` (f32 grade), as the JAX package's functions of the same
names; the port reads the mode at each call.

``polyblur_torch.cli`` holds the JAX package's tools on the port: the
demo (``cli.main``), the benchmark suite (``cli.bench_suite``), the
calibration of (c, b) (``cli.calibrate``, host NumPy over the
``oracle.numpy_ref`` copy) and the burst serving path (``cli.burst``,
over the host runtime of ``polyblur_torch.runtime``).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
The plain versions are an f32 reference: on the card they require
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) and
float32 matmul precision ``"highest"``, and raise otherwise.
"""

from .api import PolyblurDeblurring, polyblur_deblurring
from .config import PolyblurConfig
from .layers import PolyblurLayer, polyblur_apply
from .ops.cuda.sep_poly_fused import (f32_dot_mode, f32_dot_mode_scope,
                                      set_f32_dot_mode)
from .patches import deblur_patches
from .training import (fit_layer, load_checkpoint, load_params,
                       make_train_step, save_checkpoint, save_params)

__version__ = "0.1.0"

__all__ = ["polyblur_deblurring", "PolyblurDeblurring", "PolyblurConfig",
           "set_f32_dot_mode", "f32_dot_mode", "f32_dot_mode_scope",
           "deblur_patches", "PolyblurLayer", "polyblur_apply",
           "make_train_step", "fit_layer", "save_params", "load_params",
           "save_checkpoint", "load_checkpoint"]
