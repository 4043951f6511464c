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

``polyblur_torch.cli`` holds the JAX package's tools on the port: the
demo (``cli.main``), the benchmark suite (``cli.bench_suite``) and the
calibration of (c, b) (``cli.calibrate``, host NumPy over the
``oracle.numpy_ref`` copy).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
The plain versions are an f32 reference: on the card they require
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) and
float32 matmul precision ``"highest"``, and raise otherwise.
"""

from .api import PolyblurDeblurring, polyblur_deblurring
from .config import PolyblurConfig
from .layers import PolyblurLayer, polyblur_apply
from .patches import deblur_patches
from .training import (fit_layer, load_checkpoint, load_params,
                       make_train_step, save_checkpoint, save_params)

__version__ = "0.1.0"

__all__ = ["polyblur_deblurring", "PolyblurDeblurring", "PolyblurConfig",
           "deblur_patches", "PolyblurLayer", "polyblur_apply",
           "make_train_step", "fit_layer", "save_params", "load_params",
           "save_checkpoint", "load_checkpoint"]
