"""Deblurring demo CLI — the reference's main.py on the port.

    python -m polyblur_torch.cli.main --impath tests/data/peacock_defocus.png \
        --N 3 --alpha 6 --beta 1
    python -m polyblur_torch.cli.main --impath ... --device cpu

The flag surface of the reference (main.py:30-55) and of the JAX package's
``cli/main.py``, plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path); the synthetic degradation's noise is drawn from
``np.random.default_rng(0)``. The reference's protocol
(main.py:117-128): one warm-up run (on the card it builds the kernels),
then one timed run, ending in ``torch.cuda.synchronize()`` on the card.
``--method auto`` is ``'direct_separable'``, the reference's choice on
CUDA (main.py:109-112). The restored image is written as an 8-bit PNG
into ``--outdir``; :func:`main` returns its path.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    v = str(v).lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Polyblur blind deblurring (PyTorch, CUDA)")
    p.add_argument("--impath", type=str, required=True, help="input image")
    p.add_argument("--synthetic_degradation", type=str2bool, default=False,
                   help="if set adds synthetic gaussian blur")
    p.add_argument("--sigma", type=float, default=3.0)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--theta", type=float, default=0.0,
                   help="kernel angle in degrees")
    p.add_argument("--sigma_n", type=float, default=0.01, help="noise std")
    p.add_argument("--N", type=int, default=3, help="polyblur iterations")
    p.add_argument("--alpha", type=float, default=2)
    p.add_argument("--beta", type=float, default=3)
    p.add_argument("--q", type=float, default=0)
    p.add_argument("--do_prefiltering", type=str2bool, default=False)
    p.add_argument("--do_halo_removal", type=str2bool, default=False)
    p.add_argument("--do_edgetaping", type=str2bool, default=False)
    p.add_argument("--do_patch_decomposition", type=str2bool, default=False)
    p.add_argument("--patch_size", type=int, default=400)
    p.add_argument("--patch_overlap", type=float, default=0.25)
    p.add_argument("--method", type=str, default="auto",
                   choices=["auto", "fft", "direct", "direct_separable"],
                   help="auto = direct_separable (the reference's choice "
                        "on CUDA, main.py:109-112)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (the plain PyTorch path)")
    p.add_argument("--outdir", type=str, default="results")
    p.add_argument("--show", type=str2bool, default=False,
                   help="display with matplotlib")
    return p


def degrade(img: np.ndarray, args) -> np.ndarray:
    """The reference's synthetic degradation: a 25 x 25 anisotropic
    Gaussian blur with wrapped borders, then N(0, sigma_n) noise, clipped
    to [0, 1]."""
    from scipy import ndimage

    from ..ops.gaussian import gaussian_filter_np

    kernel = gaussian_filter_np((args.sigma, args.rho),
                                theta=args.theta * np.pi / 180.0,
                                k_size=np.array([25, 25]))
    if img.ndim == 3:
        kernel = kernel[..., None]
    imblur = ndimage.convolve(img, kernel, mode="wrap")
    rng = np.random.default_rng(0)
    imblur = imblur + args.sigma_n * rng.standard_normal(imblur.shape)
    return np.clip(imblur, 0.0, 1.0).astype(np.float32)


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    import torch

    from ..api import PolyblurDeblurring
    from ..pipeline import resolve_device
    from ..utils.io import imread_float, imsave_uint8

    dev = resolve_device(args.device)
    print("Polyblur (PyTorch) runs with parameters:")
    for k in ("synthetic_degradation", "N", "alpha", "beta", "method",
              "do_prefiltering", "do_edgetaping", "do_halo_removal",
              "do_patch_decomposition", "device"):
        print(f"  {k}: {getattr(args, k)}")

    img = imread_float(args.impath)
    print(f"Processing a ({img.shape[1]},{img.shape[0]}) image.")
    imblur = degrade(img, args) if args.synthetic_degradation else img

    deblurrer = PolyblurDeblurring(
        patch_decomposition=args.do_patch_decomposition,
        patch_size=args.patch_size, patch_overlap=args.patch_overlap,
        batch_size=20, device=dev)
    method = args.method
    if method == "auto":
        method = "direct_separable"
        print(f"method=auto -> {method} ({dev})")
    kw = dict(n_iter=args.N, c=0.362, b=0.468, alpha=args.alpha,
              beta=args.beta, remove_halo=args.do_halo_removal,
              prefiltering=args.do_prefiltering,
              edgetaping=args.do_edgetaping, method=method, q=args.q)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print("Warm-up run (builds the kernels on first use).")
    deblurrer(imblur, **kw)
    sync()
    print("Timed run:")
    start = time.perf_counter()
    impred = deblurrer(imblur, **kw)
    sync()
    print(f"Restoration took {time.perf_counter() - start:.3f} seconds")

    os.makedirs(args.outdir, exist_ok=True)
    out_path = os.path.join(
        args.outdir, f"restored_alpha_{args.alpha:g}_beta_{args.beta:g}.png")
    imsave_uint8(out_path, impred)
    print(f"saved {out_path}")

    if args.show:
        import matplotlib.pyplot as plt

        _, axes = plt.subplots(1, 2, figsize=(6, 4))
        axes[0].imshow(imblur, cmap="gray")
        axes[0].set_title("Blurry")
        axes[1].imshow(impred, cmap="gray")
        axes[1].set_title("Prediction")
        for ax in axes:
            ax.axis("off")
        plt.tight_layout()
        plt.show()
    print("done")
    return out_path


if __name__ == "__main__":
    main()
