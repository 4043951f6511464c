"""Calibration of the affine blur model (c, b) — working port of the
reference's calibrate_blur_parameters.py.

Host NumPy over the port's copy of the NumPy oracle
(``polyblur_torch/oracle/numpy_ref.py``): the same computation as the JAX
package's ``cli/calibrate.py``, so one seed gives the same (c, b) in both.
No device is used.

The reference script imports a top-level NumPy ``filters`` module that does
not exist in its repo (calibrate_blur_parameters.py:9 — SURVEY.md §2.4
item 7), so it cannot run; the NumPy oracle (oracle/numpy_ref.py) supplies
those functions here.

Protocol (calibrate_blur_parameters.py:45-165): for each image x kernel
seed, blur a random patch with a random anisotropic Gaussian
(sigma in [0.3, 4], rho/sigma in [0.33, 1]), add noise, measure the
directional-gradient maxima at the blur direction (f_n) and orthogonal
(f_o), then robust-fit sigma^2 = c^2 * (1/f^2) - b^2 by an MAE linear
program. Expected (c, b) ~ (0.362, -0.468) at 1% noise on DIV2K (reference
README.md:100-101). NOTE: the fitted values depend on the *source image
statistics* — DIV2K is not available offline, so the default synthetic
sharp images give the methodology, not the published constants; point
--images at a sharp photo collection to reproduce them.

    python -m polyblur_torch.cli.calibrate --images 'path/*.png' \
        --n_kernels 10 --noise_std 0.01
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..oracle import numpy_ref as oracle

__all__ = ["main", "calibrate", "optimize_mae"]


def generate_blurry_patch(img: np.ndarray, rng: np.random.Generator,
                          patch_size: int, sigma_range, rho_ratio_range,
                          noise_std: float):
    """Random patch + random anisotropic blur + noise
    (calibrate_blur_parameters.py:12-35)."""
    h, w = img.shape[:2]
    ps = min(patch_size, h, w)
    i0 = rng.integers(0, h - ps + 1)
    j0 = rng.integers(0, w - ps + 1)
    patch = img[i0:i0 + ps, j0:j0 + ps]
    if patch.ndim == 3:
        patch = patch.mean(axis=-1)

    sigma_0 = rng.uniform(*sigma_range)
    # sigma_1 floored at the estimator's clamp minimum, and integer-degree
    # angles, exactly like the reference (calibrate_blur_parameters.py:22-25)
    sigma_1 = max(0.3, sigma_0 * rng.uniform(*rho_ratio_range))
    theta = float(rng.integers(0, 180)) * np.pi / 180.0
    kernel = oracle.gaussian_filter((sigma_0, sigma_1), theta,
                                    k_size=np.array([25, 25]))
    from scipy import ndimage

    blurred = ndimage.convolve(patch, kernel, mode="wrap")
    # q=1e-4 quantile normalization (calibrate_blur_parameters.py:31,38-42)
    lo = np.quantile(blurred, 1e-4)
    hi = np.quantile(blurred, 1.0 - 1e-4)
    blurred = np.clip((blurred - lo) / max(hi - lo, 1e-8), 0.0, 1.0)
    blurred = blurred + noise_std * rng.standard_normal(blurred.shape)
    return np.clip(blurred, 0.0, 1.0), sigma_0, sigma_1, theta


def measure_gradient_extrema(patch: np.ndarray, n_angles: int = 6,
                             n_interpolated_angles: int = 180):
    """(f_normal, f_ortho): directional-gradient maxima at the estimated
    blur direction and its orthogonal (calibrate_blur_parameters.py:78-86).
    """
    gx, gy = oracle.fourier_gradients(patch)
    mags = oracle.directional_gradient_magnitudes(gx, gy, n_angles)
    thetas = np.linspace(0, 180, n_angles + 1)
    ith = np.arange(0.0, 180.0, 180.0 / n_interpolated_angles)
    interp = oracle.keys_cubic_interp(ith / n_interpolated_angles,
                                      thetas / n_interpolated_angles, mags)
    i_min = int(np.argmin(interp))
    i_ortho = int((ith[i_min] + 90) % 180 / (180 / n_interpolated_angles))
    return interp[i_min], interp[i_ortho]


def optimize_mae(x: np.ndarray, y: np.ndarray):
    """MAE linear fit y = m*x + p via linprog
    (calibrate_blur_parameters.py:144-157); returns (m, p)."""
    from scipy import optimize

    n = len(x)
    # variables: [m, p, t_1..t_n]; minimize sum t_i s.t. |m x_i + p - y_i| <= t_i
    c_vec = np.concatenate([[0.0, 0.0], np.ones(n)])
    A = np.zeros((2 * n, n + 2))
    b_vec = np.zeros(2 * n)
    A[:n, 0] = x
    A[:n, 1] = 1.0
    A[:n, 2:] = -np.eye(n)
    b_vec[:n] = y
    A[n:, 0] = -x
    A[n:, 1] = -1.0
    A[n:, 2:] = -np.eye(n)
    b_vec[n:] = -y
    res = optimize.linprog(c_vec, A_ub=A, b_ub=b_vec,
                           bounds=[(None, None)] * 2 + [(0, None)] * n,
                           method="highs")
    return float(res.x[0]), float(res.x[1])


def calibrate(image_paths, n_kernels: int = 10, patch_size: int = 400,
              sigma_range=(0.3, 4.0), rho_ratio_range=(0.33, 1.0),
              noise_std: float = 0.01, seed: int = 0, verbose: bool = True,
              n_interpolated_angles: int = 180):
    """Full calibration sweep; returns dict with (c, b) per direction.

    The affine model: sigma^2 = m * (1/f^2) + p with m = c^2, p = -b^2,
    i.e. c = sqrt(m), b = sign(-p)*sqrt(|p|) (reference quotes b as the
    signed intercept root, README.md:100-101).

    :param n_interpolated_angles: angular resolution of the measurement.
        The reference calibrates at 180 (calibrate_blur_parameters.py:82)
        while its estimator runs at 30 — set 30 here to match the inference
        protocol exactly, which makes the fitted (c, b) self-consistent
        (the estimator then recovers ground-truth sigma on held-out blurs;
        see the JAX package's tests/test_runtime.py::
        test_calibration_round_trip).
    """
    from ..utils.io import imread_float

    rng = np.random.default_rng(seed)
    inv_f2_n, sig2_n, inv_f2_o, sig2_o = [], [], [], []
    for path in image_paths:
        img = imread_float(path) if isinstance(path, str) else path
        for _ in range(n_kernels):
            patch, s0, s1, _ = generate_blurry_patch(
                img, rng, patch_size, sigma_range, rho_ratio_range, noise_std)
            f_n, f_o = measure_gradient_extrema(
                patch, n_interpolated_angles=n_interpolated_angles)
            inv_f2_n.append(1.0 / max(f_n * f_n, 1e-12))
            sig2_n.append(s0 * s0)
            inv_f2_o.append(1.0 / max(f_o * f_o, 1e-12))
            sig2_o.append(s1 * s1)
        if verbose:
            name = os.path.basename(path) if isinstance(path, str) else "synthetic"
            print(f"  {name}: {n_kernels} kernels done")

    out = {}
    for name, xs, ys in [("normal", inv_f2_n, sig2_n),
                         ("orthogonal", inv_f2_o, sig2_o)]:
        m, p = optimize_mae(np.asarray(xs), np.asarray(ys))
        c = float(np.sqrt(max(m, 0.0)))
        b = float(np.sign(-p) * np.sqrt(abs(p)))
        out[name] = {"c": c, "b": b, "slope": m, "intercept": p,
                     "n_samples": len(xs), "x": list(map(float, xs)),
                     "y": list(map(float, ys))}
        if verbose:
            print(f"{name}: c = {c:.3f}, b = {b:.3f} ({len(xs)} samples)")
    return out


def save_plots(results: dict, outdir: str = "results") -> list:
    """Scatter + fitted affine model per direction, like the reference's
    committed calibration figures (calibrate_blur_parameters.py:168-199,
    results/calibration_{normal,orthogonal}_0.01.jpg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    paths = []
    for name, r in results.items():
        x = np.asarray(r["x"])
        y = np.asarray(r["y"])
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.scatter(x, y, s=8, alpha=0.5, label="samples")
        xx = np.linspace(0, x.max(), 100)
        ax.plot(xx, r["slope"] * xx + r["intercept"], "r-",
                label=f"c={r['c']:.3f}, b={r['b']:.3f}")
        ax.set_xlabel("1 / f^2")
        ax.set_ylabel("sigma^2 (gt)")
        ax.set_title(f"affine blur model — {name}")
        ax.legend()
        fig.tight_layout()
        path = os.path.join(outdir, f"calibration_{name}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        paths.append(path)
    return paths


def synthetic_sharp_images(n: int, size: int, seed: int = 1234):
    """Sharp piecewise-constant images with edges at many orientations —
    stand-ins for the DIV2K sharp photos the reference calibrates on
    (calibrate_blur_parameters.py:206; not shipped with either repo).
    Calibration assumes sharp sources: an already-blurry input inflates
    1/f^2 and biases (c, b)."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = ndimage.gaussian_filter(rng.uniform(size=(size, size)), 6.0)
        levels = np.quantile(base, [0.25, 0.5, 0.75])
        img = np.digitize(base, levels) / 3.0
        img = 0.1 + 0.8 * img
        out.append(img.astype(np.float32))
    return out


def dead_leaves_images(n: int, size: int, seed: int = 1234,
                       rmin: float = 1.5, rmax: float = 120.0):
    """Dead-leaves synthetic images: occluding disks with a power-law
    r^-3 size distribution — the standard scale-invariant model of
    natural-image statistics (1/f^2 power spectrum, occlusion edges at
    every orientation and contrast). Closest offline stand-in for the
    DIV2K photographs the published (0.362, -0.468) constants were fitted
    on (reference README.md:100-101): calibration only sees
    directional-gradient maxima, which dead leaves reproduce far better
    than piecewise-constant blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    # inverse-CDF sampling of p(r) ~ r^-3 on [rmin, rmax]
    a2, b2 = rmin ** -2.0, rmax ** -2.0
    for _ in range(n):
        img = np.full((size, size), np.nan, np.float32)
        remaining = size * size
        while remaining > 0:
            u = rng.uniform(b2, a2)
            r = float(u ** -0.5)
            cy, cx = rng.uniform(-r, size + r, size=2)
            g = rng.uniform(0.05, 0.95)
            y0, y1 = max(0, int(cy - r) - 1), min(size, int(cy + r) + 2)
            x0, x1 = max(0, int(cx - r) - 1), min(size, int(cx + r) + 2)
            if y0 >= y1 or x0 >= x1:
                continue
            box = img[y0:y1, x0:x1]
            mask = (((yy[y0:y1, x0:x1] - cy) ** 2
                     + (xx[y0:y1, x0:x1] - cx) ** 2) <= r * r) \
                & np.isnan(box)
            box[mask] = g
            remaining -= int(mask.sum())
        out.append(img)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Calibrate the (c, b) blur model")
    p.add_argument("--images", type=str, default="",
                   help="glob of SHARP calibration images (reference: DIV2K "
                        "valid); empty = synthetic images (--corpus)")
    p.add_argument("--corpus", choices=("dead_leaves", "piecewise"),
                   default="dead_leaves",
                   help="synthetic corpus when --images is empty: "
                        "dead_leaves (natural statistics; default) or the "
                        "piecewise-constant blobs")
    p.add_argument("--n_synthetic", type=int, default=8)
    p.add_argument("--n_kernels", type=int, default=10)
    p.add_argument("--patch_size", type=int, default=400)
    p.add_argument("--noise_std", type=float, default=0.01)
    p.add_argument("--sigma_min", type=float, default=0.3)
    p.add_argument("--sigma_max", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_interpolated_angles", type=int, default=180,
                   help="angular measurement resolution (reference: 180; "
                        "use 30 to match the estimator's inference protocol)")
    p.add_argument("--plot", action="store_true",
                   help="save calibration figures to results/")
    args = p.parse_args(argv)

    if args.images:
        sources = sorted(glob.glob(args.images))
        if not sources:
            raise SystemExit(f"no images match {args.images!r}")
        print(f"Calibrating on {len(sources)} image(s), "
              f"{args.n_kernels} kernels each, noise {args.noise_std}")
    else:
        gen = (dead_leaves_images if args.corpus == "dead_leaves"
               else synthetic_sharp_images)
        sources = gen(args.n_synthetic, 480)
        print(f"Calibrating on {len(sources)} {args.corpus} images, "
              f"{args.n_kernels} kernels each, noise {args.noise_std}")
    res = calibrate(sources, n_kernels=args.n_kernels,
                    patch_size=args.patch_size,
                    sigma_range=(args.sigma_min, args.sigma_max),
                    noise_std=args.noise_std, seed=args.seed,
                    n_interpolated_angles=args.n_interpolated_angles)
    if args.plot:
        for path in save_plots(res):
            print(f"saved {path}")
    return res


if __name__ == "__main__":
    main()
