#!/usr/bin/env python3
"""Times of ``kernel_spectrum`` and ``blend_overlap_add`` on one NVIDIA GPU,
at the shapes the paths give them, for the polyblur_torch tree in the
current directory.

Run from the root of a checkout: ``python3 tools/spectrum_blend_ab.py``.
Run from another tree's root (``cd build/parent && python3
../../tools/spectrum_blend_ab.py``) it times that tree's kernels with the
same inputs, so an A/B of two trees in one call runs parent, change,
change, parent. Prints the card line, then one line per kernel and shape:
CUDA-event ms (the median of three runs of 10 back-to-back calls) and the
device time of the same calls queued behind a device-side sleep (the
host's time between launches excluded). Last, the blend's backward at the
training cell's shapes (130 tiles of 400 px at step 300, bf16 tiles, f32
output): the tree's own (through the blend's autograd Function) and the
replay of autograd of the plain blend, with the backward's bytes bound,
and whether the two gradients are equal bit for bit. Imports no JAX.
"""

from __future__ import annotations

import math
import os
import sys

# the timing helpers of this tool's own tree, so that every tree is timed
# alike; then the tree under test, the current directory, ahead of it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import bound_ms, card_line, cuda_ms, device_ms  # noqa: E402

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spectrum_blend_ab: no CUDA device", file=sys.stderr)
        return 2
    from polyblur_torch.ops.cuda import polyblur_fused as pf
    from polyblur_torch.ops.cuda.overlap_add import blend_overlap_add
    from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs
    from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                        plan_patch_grid)
    from polyblur_torch.pipeline import _mega_pack

    dev = torch.device("cuda")
    print(f"tree {os.getcwd()}; card {card_line()}")
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    g = torch.Generator().manual_seed(7)
    for n, (ph, pw), wd in ((88, (448, 448), torch.bfloat16),
                            (12, (448, 448), torch.bfloat16),
                            (1, (480, 640), torch.float32)):
        sigma, rho = (0.3 + 3.7 * torch.rand(n, generator=g)
                      for _ in range(2))
        theta = torch.randint(0, 30, (n,), generator=g).float() * (
            math.pi / 30)
        est = torch.zeros((n, 8))
        est[:, 5:8] = torch.stack(gaussian_quadratic_coeffs(sigma, rho,
                                                            theta), 1)
        est = est.to(dev)
        tabs = pf.stage_tables(ph, pw, wd, str(dev))
        def one():
            return pf.kernel_spectrum(est, coeffs, tabs)

        print(f"kernel_spectrum n={n} h={tabs.h} kp={tabs.er.shape[1]}: "
              f"{cuda_ms(one):.4f} ms, device "
              f"{device_ms(one):.4f} ms")
    for hw in ((3000, 4000), (1198, 1598)):
        grid = plan_patch_grid(*hw, 448, 64.0 / 448.0)
        th, tw, sh, sw = _grid_steps(grid)
        tiles = torch.rand((th * tw, 3, 448, 448), device=dev,
                           generator=torch.Generator(dev).manual_seed(8))
        win, inv = _blend_constants(grid, "kaiser", dev)
        args = (win, inv, (th, tw, sh, sw, 448, 448), 1,
                (grid.pad[0], grid.pad[2]) + grid.orig_size)
        for tdt in (torch.bfloat16, torch.float32):
            t = tiles.to(tdt)
            def blend():
                return blend_overlap_add(t, *args, out_dtype=torch.float32)

            print(f"blend_overlap_add {hw[0]}x{hw[1]} {str(tdt)[6:]} -> "
                  f"float32: {cuda_ms(blend):.4f} ms, device "
                  f"{device_ms(blend):.4f} ms")
    blend_backward(dev)
    return 0


def blend_backward(dev) -> None:
    import torch

    from polyblur_torch.ops.cuda.overlap_add import (
        blend_overlap_add, blend_overlap_add_plain)
    from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                        plan_patch_grid)

    grid = plan_patch_grid(3000, 4000, 400, 0.25)
    gi = _grid_steps(grid) + (400, 400)
    win, inv = _blend_constants(grid, "kaiser", dev)
    args = (win, inv, gi, 1, (grid.pad[0], grid.pad[2]) + grid.orig_size,
            torch.float32)
    gen = torch.Generator(dev).manual_seed(26)
    n = gi[0] * gi[1]
    tiles = (torch.rand((n, 3, 400, 400), device=dev, generator=gen) * 1.5
             - 0.25).to(torch.bfloat16).requires_grad_()
    out = blend_overlap_add(tiles, *args)
    g = torch.randn(out.shape, device=dev, generator=gen)

    def own():
        return torch.autograd.grad(out, tiles, g, retain_graph=True)[0]

    def replay():
        x = tiles.detach().requires_grad_()
        return torch.autograd.grad(blend_overlap_add_plain(x, *args), x,
                                   g)[0]

    # tiles read and their gradient written, the output gradient and the
    # crop's reciprocal window sum read, each once
    px = out.shape[-2] * out.shape[-1]
    nbytes = 2 * tiles.numel() * 2 + out.numel() * 4 + px * 4
    bound, by = bound_ms(nbytes, 0.0, "bf16")
    ms_own, ms_rep = device_ms(own), cuda_ms(replay, reps=3)
    print(f"blend_overlap_add backward ({n} x 3 x 400^2 bf16 -> 3000x4000 "
          f"float32): own device {ms_own:.4f} ms ({100 * bound / ms_own:.1f}"
          f"% of its bound {bound:.4f} ms by {by}), replay of the plain "
          f"blend {ms_rep:.3f} ms; gradients equal "
          f"{torch.equal(own(), replay())}")


if __name__ == "__main__":
    sys.exit(main())
