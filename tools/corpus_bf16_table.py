#!/usr/bin/env python3
"""The bf16 tables of ROADMAP C.5 and PERF.md, on the CPU, through the
helpers of tests/test_torch_corpus.py and tests/test_torch_direct.py.

* corpus (n_iter 3, c 0.362, b 0.468, alpha 6, beta 1,
  ``direct_separable``): per image, the restoration strength lost in bf16
  against f32 (PSNR against sharp, dB; negative: bf16 restores more) and
  the bf16 output's agreement with f32 (dB), for the port's kernel route
  (tiles on the four 256 px fixtures, blocked on the twelve 1024 px
  ``corpus_hr`` cases) beside JAX's kernel in interpret mode on the same
  route, and for the f32-FFT composition (the port under ``remat``, JAX's
  CPU route); also the f32 agreement with JAX and the strength gap;
* the tiles route's witness on each fixture: one iteration from each of
  the mega kernel's states against its next state (dB), and the strength
  of the mega kernel started from the port's first state, minus the
  port's;
* ``method='direct'`` and ``smoother='nc'`` on the peacock crop and the
  fixtures: the port's bf16 output against JAX's bf16 and f32 outputs,
  and JAX's own bf16 error.

Run from the repository root: ``python3 tools/corpus_bf16_table.py``
(~3 min). Imports JAX (CPU). ``--direct-only`` prints the last table
alone; with ``XLA_FLAGS=--xla_allow_excess_precision=false`` in the
environment it shows JAX's bf16 error when XLA's CPU fusions round every
bf16 operation, as PyTorch does.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import numpy as np

    import test_torch_corpus as tc
    from polyblur_torch.ops.cuda.polyblur_fused import (TileView,
                                                        tile_estimate_plain)
    from polyblur_torch.pipeline import _mega_pack

    psnr = tc._psnr

    def row(name, route, jax_kernel):
        x, s, _ = tc._case(name)
        pf = tc._port(x, **tc.SEP)[0]
        pb = tc._port(x, torch.bfloat16, **tc.SEP)[0]
        pr = tc._port(x, torch.bfloat16, remat=True, **tc.SEP)[0]
        jf, jb = tc._jax(x, **tc.SEP), tc._jax(x, jnp.bfloat16, **tc.SEP)
        kf, kb = jax_kernel(x, jnp.float32), jax_kernel(x, jnp.bfloat16)
        print(f"{name:18s} f32 {psnr(pf, jf):6.1f} dB, gap "
              f"{abs(s(pf) - s(jf)):.5f} | {route} bf16: port "
              f"{s(pf) - s(pb):+.4f} ({psnr(pb, pf):.2f} dB), JAX kernel "
              f"{s(kf) - s(kb):+.4f} ({psnr(kb, kf):.2f} dB), port vs "
              f"kernel {psnr(pb, kb):.1f} dB | f32-FFT bf16: port "
              f"{s(pf) - s(pr):+.4f} ({psnr(pr, pf):.2f} dB), JAX "
              f"{s(jf) - s(jb):+.4f} ({psnr(jb, jf):.2f} dB), port vs JAX "
              f"{psnr(pr, jb):.1f} dB", flush=True)

    if "--direct-only" in sys.argv[1:]:
        return direct_table(psnr)

    print("fixtures: tiles route")
    for name in tc.FIXTURES:
        row(name, "tiles", lambda x, dt: tc._jax(x, dt, _mega_interpret=True,
                                                 **tc.SEP))
    print("corpus_hr: blocked route")
    for name in tc.HR_NAMES:
        row(name, "blocked", tc._jax_blocked_kernel)

    print("tiles route witness (bf16): one iteration from the mega "
          "kernel's states; the mega kernel from the port's first state")
    n = tc.SEP["n_iter"]
    coeffs = _mega_pack(tc.SEP["c"], tc.SEP["b"], tc.SEP["alpha"],
                        tc.SEP["beta"], 2.0, 0.8, device="cpu")
    for name in tc.FIXTURES:
        x, s, _ = tc._case(name)
        state, steps = x, []
        for _ in range(n):
            mega = tc._tiles_bf16(state, 1, "mega")
            port = tc._tiles_bf16(state, 1, "port")
            steps.append(f"{psnr(port, mega):.2f} dB "
                         f"({int((port != mega).sum())} px)")
            state = mega
        full_port = tc._tiles_bf16(x, n, "port")
        full_mega = tc._tiles_bf16(x, n, "mega")
        from_port = tc._tiles_bf16(tc._tiles_bf16(x, 1, "port"), n - 1,
                                   "mega")
        # the last iteration's sigma^2, estimated (one plain estimate) on
        # each run's state before it
        last = [float(tile_estimate_plain(TileView.of_tiles(
            torch.as_tensor(np.array(tc._tiles_bf16(x, n - 1, w)))
            .bfloat16()), coeffs)[0, 3]) for w in ("port", "mega")]
        print(f"{name:12s} steps {', '.join(steps)}; strength mega - port: "
              f"full {s(full_mega) - s(full_port):+.4f} dB, from the "
              f"port's first state {s(from_port) - s(full_port):+.4f} dB; "
              f"last iteration's sigma^2 port {last[0]:.4f}, mega "
              f"{last[1]:.4f}", flush=True)

    return direct_table(psnr)


def direct_table(psnr) -> int:
    import jax.numpy as jnp
    import torch

    import test_torch_direct as td
    from polyblur_torch.pipeline import polyblur_core

    print("direct / nc (bf16): port vs JAX bf16, port vs JAX f32, JAX's "
          "own (JAX bf16 vs JAX f32), dB")
    for config in td.CONFIGS:
        for name in td.IMAGES:
            x = td._image(name)
            kw = dict(td.KW, **td.CONFIGS[config])
            pb = polyblur_core(torch.as_tensor(x).bfloat16(), device="cpu",
                               **kw).float().numpy()
            jb = td._jax_core(x, jnp.bfloat16, **kw)
            jf = td._jax_core(x, jnp.float32, **kw)
            print(f"{config:7s}{name:12s} {psnr(pb, jb):6.2f} "
                  f"{psnr(pb, jf):6.2f} {psnr(jb, jf):6.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
