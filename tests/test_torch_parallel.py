"""polyblur_torch.parallel and the last public names (A.14), on the CPU.

* One process, no group: ``deblur_sharded`` and ``data_parallel_deblur``
  are ``torch.equal`` to the composed chain (``extract_patches`` ->
  ``polyblur_core`` -> ``overlap_add``, or ``polyblur_core`` on the
  batch); the banded reassembly is within 2e-6 of ``deblur_sharded``
  (the JAX package's own bound, tests/test_sharding.py:139-140: it divides
  by the window sum where ``overlap_add`` multiplies by its reciprocal).
* ``patches._join_axis`` bit-equal to the JAX package's, both branches.
* Against the JAX package on its virtual CPU mesh (f32, ``'fft'``, 96 x 96
  in 32 px tiles): ``deblur_sharded`` and the reassembly's bands >= 60 dB,
  ``training_step``'s new scalars within 1.4e-4 relative (the port's
  budget against ``jax.grad``, tests/test_torch_training.py).
* Two gloo processes, spawned once for the module: the paths with a
  world of 2 (padding, a seam between ranks, the gradient sum) against
  the one-process results, the reassembly's bands against the JAX
  package's two-device bands, the mesh rules.
* A.14: ``compute_gradient_magnitudes``, ``mega_padded_eligible``,
  ``mega_restore_padded`` and ``build_window`` against the JAX package's,
  and every JAX module's ``__all__`` covered by its port module's.
"""

import importlib
import importlib.util
import json
import math
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyblur_torch import PolyblurLayer, make_train_step
from polyblur_torch.parallel import distributed
from polyblur_torch.parallel.distributed import (initialize_distributed,
                                                 make_multihost_mesh)
from polyblur_torch.parallel.sharding import (assemble_bands,
                                              data_parallel_deblur,
                                              deblur_sharded,
                                              deblur_sharded_reassembly,
                                              make_mesh,
                                              make_sharded_train_step,
                                              training_step)
from polyblur_torch.patches import (_join_axis, extract_patches, overlap_add,
                                    plan_patch_grid)
from polyblur_torch.pipeline import polyblur_core

ROOT = Path(__file__).resolve().parents[1]
KW = dict(n_iter=2, alpha=6.0, beta=1.0)
TILES = dict(patch_size=32, overlap=0.25)
PARAMS = dict(c=0.362, b=0.468, alpha=6.0, beta=1.0)
REL_JAX_GRAD = 1.4e-4
LR = 10.0        # SGD steps that move each scalar by ~1e-2 .. 4e-2


def _psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _uniform(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _training_pair():
    """A smooth sharp image in [0.2, 0.8] and its Gaussian blur: no pixel
    is clipped, so every scalar's gradient is well away from 0."""
    from scipy import ndimage

    noise = ndimage.gaussian_filter(_uniform(4, (2, 1, 48, 48)),
                                    (0, 0, 1.2, 1.2))
    sharp = 0.2 + 0.6 * (noise - noise.min()) / (noise.max() - noise.min())
    blurry = ndimage.gaussian_filter(sharp, (0, 0, 1.5, 1.0))
    return blurry.astype(np.float32), sharp.astype(np.float32)


# the inputs of the one-process runs, saved for the two worker processes
def _inputs():
    blurry, sharp = _training_pair()
    return dict(
        img80=_uniform(0, (1, 3, 80, 80)),       # 3 x 3 = 9 tiles: uneven
        img96=_uniform(1, (2, 1, 96, 96)),       # 4 tile rows
        batch=_uniform(2, (4, 3, 48, 64)),
        blurry=blurry, sharp=sharp)


@pytest.fixture(scope="module")
def inputs():
    return {k: torch.as_tensor(v) for k, v in _inputs().items()}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh("cpu")


def _chain(x, **kw):
    grid = plan_patch_grid(x.shape[-2], x.shape[-1], TILES["patch_size"],
                           TILES["overlap"])
    tiles = extract_patches(x, grid)
    return overlap_add(polyblur_core(tiles, device="cpu", **kw), grid,
                       x.shape[0])


def _training_scalars(new, loss):
    return torch.stack([new[k] for k in ("c", "b", "alpha", "beta")]
                       + [loss])


# ------------------------------------------------------------ one process

def test_mesh_without_group(mesh):
    assert mesh.shape == {"data": 1, "tile": 1}
    assert mesh.device_mesh is None and mesh.rank == 0
    assert mesh.coordinate() == (0, 0)


def test_deblur_sharded_equals_chain(mesh, inputs):
    x = inputs["img80"]
    got = deblur_sharded(x, mesh, **TILES, **KW)
    assert torch.equal(got, _chain(x, **KW))


def test_data_parallel_equals_core(mesh, inputs):
    x = inputs["batch"]
    got = data_parallel_deblur(x, mesh, **KW)
    assert torch.equal(got, polyblur_core(x, device="cpu", **KW))


@pytest.mark.parametrize("name", ["img80", "img96"])
def test_reassembly_matches_gathered(mesh, inputs, name):
    x = inputs[name]
    bands, meta = deblur_sharded_reassembly(x, mesh, **TILES, **KW)
    b, c, h, w = x.shape
    assert bands.shape[:3] == (1, b, c)
    assert meta["band"] == bands.shape[3] == meta["grid"].padded_size[0]
    got = assemble_bands(bands, meta)
    ref = deblur_sharded(x, mesh, **TILES, **KW)
    torch.testing.assert_close(got, ref, atol=2e-6, rtol=0)


def test_reassembly_refusals(mesh, inputs):
    with pytest.raises(ValueError, match="regular tile grid"):
        deblur_sharded_reassembly(inputs["img80"], mesh, patch_size=32,
                                  overlap=0.6, **KW)


def test_training_steps_equal_world_free_steps(mesh, inputs):
    """World size 1: the scaled, summed step is autograd of the same loss
    (and ``training.make_train_step``) to the bit."""
    x, y = inputs["blurry"], inputs["sharp"]
    new, loss = training_step(PARAMS, x, y, mesh, lr=LR, n_iter=1)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in PARAMS.items()}
    out = polyblur_core(x, n_iter=1, method="direct_separable", remat=True,
                        device="cpu", **p)
    want = torch.mean((out - y) ** 2)
    grads = torch.autograd.grad(want, list(p.values()))
    for (k, v), g in zip(p.items(), grads):
        assert torch.equal(new[k], v.detach() - LR * g), k
    assert torch.equal(loss, want.detach())

    layers = [PolyblurLayer(n_iter=1, learnable=True, device="cpu")
              for _ in range(2)]
    opts = [torch.optim.Adam(la.parameters(), lr=1e-2) for la in layers]
    steps = [make_sharded_train_step(layers[0], opts[0], mesh),
             make_train_step(layers[1], opts[1])]
    for _ in range(2):
        losses = [s(x, y) for s in steps]
        assert torch.equal(*losses)
    for a, b in zip(*(la.parameters() for la in layers)):
        assert torch.equal(a, b)


def test_world_one_group_runs_the_collectives(inputs, monkeypatch):
    """An explicit ``num_processes=1`` brings up a gloo world of one; the
    paths then call their collectives and give the same results."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    try:
        assert initialize_distributed(num_processes=1, device="cpu")
        assert initialize_distributed(num_processes=1, device="cpu")
        live = make_mesh()
        assert live.device_mesh is not None and live.device.type == "cpu"
        x = inputs["img80"]
        assert torch.equal(deblur_sharded(x, live, **TILES, **KW),
                           _chain(x, **KW))
        assert torch.equal(data_parallel_deblur(inputs["batch"], live, **KW),
                           polyblur_core(inputs["batch"], device="cpu",
                                         **KW))
        bands, meta = deblur_sharded_reassembly(x, live, **TILES, **KW)
        nogroup = deblur_sharded_reassembly(x, make_mesh("cpu"), **TILES,
                                            **KW)
        assert torch.equal(bands, nogroup[0])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_cuda_by_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()


def test_mesh_rules(monkeypatch):
    """``make_mesh`` rejects a world the data axis does not divide;
    ``make_multihost_mesh`` a data axis that is not a multiple of the node
    count (tests/test_sharding.py:143-178), here with 2 nodes pretended."""
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh("cpu", data_axis=2)
    assert make_multihost_mesh(device="cpu").shape == {"data": 1, "tile": 1}
    monkeypatch.setattr(distributed, "_node_count", lambda n: 2)
    for axis in (1, 3):
        with pytest.raises(ValueError, match="straddle"):
            make_multihost_mesh(data_axis=axis, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_multihost_mesh(device="cpu")   # 2 nodes' data axis, 1 rank
    relaxed = make_multihost_mesh(data_axis=1, allow_tile_across_hosts=True,
                                  device="cpu")
    assert relaxed.shape == {"data": 1, "tile": 1}


@pytest.mark.parametrize("shape,s,p,axis", [
    ((4, 3, 2, 5, 8, 8), 6, 8, 4),     # trailing axis, overlap 2
    ((4, 3, 2, 5, 8, 8), 8, 8, 4),     # trailing axis, no overlap
    ((3, 2, 5, 8, 20), 6, 8, 2),       # second-from-last (H) axis
    ((3, 2, 5, 8, 20), 4, 8, -2),      # H axis, 50% overlap
])
def test_join_axis_matches_jax(shape, s, p, axis):
    from polyblur_tpu.patches import _join_axis as jax_join

    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    got = _join_axis(torch.as_tensor(x), s, p, axis).numpy()
    want = np.asarray(jax_join(jnp.asarray(x), s, p, axis))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def jax_mesh2():
    from polyblur_tpu.parallel.sharding import make_mesh as jax_make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the JAX package's virtual CPU mesh")
    return jax_make_mesh(jax.devices()[:2], data_axis=1)


def test_deblur_sharded_matches_jax(mesh, inputs, jax_mesh2):
    from polyblur_tpu.parallel.sharding import deblur_sharded as jax_sharded

    x = inputs["img96"]
    got = deblur_sharded(x, mesh, method="fft", **TILES, **KW)
    want = jax_sharded(jnp.asarray(x.numpy()), jax_mesh2, method="fft",
                       **TILES, **KW)
    assert got.shape == want.shape
    assert _psnr(got, want) >= 60.0


@pytest.fixture(scope="module")
def jax_bands(inputs, jax_mesh2):
    """The JAX package's (2, B, C, band, W) bands of img96 on two devices
    ('tile' = 2), and its assembled image."""
    from polyblur_tpu.parallel.sharding import (
        assemble_bands as jax_assemble,
        deblur_sharded_reassembly as jax_reassembly)

    bands, meta = jax_reassembly(jnp.asarray(inputs["img96"].numpy()),
                                 jax_mesh2, method="fft", **TILES, **KW)
    return np.asarray(bands), np.asarray(jax_assemble(bands, meta))


def test_reassembly_matches_jax(mesh, inputs, jax_bands):
    bands, meta = deblur_sharded_reassembly(inputs["img96"], mesh,
                                            method="fft", **TILES, **KW)
    want_bands, want_image = jax_bands
    assert _psnr(assemble_bands(bands, meta), want_image) >= 60.0
    # one band of 4 tile rows holds the JAX package's two bands of 2
    keep = meta["step_h"] * 2
    assert _psnr(bands[0, :, :, :keep], want_bands[0, :, :, :keep]) >= 60.0
    assert _psnr(bands[0, :, :, keep:], want_bands[1]) >= 60.0


def test_training_step_matches_jax(mesh, inputs):
    from polyblur_tpu.parallel.sharding import (make_mesh as jax_make_mesh,
                                                training_step as jax_step)

    if len(jax.devices()) < 2:
        pytest.skip("needs the JAX package's virtual CPU mesh")
    x, y = inputs["blurry"], inputs["sharp"]
    new, loss = training_step(PARAMS, x, y, mesh, lr=LR, n_iter=1)
    jmesh = jax_make_mesh(jax.devices()[:2], data_axis=2)
    jparams = {k: jnp.float32(v) for k, v in PARAMS.items()}
    jnew, jloss = jax_step(jparams, jnp.asarray(x.numpy()),
                           jnp.asarray(y.numpy()), jmesh, lr=LR, n_iter=1)
    got = _training_scalars(new, loss).numpy()
    want = np.array([float(jnew[k]) for k in ("c", "b", "alpha", "beta")]
                    + [float(jloss)], np.float32)
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= REL_JAX_GRAD, rel
    moved = [k for k in PARAMS if float(new[k]) != PARAMS[k]]
    assert moved


# ------------------------------------------------------------ two processes

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, (url, outdir, root) = int(sys.argv[1]), sys.argv[2:5]
const = json.loads(sys.argv[5])
tiles, kw, params, lr = (const[k] for k in ("tiles", "kw", "params", "lr"))
sys.path.insert(0, root)
from polyblur_torch.parallel.distributed import (initialize_distributed,
                                                 make_multihost_mesh)
try:
    initialize_distributed(url, 2, rank, device="cpu")
except (RuntimeError, ValueError, OSError) as e:
    print(f"CLUSTER_FAIL {e!r}", flush=True)
    sys.exit(3)

from polyblur_torch import PolyblurLayer
from polyblur_torch.parallel.sharding import (
    data_parallel_deblur, deblur_sharded, deblur_sharded_reassembly,
    make_mesh, make_sharded_train_step, training_step)

with np.load(os.path.join(outdir, "inputs.npz")) as f:
    x = {k: torch.as_tensor(f[k]) for k in f.files}
res = {}
mesh = make_mesh()                                  # (1, 2) over gloo
res["mesh"] = torch.tensor([mesh.shape["data"], mesh.shape["tile"]])
res["sharded"] = deblur_sharded(x["img80"], mesh, **tiles, **kw)
res["dp"] = data_parallel_deblur(x["batch"], mesh, **kw)
res["band"] = deblur_sharded_reassembly(x["img96"], mesh, method="fft",
                                        **tiles, **kw)[0]
dmesh = make_mesh(data_axis=2)                      # (2, 1)
new, loss = training_step(params, x["blurry"], x["sharp"], dmesh, lr=lr,
                          n_iter=1)
res["train"] = torch.stack([new[k] for k in ("c", "b", "alpha", "beta")]
                           + [loss])
layer = PolyblurLayer(n_iter=1, learnable=True, device="cpu")
if rank == 1:    # the broadcast at the step's making evens the ranks out
    with torch.no_grad():
        layer.c.add_(0.25)
step = make_sharded_train_step(
    layer, torch.optim.SGD(layer.parameters(), lr=lr), dmesh)
res["layer_loss"] = torch.stack([step(x["blurry"], x["sharp"])
                                 for _ in range(2)])
res["layer"] = torch.stack([p.detach() for p in layer.parameters()])

errors = []
try:
    make_mesh(data_axis=3)
except ValueError as e:
    errors.append("not divisible" in str(e))
os.environ["LOCAL_WORLD_SIZE"] = "1"                # 2 nodes of 1 card
res["multihost"] = torch.tensor(list(make_multihost_mesh().shape.values()))
try:
    make_multihost_mesh(data_axis=1)
except ValueError as e:
    errors.append("straddle" in str(e))
res["relaxed"] = torch.tensor(list(make_multihost_mesh(
    data_axis=1, allow_tile_across_hosts=True).shape.values()))
res["rules"] = torch.tensor(errors)
torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
dist.destroy_process_group()
print("WORKER_OK", flush=True)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results from one spawn of two gloo processes that meet
    at a file in a temporary directory (no port, so xdist workers never
    race). Skips only where the pair cannot form its group."""
    tmp = tmp_path_factory.mktemp("gloo")
    url = f"file://{tmp / 'rendezvous'}"
    np.savez(tmp / "inputs.npz", **_inputs())
    const = json.dumps(dict(tiles=TILES, kw=KW, params=PARAMS, lr=LR))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), url, str(tmp), str(ROOT),
         const],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp)) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    fails = [o for o, _ in outs if "CLUSTER_FAIL" in o]
    if fails:
        pytest.skip(f"a 2-process gloo group could not form: {fails[0]}")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, err[-4000:]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True)
            for r in range(2)]


def test_two_ranks_mesh_rules(two_ranks):
    for res in two_ranks:
        assert res["mesh"].tolist() == [1, 2]
        assert res["multihost"].tolist() == [2, 1]
        assert res["relaxed"].tolist() == [1, 2]
        assert res["rules"].tolist() == [True, True]


def test_two_ranks_deblur_sharded_padded(two_ranks, mesh, inputs):
    """9 tiles over 2 ranks: one zero tile pads rank 1's slice. Each rank
    restores 5 tiles where one process restores 9: the per-tile CPU ops
    round alike, so the result is equal to the bit."""
    ref = deblur_sharded(inputs["img80"], mesh, **TILES, **KW)
    for res in two_ranks:
        assert torch.equal(res["sharded"], ref)


def test_two_ranks_data_parallel(two_ranks, mesh, inputs):
    ref = data_parallel_deblur(inputs["batch"], mesh, **KW)
    for res in two_ranks:
        assert torch.equal(res["dp"], ref)


def test_two_ranks_reassembly_seam(two_ranks, mesh, inputs, jax_bands):
    """Tile axis 2: the seam crosses the ranks. Each rank restores half the
    tile rows; rank 0's completed rows (its tail is rank 1's head) and
    rank 1's band are held to the one-process band's rows within 2e-6 (a
    rank's own tile batch may round a CPU op another way), both bands to
    the JAX package's two-device bands (>= 60 dB)."""
    bands = torch.cat([res["band"] for res in two_ranks])   # (2, B, ...)
    one, meta = deblur_sharded_reassembly(inputs["img96"], mesh,
                                          method="fft", **TILES, **KW)
    start = meta["thl"] // 2 * meta["step_h"]
    band = bands.shape[3]
    torch.testing.assert_close(bands[0, :, :, :start], one[0, :, :, :start],
                               atol=2e-6, rtol=0)
    torch.testing.assert_close(bands[1], one[0, :, :, start:start + band],
                               atol=2e-6, rtol=0)
    meta2 = dict(meta, thl=meta["thl"] // 2)
    torch.testing.assert_close(assemble_bands(bands, meta2),
                               assemble_bands(one, meta), atol=2e-6, rtol=0)
    want_bands, _ = jax_bands
    assert bands.shape == want_bands.shape
    for d in range(2):
        assert _psnr(bands[d], want_bands[d]) >= 60.0


def test_two_ranks_training_step(two_ranks, mesh, inputs):
    """The data axis 2: each rank's half-batch gradient, scaled by 1/2 and
    summed, against the one-process step on the whole batch."""
    new, loss = training_step(PARAMS, inputs["blurry"], inputs["sharp"],
                              mesh, lr=LR, n_iter=1)
    want = _training_scalars(new, loss)
    for res in two_ranks:
        rel = ((res["train"] - want).abs() / want.abs()).max()
        assert float(rel) <= 1e-6, (res["train"], want)


def test_two_ranks_sharded_train_step(two_ranks, inputs):
    """The ranks' layers start apart (rank 1's c was moved) and leave
    equal; two steps match the one-process trainer's (1e-6 relative)."""
    a, b = (res["layer"] for res in two_ranks)
    assert torch.equal(a, b)
    assert torch.equal(two_ranks[0]["layer_loss"], two_ranks[1]["layer_loss"])
    layer = PolyblurLayer(n_iter=1, learnable=True, device="cpu")
    step = make_train_step(layer, torch.optim.SGD(layer.parameters(),
                                                  lr=LR))
    losses = torch.stack([step(inputs["blurry"], inputs["sharp"])
                          for _ in range(2)])
    want = torch.stack([p.detach() for p in layer.parameters()])
    torch.testing.assert_close(a, want, atol=0, rtol=1e-6)
    torch.testing.assert_close(two_ranks[0]["layer_loss"], losses, atol=0,
                               rtol=1e-6)


# ------------------------------------------------------------ A.14

@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16)])
def test_compute_gradient_magnitudes_matches_jax(tdt, jdt):
    """f32 within 1 ulp (the channel mean sums in another order); bf16
    within one bf16 step."""
    from polyblur_tpu.estimation import compute_gradient_magnitudes as jax_m
    from polyblur_torch.estimation import compute_gradient_magnitudes

    rng = np.random.default_rng(6)
    gx, gy = (rng.normal(size=(2, 3, 40, 52)).astype(np.float32)
              for _ in range(2))
    for n in (6, 8):
        got = compute_gradient_magnitudes(torch.as_tensor(gx).to(tdt),
                                          torch.as_tensor(gy).to(tdt), n)
        want = jax_m(jnp.asarray(gx, jdt), jnp.asarray(gy, jdt), n)
        assert got.shape == want.shape == (2, n + 1) and got.dtype == tdt
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if tdt == torch.float32:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            step = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
            assert (np.abs(got - want) <= step).all()


def test_mega_padded_eligible_matches_jax():
    from polyblur_tpu.pipeline import mega_padded_eligible as jax_ok
    from polyblur_torch.pipeline import mega_padded_eligible

    sweep = [dict(), dict(method="direct_separable"),
             dict(method="direct_separable", remat=True),
             dict(method="direct_separable", q=1e-4),
             dict(method="direct_separable", discard_saturation=True),
             dict(method="direct_separable", multichannel_kernel=True),
             dict(method="direct_separable", ker_size=21),
             dict(method="direct_separable", n_angles=8),
             dict(method="direct_separable", n_interpolated_angles=36),
             dict(method="direct_separable", prefiltering=True),
             dict(method="direct_separable", prefiltering=True,
                  smoother="nc"),
             dict(method="direct_separable", prefiltering=True,
                  smoother="domain_transform"),
             dict(method="direct_separable", _disable_mega=True),
             dict(method="direct", alpha=3.0, n_iter=2),
             dict(method="direct_separable", c=0.4, remove_halo=True)]
    for gi in ((2, 2, 32, 32, 32, 32), (3, 4, 384, 384, 448, 448),
               (1, 2, 480, 560, 600, 640), (1, 1, 700, 700, 700, 700)):
        for kw in sweep:
            want = jax_ok(gi, _mega_interpret=True, **kw)
            assert mega_padded_eligible(gi, _mega_interpret=True,
                                        **kw) == want, (gi, kw)
            assert mega_padded_eligible(gi, **kw) == want, (gi, kw)


@pytest.mark.parametrize("kw", [
    dict(method="direct_separable", n_iter=2, alpha=6.0, beta=1.0),
    dict(method="direct_separable", n_iter=1, edgetaping=True,
         remove_halo=True),
    dict(method="fft", n_iter=1),
    dict(method="direct_separable", n_iter=1, remat=True),
])
def test_mega_restore_padded_matches_jax(kw):
    """Grid (2, 2, 32, 32, 32, 32) as tests/test_kernels.py runs it: the
    JAX package's kernel in interpret mode (f32 dots 'highest') >= 60 dB;
    None where the JAX package declines."""
    from polyblur_tpu.ops.pallas.sep_poly_fused import f32_dot_mode_scope
    from polyblur_tpu.pipeline import mega_restore_padded as jax_restore
    from polyblur_torch.pipeline import mega_restore_padded

    gi = (2, 2, 32, 32, 32, 32)
    padded = _uniform(7, (1, 3, 64, 64))
    got = mega_restore_padded(torch.as_tensor(padded), gi, pad_lanes=True,
                              **kw)
    with f32_dot_mode_scope("highest"):
        want = jax_restore(jnp.asarray(padded), gi, _mega_interpret=True,
                           **kw)
    if want is None:
        assert got is None
        return
    want = np.asarray(want)[..., :32]
    assert got.shape == want.shape == (4, 3, 32, 32)
    assert _psnr(got, want) >= 60.0


@pytest.mark.parametrize("window", ["kaiser", "hann", "hamming", "bartlett"])
def test_build_window_matches_jax(window):
    from polyblur_tpu.utils.imaging import build_window as jax_window
    from polyblur_torch.utils.imaging import build_window

    got = build_window((24, 40), window)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_window((24, 40), window)))
    with pytest.raises(ValueError):
        build_window((8, 8), "gauss")


def test_every_jax_name_has_a_port():
    """Each ``.py`` module of the JAX package outside ``ops/pallas`` has a
    port module whose ``__all__`` covers its own (compiled modules are
    skipped; ``ops/pallas`` maps to ``ops/cuda`` under other names)."""
    import polyblur_tpu

    missing = {}
    for info in pkgutil.walk_packages(polyblur_tpu.__path__,
                                      "polyblur_tpu."):
        name = info.name
        if name.startswith("polyblur_tpu.ops.pallas"):
            continue
        origin = importlib.util.find_spec(name).origin or ""
        if not origin.endswith(".py"):
            continue
        want = set(getattr(importlib.import_module(name), "__all__", ()))
        port = importlib.import_module(
            "polyblur_torch" + name[len("polyblur_tpu"):])
        gap = want - set(getattr(port, "__all__", ()))
        if gap:
            missing[name] = sorted(gap)
    assert not missing, missing
