"""Multi-card scale-out: tiles and batches split over the ranks of a job
(port of polyblur_tpu/parallel/sharding.py).

The reference is single-device (SURVEY.md §2.6); its scale axes are the
batch and the overlapping tiles of the patch engine. The JAX package
shards them over a ``jax.sharding.Mesh`` from one controller. In
PyTorch one process drives one card (``torchrun --nproc_per_node=N``),
so every function here is called on every rank with the same arguments:
each rank computes its own part and ``torch.distributed`` collectives put
the result together. The ranks are laid out as a ``('data', 'tile')``
:class:`Mesh`:

* ``data`` — batch elements (data parallel; spans nodes);
* ``tile`` — spatial tiles of the patch engine (within a node).

Tiles are cut from the replicate-padded image with the full apron, so a
tile needs no halo exchange: the paths are collective-free until the
result is put together (one ``all_gather`` of the restored tiles or
images; one seam exchange between tile neighbours in the banded
reassembly; one ``all_reduce`` of the gradients in training).

In a process with no group (world size 1) every function runs with no
collective; on a live group (:func:`..distributed.initialize_distributed`)
the collectives run, at world size 1 too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..layers import SCALARS
from ..patches import (_grid_steps, _join_axis, extract_patches, overlap_add,
                       plan_patch_grid)
from ..pipeline import polyblur_core, resolve_device
from ..training import _l2
from ..utils.imaging import build_window, build_window_np, clip_as_jax

__all__ = ["make_mesh", "deblur_sharded", "deblur_sharded_reassembly",
           "assemble_bands", "training_step", "make_sharded_train_step",
           "data_parallel_deblur", "Mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``('data', 'tile')`` layout of a job's ranks (what a JAX
    ``Mesh`` is to the JAX package).

    :ivar shape: ``{"data": D, "tile": S}``; ``mesh.shape["tile"]`` reads
        an axis size by name, as on a JAX mesh
    :ivar device: this rank's device (its card, or the CPU)
    :ivar device_mesh: the ``torch.distributed.DeviceMesh`` of
        ``init_device_mesh`` over a live group (its ``get_group(axis)``
        is the group of an axis), or None in a process with no group

    Rank r sits at ``(r // S, r % S)``, ``init_device_mesh``'s row-major
    layout, so a flattened ``('data', 'tile')`` axis is in rank order, as
    JAX's ``P(('data', 'tile'))``.
    """
    shape: dict
    device: torch.device
    device_mesh: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["tile"]

    @property
    def rank(self) -> int:
        return 0 if self.device_mesh is None else dist.get_rank()

    def coordinate(self):
        """(data index, tile index) of this rank."""
        return divmod(self.rank, self.shape["tile"])


def _rank_device(devices) -> torch.device:
    """This rank's device: ``devices`` if given, else the group's (the
    current card under NCCL, the CPU under another backend) or, with no
    group, ``pipeline.resolve_device``'s card."""
    if devices is not None:
        return resolve_device(devices)
    if not dist.is_initialized():
        return resolve_device(None)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(devices=None, data_axis: int = 1) -> Mesh:
    """The ``('data', 'tile')`` mesh of the job: ``data_axis`` ranks along
    the batch, the rest along the tiles.

    :param devices: this rank's device (one process drives one device):
        None for the group's (NCCL: the card; gloo: the CPU) or, with no
        group, the card (raises without one: pass ``"cpu"``)
    :param data_axis: ranks along the batch; it must divide the world
    :returns: a :class:`Mesh`; over a live group its ``device_mesh`` is
        ``init_device_mesh(type, (data_axis, world // data_axis),
        mesh_dim_names=("data", "tile"))``
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % data_axis != 0:
        raise ValueError(f"{n} devices not divisible by data_axis={data_axis}")
    dev = _rank_device(devices)
    shape = {"data": data_axis, "tile": n // data_axis}
    if not dist.is_initialized():
        return Mesh(shape, dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (data_axis, n // data_axis),
                          mesh_dim_names=("data", "tile"))
    return Mesh(shape, dev, dm)


def _pad_to_multiple(n_tiles: int, shard: int) -> int:
    return int(math.ceil(n_tiles / shard) * shard)


def _gather(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal slices concatenated along axis 0, in rank order."""
    if mesh.device_mesh is None:
        return local
    out = local.new_empty((mesh.size * local.shape[0],) + local.shape[1:])
    # all_gather_single supersedes all_gather_into_tensor where it exists
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, local.contiguous())
    return out


def _sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks of this rank's 'data' group."""
    if mesh.device_mesh is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM,
                        group=mesh.device_mesh.get_group("data"))
    return x


def _as_batch(images, mesh: Mesh) -> torch.Tensor:
    x = torch.as_tensor(images, device=mesh.device)
    if x.dim() != 4:
        raise ValueError(f"expected a (B, C, H, W) image batch, got "
                         f"{tuple(x.shape)}")
    return x


def deblur_sharded(images, mesh: Mesh, patch_size=400, overlap=0.25,
                   window_type: str = "kaiser",
                   **polyblur_kwargs) -> torch.Tensor:
    """Patch-engine deblurring with the tile batch split over every rank.

    :param images: (B, C, H, W), the same on every rank
    :param polyblur_kwargs: ``pipeline.polyblur_core``'s keywords
    :return: (B, C, h, w) restored images (even-cropped like the
        reference, deblurring.py:273-279), the whole result on every rank
        (JAX's replicated output)

    The (T B, C, ph, pw) tiles of ``extract_patches`` are zero-padded up to
    a multiple of the world size; rank r runs ``polyblur_core`` on the
    r-th contiguous slice, the slices are gathered, the padding dropped
    and the tiles blended by ``overlap_add``. Padding tiles are restored
    for nothing: wasted work only when T B is not a multiple of the world.
    """
    x = _as_batch(images, mesh)
    b = x.shape[0]
    grid = plan_patch_grid(x.shape[-2], x.shape[-1], patch_size, overlap)
    n = len(grid.coords) * b
    per = _pad_to_multiple(n, mesh.size) // mesh.size
    lo = min(mesh.rank * per, n)
    part = extract_patches(x, grid)[lo:lo + per]
    if part.shape[0] < per:
        part = torch.cat([part, part.new_zeros(
            (per - part.shape[0],) + part.shape[1:])])
    restored = polyblur_core(part, device=mesh.device, **polyblur_kwargs)
    return overlap_add(_gather(restored, mesh)[:n], grid, b, window_type)


def data_parallel_deblur(images, mesh: Mesh,
                         **polyblur_kwargs) -> torch.Tensor:
    """Whole-image ``polyblur_core`` with the batch split over every rank
    (data parallel only; one gather puts the batch together on every
    rank).

    :param images: (B, C, H, W), B divisible by the world size (as JAX's
        ``device_put`` requires)
    """
    x = _as_batch(images, mesh)
    b = x.shape[0]
    if b % mesh.size != 0:
        raise ValueError(f"batch {b} not divisible by the mesh's "
                         f"{mesh.size} devices")
    per = b // mesh.size
    r = mesh.rank
    restored = polyblur_core(x[r * per:(r + 1) * per], device=mesh.device,
                             **polyblur_kwargs)
    return _gather(restored, mesh)


def _data_slice(mesh: Mesh, *batches):
    """This rank's 'data' slice of each (B, ...) batch, and its share
    ``B_local / B`` of the global batch. The 'tile' ranks of one data
    index get the same slice (as P('data') leaves 'tile' replicated)."""
    xs = [torch.as_tensor(v, device=mesh.device) for v in batches]
    b, d_axis = xs[0].shape[0], mesh.shape["data"]
    if b % d_axis != 0:
        raise ValueError(f"batch {b} not divisible by data axis {d_axis}")
    per, d = b // d_axis, mesh.coordinate()[0]
    return [v[d * per:(d + 1) * per] for v in xs], per / b


def training_step(params: dict, blurry, sharp, mesh: Mesh, lr: float = 1e-3,
                  n_iter: int = 2, method: str = "direct_separable"):
    """One SGD step on (c, b, alpha, beta) through ``n_iter`` Polyblur
    iterations with ``remat=True`` (BASELINE config 5's layer).

    :param params: {"c", "b", "alpha", "beta"}: Python numbers or 0-d
        tensors (``convert.layer_params_from_jax`` carries the JAX
        package's over)
    :param blurry, sharp: (B, C, H, W), the same on every rank; the batch
        is split over 'data', B divisible by it
    :return: ``(new_params, loss)``, 0-d f32 tensors on the mesh's
        device, the same on every rank

    The loss is the mean squared error over the global batch: each rank
    scales its local loss and gradient by ``B_local / B`` and sums them
    over its 'data' group (one ``all_reduce``), where GSPMD inserts the
    JAX package's gradient psum.
    """
    (x, y), share = _data_slice(mesh, blurry, sharp)
    p = {k: torch.as_tensor(params[k], dtype=torch.float32,
                            device=mesh.device).detach().requires_grad_()
         for k in SCALARS}
    out = polyblur_core(x, n_iter=n_iter, c=p["c"], b=p["b"],
                        alpha=p["alpha"], beta=p["beta"], method=method,
                        remat=True, device=mesh.device)
    loss = torch.mean((out - y) ** 2) * share
    grads = torch.autograd.grad(loss, [p[k] for k in SCALARS])
    total = _sum_over_data(torch.stack([*grads, loss.detach().float()]),
                           mesh)
    new = {k: p[k].detach() - lr * total[i] for i, k in enumerate(SCALARS)}
    return new, total[-1]


def make_sharded_train_step(layer, optimizer, mesh: Mesh,
                            loss_fn: Callable = _l2):
    """Data-parallel form of ``training.make_train_step``.

    :param layer: e.g. ``PolyblurLayer(learnable=True)`` on each rank
    :param optimizer: a ``torch.optim`` optimizer over its parameters
    :param loss_fn: a mean over the batch (the default: squared error)
    :returns: ``step(blurry, sharp) -> loss`` (the global batch's, a
        detached 0-d tensor): the layer runs on this rank's 'data' slice,
        each parameter's ``.grad`` is scaled by ``B_local / B`` and summed
        over the 'data' group before ``optimizer.step()``. The parameters
        are broadcast from rank 0 here, so the ranks start equal and stay
        equal.
    """
    params = list(layer.parameters())
    if mesh.device_mesh is not None:
        for t in params:
            dist.broadcast(t.data, src=0)

    def step(blurry, sharp):
        (x, y), share = _data_slice(mesh, blurry, sharp)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(layer(x), y) * share
        loss.backward()
        grads = [t.grad for t in params if t.grad is not None]
        total = _sum_over_data(torch.cat(
            [g.reshape(-1) for g in grads]
            + [loss.detach().reshape(1).to(grads[0].dtype)]), mesh)
        offset = 0
        for g in grads:
            g.copy_(total[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        optimizer.step()
        return total[-1].to(loss.dtype)

    return step


def _window_band(grid, window_type: str, start: int, band: int,
                 device) -> torch.Tensor:
    """Rows ``start:start + band`` of the grid's window sum, summed in
    float64 on the host, as f32."""
    ph, pw = grid.patch_size
    window_np = build_window_np((ph, pw), window_type)
    wsum = np.zeros(grid.padded_size, np.float64)
    for (i0, j0) in grid.coords:
        wsum[i0:i0 + ph, j0:j0 + pw] += window_np
    return torch.as_tensor(wsum[start:start + band].astype(np.float32),
                           device=device)


def _exchange_seam(canvas: torch.Tensor, tail: int,
                   mesh: Mesh) -> torch.Tensor:
    """Send this band's last ``tail`` rows to the next tile rank and add
    the previous one's to the first ``tail`` rows (``jax.lax.ppermute``
    over 'tile' with the pairs (t, t + 1); the first band adds nothing)."""
    s = mesh.shape["tile"]
    if s == 1:
        return canvas
    t, me = mesh.coordinate()[1], mesh.rank
    ops, recv = [], None
    if t + 1 < s:
        strip = canvas[:, :, canvas.shape[2] - tail:].contiguous()
        ops.append(dist.P2POp(dist.isend, strip, me + 1))
    if t > 0:
        recv = canvas.new_empty(canvas.shape[:2] + (tail,) + canvas.shape[3:])
        ops.append(dist.P2POp(dist.irecv, recv, me - 1))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if recv is None:
        return canvas
    return torch.cat([canvas[:, :, :tail] + recv, canvas[:, :, tail:]], 2)


def deblur_sharded_reassembly(images, mesh: Mesh, patch_size=400,
                              overlap=0.25, window_type: str = "kaiser",
                              **polyblur_kwargs):
    """Patch-engine deblurring whose output stays split in bands (SURVEY
    §5.7's sharded reassembly, beside :func:`deblur_sharded`).

    Tile rows are split over 'tile' and the batch over 'data'. Each rank
    restores its ``thl tw B_l`` tiles, multiplies them by the window in
    the restored dtype and overlap-adds them into its band by reshapes
    (``patches._join_axis``: columns, then rows), sends its last ``ph -
    step_h`` rows to the next tile rank and adds what it receives to its
    first rows (``batch_isend_irecv``, the only collective), divides by
    the window sum plus 1e-8 and clips, as the JAX package does.

    :param images: (B, C, H, W), the same on every rank; a regular tile
        grid (overlap at most 50%) whose tile rows the 'tile' axis
        divides, B divisible by the 'data' axis
    :return: ``(bands, meta)``: this rank's band, ``(1, B_l, C, band,
        W_pad)`` (JAX's ``(S, B, C, band, W_pad)`` array holds every rank's
        at its ``(tile, data)`` place), and the static plan for
        :func:`assemble_bands`
    """
    x = _as_batch(images, mesh)
    b, c, h, w = x.shape
    grid = plan_patch_grid(h, w, patch_size, overlap)
    reg = _grid_steps(grid)
    if reg is None:
        raise ValueError("sharded reassembly needs a regular tile grid")
    th, tw, sh, sw = reg
    ph, pw = grid.patch_size
    S, D = mesh.shape["tile"], mesh.shape["data"]
    if th % S != 0:
        raise ValueError(f"{th} tile rows not divisible by tile axis {S}")
    if b % D != 0:
        raise ValueError(f"batch {b} not divisible by data axis")
    thl = th // S
    band = (thl - 1) * sh + ph
    tail = ph - sh
    d, t = mesh.coordinate()
    b_l = b // D

    tiles = extract_patches(x[d * b_l:(d + 1) * b_l], grid)
    tiles = tiles.reshape(th, tw, b_l, c, ph, pw)[t * thl:(t + 1) * thl]
    flat = tiles.transpose(1, 2).reshape(thl * b_l * tw, c, ph, pw)
    restored = polyblur_core(flat, device=mesh.device, **polyblur_kwargs)
    window = build_window((ph, pw), window_type, mesh.device).to(x.dtype)
    rest = restored.reshape(thl, b_l, tw, c, ph, pw) * window
    joined = _join_axis(torch.movedim(rest, 2, 0), sw, pw, axis=4)
    canvas = _join_axis(joined, sh, ph, axis=2)      # (B_l, C, band, W)
    canvas = _exchange_seam(canvas, tail, mesh)
    wsum = _window_band(grid, window_type, t * thl * sh, band, mesh.device)
    canvas = canvas / (wsum + 1e-8).to(canvas.dtype)
    meta = dict(grid=grid, thl=thl, step_h=sh, band=band, tail=tail,
                orig=grid.orig_size, pad=grid.pad)
    return clip_as_jax(canvas)[None], meta


def assemble_bands(bands: torch.Tensor, meta) -> torch.Tensor:
    """The (B, C, h, w) image of :func:`deblur_sharded_reassembly`'s bands.

    :param bands: (S, B, C, band, W_pad), the bands of tile ranks 0..S-1
        stacked (in one process S = 1: the band as returned; a caller that
        wants the image on one rank gathers the bands there first, e.g.
        with ``torch.distributed.all_gather`` over the 'tile' group)

    Pure slicing: the seams were exchanged already, so band d gives its
    first ``thl * step_h`` rows (its tail is the next band's completed
    head), the last band all of its rows.
    """
    s = bands.shape[0]
    keep = meta["thl"] * meta["step_h"]
    parts = [bands[d, :, :, :keep] for d in range(s - 1)] + [bands[s - 1]]
    canvas = torch.cat(parts, 2)
    pt, _, pl, _ = meta["pad"]
    h, w = meta["orig"]
    return canvas[:, :, pt:pt + h, pl:pl + w]
