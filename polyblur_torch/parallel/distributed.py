"""Multi-process initialization and topology-aware meshes (port of
polyblur_tpu/parallel/distributed.py).

The reference is single-device (SURVEY.md §2.6); this module is the
scale-out half of the distributed story (``parallel.sharding`` holds the
paths): bring up the default ``torch.distributed`` process group and lay
out the ``('data', 'tile')`` mesh so that the data axis spans nodes while
the tile axis stays within each node — batch-outer, tile-inner, so that
the seam exchange between tile ranks never leaves a node.

A JAX process is a host driving all of its chips; a PyTorch process
drives one card, and ``torchrun`` starts one per card. What a JAX process
is to the mesh layout is therefore a node here: the node count is
``WORLD_SIZE // LOCAL_WORLD_SIZE`` (torchrun's variables).

A single process needs no initialization: ``parallel.sharding`` then runs
at world size 1 with no collective.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..pipeline import resolve_device
from .sharding import Mesh, make_mesh

__all__ = ["initialize_distributed", "make_multihost_mesh",
           "process_topology"]


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None, device=None) -> bool:
    """Bring up the default process group if this is a multi-process job.

    Arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the address), ``WORLD_SIZE``, ``RANK`` and, for the
    card, ``LOCAL_RANK``.

    :param coordinator_address: ``host:port`` of rank 0's rendezvous, or
        an init-method URL (``tcp://...``, ``file://...``)
    :param local_device_ids: the index of this process's card (an int or a
        one-element sequence; one process drives one card)
    :param device: ``"cuda"`` (the default: NCCL; raises without a card)
        or ``"cpu"`` (gloo)
    :returns: True if the group was (or already is) live, False for an
        ordinary single-process run (no arguments and no environment).
        Safe to call repeatedly: a live group is kept as it is. An
        explicit ``num_processes=1`` with no address brings up a world of
        one on an in-process store.
    """
    env = os.environ
    if (coordinator_address is None and env.get("MASTER_ADDR")
            and env.get("MASTER_PORT")):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        return False
    if num_processes is None:
        raise ValueError("initialize_distributed: an address needs "
                         "num_processes (or WORLD_SIZE)")
    if process_id is None and num_processes != 1:
        raise ValueError("initialize_distributed: a job of "
                         f"{num_processes} processes needs process_id (or "
                         "RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_device_ids is None:
            index = (dev.index if dev.index is not None
                     else int(env.get("LOCAL_RANK", 0)))
        else:
            ids = ([local_device_ids] if isinstance(local_device_ids, int)
                   else list(local_device_ids))
            if len(ids) != 1:
                raise ValueError(f"local_device_ids={local_device_ids}: one "
                                 "process drives one card")
            index = ids[0]
        torch.cuda.set_device(index)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError("initialize_distributed: a job of "
                             f"{num_processes} processes needs "
                             "coordinator_address (or MASTER_ADDR and "
                             "MASTER_PORT)")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
        return True
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes,
                            rank=process_id or 0)
    return True


def process_topology(device=None):
    """(number of processes, the device of each rank in rank order).

    Under NCCL rank r drives card ``r % LOCAL_WORLD_SIZE`` of its node
    (torchrun's layout), under gloo the CPU; with no group the one rank
    has ``device`` (default: the card; raises without one).
    """
    if not dist.is_initialized():
        return 1, [resolve_device(device)]
    n = dist.get_world_size()
    if dist.get_backend() != "nccl":
        return n, [torch.device("cpu")] * n
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return n, [torch.device("cuda", r % local) for r in range(n)]


def _node_count(n_proc: int) -> int:
    """Nodes of the job: ``WORLD_SIZE // LOCAL_WORLD_SIZE`` (one node when
    torchrun's ``LOCAL_WORLD_SIZE`` is not set)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n_proc))
    if local < 1 or n_proc % local != 0:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the "
                         f"world of {n_proc} processes")
    return n_proc // local


def make_multihost_mesh(data_axis: int | None = None,
                        allow_tile_across_hosts: bool = False,
                        device=None) -> Mesh:
    """``('data', 'tile')`` mesh with the data axis spanning nodes.

    With N nodes of L cards each the default mesh is (N, L): every
    tile-axis collective (the reassembly's seam exchange) runs between
    the cards of one node, over NVLink; only the batch axis, which the
    paths communicate on only for training's gradient sum, crosses nodes.
    ``data_axis`` overrides the data extent; it must be a multiple of the
    node count, so that no data shard straddles nodes.

    ``allow_tile_across_hosts=True`` relaxes that rule for the
    tile-dominant layout (one large image over every card of a job,
    ``data_axis=1``): the seam exchange then crosses nodes at their
    boundaries. Keep the default strict: with batch parallelism available,
    tile shards straddling nodes is a layout fault.

    :param device: this rank's device where no group is live (see
        ``sharding.make_mesh``)
    """
    n_proc, _ = process_topology(device)
    nodes = _node_count(n_proc)
    if data_axis is None:
        data_axis = nodes
    if data_axis % nodes != 0 and not allow_tile_across_hosts:
        raise ValueError(
            f"data_axis={data_axis} incompatible with {nodes} nodes: "
            "a data shard would straddle hosts (pass "
            "allow_tile_across_hosts=True for the tile-dominant layout)")
    return make_mesh(device, data_axis)
