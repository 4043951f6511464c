"""Training loop for the differentiable deblurring layer (port of
polyblur_tpu/training.py).

Fits the pipeline scalars (c, b, alpha, beta) of a learnable
:class:`~polyblur_torch.layers.PolyblurLayer` end to end with a
``torch.optim`` optimizer (Adam by default, as the JAX package's optax
default). ``remat=True`` on the layer checkpoints each iteration so that
the backward pass stays memory-bounded at megapixel sizes (BASELINE
config 5).

Persistence:

* :func:`save_params` / :func:`load_params` — the fitted scalars as JSON
  in the JAX package's layout, ``{"params": {"alpha", "b", "beta", "c"}}``,
  so a file written by either package loads in the other;
* :func:`save_checkpoint` / :func:`load_checkpoint` — the resume-a-run
  form: parameters, optimizer state and step through ``torch.save`` (the
  JAX package uses orbax).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Tuple

import torch

from .layers import SCALARS

__all__ = ["make_train_step", "fit_layer", "layer_params", "save_params",
           "load_params", "save_checkpoint", "load_checkpoint"]


def layer_params(layer) -> dict:
    """The learnable scalars of a layer as ``{"params": {name: float}}``,
    the JAX package's params layout."""
    return {"params": {name: float(getattr(layer, name).detach())
                       for name in SCALARS
                       if isinstance(getattr(layer, name), torch.Tensor)}}


def _nested(params) -> dict:
    """``{"params": {name: value}}`` of a layer, a flat state dict or an
    already nested dict."""
    if isinstance(params, torch.nn.Module):
        return layer_params(params)
    if "params" in params:
        return {"params": dict(params["params"])}
    return {"params": dict(params)}


def save_params(params, path: str) -> None:
    """Write the scalar parameters as JSON (sorted keys, one space
    indent: the JAX package's file). ``params`` is a layer, its
    ``state_dict()`` or the nested ``{"params": ...}`` dict."""
    nested = {"params": {k: float(v)
                         for k, v in _nested(params)["params"].items()}}
    with open(path, "w") as f:
        json.dump(nested, f, indent=1, sort_keys=True)


def load_params(path: str) -> dict:
    """Inverse of :func:`save_params` (and of the JAX package's): the
    nested dict with 0-d f32 tensors as leaves;
    ``layer.load_state_dict(load_params(path)["params"])`` restores a
    layer."""
    with open(path) as f:
        nested = json.load(f)
    return {"params": {k: torch.tensor(v, dtype=torch.float32)
                       for k, v in _nested(nested)["params"].items()}}


def save_checkpoint(path: str, params, opt_state=None, step=None) -> None:
    """Full training state in one file (written atomically): ``params`` (a
    layer or its ``state_dict()``), the optimizer state (an optimizer or
    its ``state_dict()``) and the step counter."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(opt_state, torch.optim.Optimizer):
        opt_state = opt_state.state_dict()
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if step is not None:
        state["step"] = int(step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location=None) -> dict:
    """Inverse of :func:`save_checkpoint`: ``{"params", "opt_state",
    "step"}`` (the keys that were saved), for ``layer.load_state_dict``
    and ``optimizer.load_state_dict``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def _l2(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((out - target) ** 2)


def make_train_step(layer, optimizer,
                    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor] = _l2):
    """One optimizer step over a (blurry, sharp) pair.

    :param layer: e.g. ``PolyblurLayer(learnable=True)``
    :param optimizer: a ``torch.optim`` optimizer over its parameters
    :returns: ``step(blurry, sharp) -> loss`` (a detached 0-d tensor); the
        gradients of the step stay in the parameters' ``.grad``
    """
    def step(blurry, sharp):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(layer(blurry), sharp)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit_layer(layer, blurry, sharp, steps: int = 10,
              learning_rate: float = 1e-2, optimizer=None,
              loss_fn: Callable = _l2) -> Tuple[dict, list]:
    """Fit a learnable layer's scalars on one supervised pair.

    :param layer: ``PolyblurLayer(learnable=True, ...)``
    :param blurry: (B, C, H, W) degraded input
    :param sharp: (B, C, H, W) ground truth
    :param optimizer: default ``torch.optim.Adam(layer.parameters(),
        learning_rate)``
    :returns: (the trained params as ``{"params": {name: float}}``, the
        list of per-step float losses)
    """
    dev = layer.device
    blurry = torch.as_tensor(blurry, device=dev)
    sharp = torch.as_tensor(sharp, device=dev)
    if optimizer is None:
        optimizer = torch.optim.Adam(layer.parameters(), lr=learning_rate)
    step = make_train_step(layer, optimizer, loss_fn)
    losses = [float(step(blurry, sharp)) for _ in range(int(steps))]
    return layer_params(layer), losses
