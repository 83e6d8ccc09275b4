"""Mesh construction and sharding helpers (port of
``absolutetrack_tpu/parallel/mesh.py``).

A JAX mesh is one process holding a grid of devices. Here it is a grid
over the ranks of the process group, one rank per device, with the JAX
axis names and order: ``data`` outer, ``model`` innermost, so rank
``d * model + m`` sits at (d, m). The port's own small class stands in for
``torch.distributed.device_mesh.DeviceMesh``: that one binds each rank to
the card of its local rank, which two gloo ranks sharing one card cannot
have, and the port's collectives run over the whole world anyway (each
rank takes the rows of its own axis from one all-gather), so no subgroup
is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ('data', 'model') grid of ranks."""

    data: int
    model: int
    rank: int
    device: torch.device

    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def grid(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` as a (data, model, ...) grid, identical on
        every rank."""
        if self.size == 1:
            return x[None, None]
        return distributed.all_gather(x).reshape((self.data, self.model) + x.shape)

    def objects(self, obj) -> list:
        """Every rank's picklable ``obj`` in rank order."""
        return [obj] if self.size == 1 else distributed.all_gather_objects(obj)

    def barrier(self) -> None:
        if self.size > 1:
            torch.distributed.barrier()

    def local_views(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """This rank's contiguous block of the view axis, by its ``model``
        coordinate (views sharded over 'model')."""
        v = x.shape[axis]
        if v % self.model:
            raise ValueError(f"{v} views do not split over a model axis of {self.model}")
        k = v // self.model
        return x.narrow(axis, self.model_index * k, k)

    def gather_views(self, x: torch.Tensor) -> torch.Tensor:
        """(B, V / model, ...) features of this rank's views -> (B, V, ...)
        of all views, through autograd."""
        return _GatherViews.apply(x, self)


class _GatherViews(torch.autograd.Function):
    """All-gather of the view axis over the ranks of one data row.

    Its backward returns the gradient of this rank's own views as it is,
    without a reduce-scatter: every model rank runs the same work after
    the gather (fusion, the ConvRNN, the regressor, the loss), so each
    holds the whole gradient of every view already, and summing them
    would count each view's gradient ``model`` times.
    """

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        row = mesh.grid(x)[mesh.data_index]  # (model, B, V / model, ...)
        return torch.cat(list(row), dim=1)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        k = grad.shape[1] // mesh.model
        return grad.narrow(1, mesh.model_index * k, k), None


def make_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> Mesh:
    """('data', 'model') mesh over the ranks of the process group.

    ``data=None`` takes world // model. The world must hold exactly
    ``data * model`` ranks: without such a process group this raises, and
    never runs one process in place of several (a 1 x 1 mesh needs none).
    ``devices`` is this rank's device (``cuda`` unless given; a card
    without an index is the rank's local one) or a sequence of devices
    indexed by rank.
    """
    rank, world = distributed.process_shard()
    if data is None:
        if world % model:
            raise ValueError(f"a world of {world} ranks does not split over a model axis of {model}")
        data = world // model
    if data * model != world:
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs a process group of {data * model} ranks and this process has "
            f"{world}: launch one rank per device, e.g. `torchrun --nproc-per-node {data * model} -m <module> ...` "
            "(or `python -m torch.distributed.run`), or call parallel.init_distributed first"
        )
    if isinstance(devices, (list, tuple)):
        devices = devices[rank]
    return Mesh(data, model, rank, distributed.rank_device(devices))


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_block(mesh: Mesh, x, batch_axis: int = 0):
    """This rank's contiguous block of ``x``'s batch axis, by its ``data``
    coordinate (the same on every ``model`` rank), as a tensor on the
    mesh's device; an array with no such axis whole."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if x.ndim > batch_axis:
        n = x.shape[batch_axis]
        if n % mesh.data:
            raise ValueError(f"a batch of {n} does not split over a data axis of {mesh.data}")
        k = n // mesh.data
        x = x.narrow(batch_axis, mesh.data_index * k, k)
    return x.to(mesh.device)


def shard_batch(mesh: Mesh, tree, batch_axis: int = 0):
    """This rank's block of a host pytree: the rows that
    ``NamedSharding(mesh, P("data"))`` places on its device."""
    return _tree_map(lambda x: shard_block(mesh, x, batch_axis), tree)


def window_shard(arr: np.ndarray, window: int, time_axis: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Split (B, T, ...) sequences into (B * n_win, window, ...) windows.

    Temporal-window sharding: each window is an independent batch element
    whose first frame runs with cold memory (use_memory=False), mirroring
    the reference's batched unroll semantics
    (run_inference_torch_data.py:50-53). Returns (windows, use_memory) with
    use_memory shaped (B * n_win, window): False at each window start.

    T must divide by ``window``; trim or pad upstream.
    """
    arr = np.moveaxis(arr, time_axis, 1)
    b, t = arr.shape[:2]
    if t % window:
        raise ValueError(f"T={t} does not divide by the window {window}")
    n_win = t // window
    out = arr.reshape(b * n_win, window, *arr.shape[2:])
    use_memory = np.ones((b * n_win, window), bool)
    use_memory[:, 0] = False
    return out, use_memory
