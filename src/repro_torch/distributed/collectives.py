"""The mesh's axes, their process groups, and the collectives of the mesh
forms of attention and the MoE FFN.

Every rank runs the model on its own rows; compute outside a
tensor-parallel region is replicated over ``'model'``.  A region splits
work over ``'model'`` (attention heads, expert-ff slices, whole experts)
and is closed by Megatron's conjugate operators, so that every rank's
backward of its own loss gives the single-device gradient:

* ``enter_tp`` at a region's entry: identity forward, all-reduce over
  ``'model'`` backward (each rank's slice contributes its part of the
  input's gradient);
* ``exit_gather`` at its exit: all-gather forward, this rank's slice of
  the gradient backward;
* ``exit_reduce`` at its exit: all-reduce forward, identity backward;
* ``all_to_all`` over ``'model'`` for expert parallelism, whose backward
  is the reverse exchange, scaled by ``grad_scale`` (``1/|model|`` at the
  region's exit, where every rank sends the same gradient).

Every collective runs on the groups of single mesh axes
(``DeviceMesh.get_group``).  One over a tuple of axes such as
``('pod', 'data')`` runs once per axis: a sum over each axis in turn is
the sum over their product, and a gather over the inner axis and then the
outer one concatenates the blocks pod-major, as JAX orders them (a
reduce-scatter cuts them in the same order, the outer axis first).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["axis_sizes", "axis_coords", "group_size", "gather_dim", "all_reduce", "reduce_scatter",
           "broadcast_from",
           "enter_tp", "exit_gather", "exit_reduce", "all_to_all", "mean_value"]

Axes = Union[str, Sequence[str]]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (in its order) or a mapping.

    Example:
        >>> axis_sizes({"data": 2, "model": 2})
        {'data': 2, 'model': 2}
    """
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on every axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def group_size(mesh, axes: Axes) -> int:
    """Ranks over ``axes``: the product of their sizes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _tuple(axes))


def gather_dim(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """All-gather ``x`` over ``axes`` and concatenate along ``dim``,
    pod-major: one gather per axis, the innermost first."""
    for a in reversed(_tuple(axes)):
        group = mesh.get_group(a)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        x = torch.cat(parts, dim)
    return x


def all_reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum ``x`` in place over every rank of ``axes`` (one all-reduce per
    axis); returns ``x``."""
    for a in _tuple(axes):
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """Sum ``x`` over every rank of ``axes`` and keep this rank's block of
    dim ``dim``, pod-major (the block ``sharding.local_block`` cuts): one
    reduce-scatter per axis, the outermost first.  Returns a new tensor
    (``x`` itself over axes of one rank in all); off dim 0 a view of it,
    not contiguous."""
    for a in _tuple(axes):
        group = mesh.get_group(a)
        n = dist.get_world_size(group)
        if n == 1:
            continue
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        x = out.movedim(0, dim)
    return x


def broadcast_from(x: torch.Tensor, mesh, axes: Axes, src: int) -> torch.Tensor:
    """The rank at index ``src`` of the group of ``axes`` (pod-major)
    sends its ``x`` to every rank of that group; the others pass a buffer
    of the same shape and dtype, filled in place.  One broadcast per axis,
    the innermost first, among the ranks that share the sender's
    coordinates on the axes outside it.  Returns ``x``."""
    axes = _tuple(axes)
    sizes, coords = axis_sizes(mesh), axis_coords(mesh)
    at = {}
    for a in reversed(axes):
        at[a], src = src % sizes[a], src // sizes[a]
    for i in reversed(range(len(axes))):
        a = axes[i]
        if sizes[a] == 1 or any(coords[b] != at[b] for b in axes[:i]):
            continue
        group = mesh.get_group(a)
        dist.broadcast(x, src=dist.get_global_rank(group, at[a]), group=group)
    return x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ExitGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = mesh.get_local_rank(axis)
        return gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None


class _ExitReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.group, ctx.scale = group, grad_scale
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return (out * ctx.scale if ctx.scale != 1 else out), None, None


def enter_tp(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """A tensor-parallel region's entry: identity forward; the backward
    sums the ranks' gradients over ``axis``."""
    return _Enter.apply(x, mesh.get_group(axis))


def exit_gather(x: torch.Tensor, mesh, dim: int, axis: str = "model") -> torch.Tensor:
    """A region's exit that concatenates the ranks' slices along ``dim``
    (in ``axis`` order); the backward keeps this rank's slice."""
    return _ExitGather.apply(x, mesh, axis, dim)


def exit_reduce(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """A region's exit that sums the ranks' partial results over ``axis``;
    the backward passes the gradient through."""
    return _ExitReduce.apply(x, mesh.get_group(axis))


def all_to_all(x: torch.Tensor, mesh, axis: str = "model",
               grad_scale: float = 1.0) -> torch.Tensor:
    """Exchange ``x``'s dim-0 blocks over ``axis``: block ``j`` goes to rank
    ``j``, and the result's block ``j`` came from rank ``j`` (``x.shape[0]``
    is the axis size).  The backward is the reverse exchange times
    ``grad_scale``."""
    return _AllToAll.apply(x, mesh.get_group(axis), grad_scale)


class _MeanValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        total = all_reduce(x.to(torch.float32).clone(), mesh, axes)
        return (total / group_size(mesh, axes)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def mean_value(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x``'s mean over the group of ``axes``, whose gradient is passed to
    this rank's ``x`` as it is (the caller averages gradients over the
    same ranks, as a loss term's mean over data shards wants)."""
    return _MeanValue.apply(x, mesh, _tuple(axes))
