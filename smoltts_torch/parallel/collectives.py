"""Collectives that carry gradients, for training on a `Mesh` (mesh.py).

Where GSPMD derives a sharded program's collectives, and their transposes
for the backward pass, from the layouts, the port calls them by hand. Each
is a `torch.autograd.Function` with its backward written out:

- `copy_model`: forward identity, backward a sum over the model axis. At
  the input of every column-parallel product (the rank's columns give a
  partial gradient of the input), and on a whole weight used on a rank's
  share of the sequence.
- `reduce_model` / `reduce_data`: forward a sum over the axis, backward
  identity. After each row-parallel product and each lookup in a row-split
  table; over `data`, the loss's NLL sums.
- `gather_model`: forward the model ranks' slices concatenated, backward
  this rank's slice. Vocab- and codebook-split logits, and the sequence
  after a sequence-parallel trunk (what follows runs alike on every rank).
- `gather_model_rs` / `reduce_scatter_model`: a gather whose backward sums
  over the axis and takes this rank's slice, and its transpose (Megatron
  sequence parallelism; the K/V of a sequence-parallel attention).
- `scatter_model`: forward this rank's slice, backward a gather.
- `sum_data` and `sum_data_flat`: sums over `data` with no gradient (token
  counts, the step's gradients).

A bare `dist.all_reduce` records nothing for autograd, and
`torch.distributed.nn.functional.all_reduce` sums the gradient of a
replicated value over the ranks, multiplying it by their count: neither
gives the gradients of one process. Gathers are `mesh.gather` (one
all-reduce, the same bits on every rank); a reduce-scatter is an all-reduce
followed by a slice, since gloo takes only `all_reduce` and `broadcast` on
CUDA tensors.

`TRAFFIC` counts the all-reduces these functions issue and their bytes, in
this process, for the record (`reset_traffic`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from smoltts_torch.parallel.mesh import Mesh, gather

TRAFFIC = {"all_reduce": 0, "bytes": 0}


def reset_traffic() -> None:
    TRAFFIC.update(all_reduce=0, bytes=0)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of a contiguous copy of x."""
    out = x.contiguous().clone()
    TRAFFIC["all_reduce"] += 1
    TRAFFIC["bytes"] += out.numel() * out.element_size()
    dist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, group, n: int, index: int, dim: int) -> torch.Tensor:
    TRAFFIC["all_reduce"] += 1
    TRAFFIC["bytes"] += n * (-(-x.numel() * x.element_size() // 8) * 8)
    return gather(group, n, index, [x], dim)[0]


def _slice(x: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Forward gather; backward this rank's slice, or with `rs` the sum over
    the axis and then this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim, rs):
        ctx.args = group, n, index, dim, rs
        return _gather(x, group, n, index, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, index, dim, rs = ctx.args
        if rs:
            g = _all_reduce(g, group)
        return _slice(g, n, index, dim), None, None, None, None, None


class _Scatter(torch.autograd.Function):
    """Forward this rank's slice (of the sum over the axis with `reduce`);
    backward a gather."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim, reduce):
        ctx.args = group, n, index, dim
        if reduce:
            x = _all_reduce(x, group)
        return _slice(x, n, index, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, index, dim = ctx.args
        return _gather(g.contiguous(), group, n, index, dim), None, None, None, None, None


def _model(mesh) -> bool:
    return mesh is not None and mesh.n_model > 1


def copy_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Copy.apply(x, mesh.model_group) if _model(mesh) else x


def reduce_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Reduce.apply(x, mesh.model_group) if _model(mesh) else x


def reduce_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh is None or mesh.n_data == 1:
        return x
    return _Reduce.apply(x, mesh.data_group)


def gather_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    if not _model(mesh):
        return x
    return _Gather.apply(x, mesh.model_group, mesh.n_model, mesh.model, dim % x.dim(), False)


def gather_model_rs(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    if not _model(mesh):
        return x
    return _Gather.apply(x, mesh.model_group, mesh.n_model, mesh.model, dim % x.dim(), True)


def scatter_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    if not _model(mesh):
        return x
    return _Scatter.apply(x, mesh.model_group, mesh.n_model, mesh.model, dim % x.dim(), False)


def reduce_scatter_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    if not _model(mesh):
        return x
    return _Scatter.apply(x, mesh.model_group, mesh.n_model, mesh.model, dim % x.dim(), True)


def sum_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the model axis, with no gradient."""
    return _all_reduce(x.detach(), mesh.model_group) if _model(mesh) else x


def sum_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the data axis, with no gradient."""
    if mesh is None or mesh.n_data == 1:
        return x
    return _all_reduce(x.detach(), mesh.data_group)


def sum_data_flat(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor summed over the data axis, with one all-reduce per dtype
    (the tensors packed into one flat buffer)."""
    tensors = list(tensors)
    if mesh is None or mesh.n_data == 1:
        return tensors
    out: List[torch.Tensor] = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = _all_reduce(torch.cat([tensors[i].detach().reshape(-1) for i in idx]),
                           mesh.data_group)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out
