"""Sums over index tables in a fixed order, with no atomics.

A sum of rows by an index (``index_add_``, the backward of a gather whose
indices repeat) runs in atomic order on a CUDA tensor, so two runs of the
same step may differ in the last bits.  Here such a sum is a segmented
sum: the rows are put in the order of a stable argsort of their indices,
and each segment (all the rows of one index) is summed from 0 in that
order, which is the order of the rows themselves, the order
``index_add_`` takes on the CPU.  ``torch.segment_reduce`` sums each
output entry in one thread, a row after the other, on either device.
Shapes are static and nothing is read back to the host, so the sums run
inside a captured CUDA graph.

The table (:class:`Segments`: the argsort and the count of each index) is
a function of the indices alone: where they are fixed (a mesh's faces, a
loss's edge list), it is built once, and a module keeps it as buffers
(:func:`register_segments`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Segments(NamedTuple):
    """The rows of each index in a fixed order.

    order: [N] or [B, N] int64, the positions of the rows sorted stably by
    index; counts: [n] or [B, n] int64, the rows of each index 0..n-1.  A
    1-d table serves every batch element alike."""
    order: torch.Tensor
    counts: torch.Tensor


def segments(index: torch.Tensor, n: int) -> Segments:
    """The table of index [N] or [B, N] (values in 0..n-1): a stable argsort
    and the counts, taken by an integer sum."""
    index = index.long()
    order = torch.argsort(index, dim=-1, stable=True)
    counts = torch.zeros(index.shape[:-1] + (n,), dtype=torch.int64,
                         device=index.device)
    counts.scatter_add_(-1, index, torch.ones_like(index))
    return Segments(order, counts)


def register_segments(module: torch.nn.Module, name: str, seg: Segments):
    """Keep seg in module as the buffers <name>_order and <name>_counts:
    they move with ``module.to()``, and they are not persistent (made
    from the indices), so the module's state_dict stays the same.
    :func:`module_segments` reads them back."""
    module.register_buffer(f'{name}_order', seg.order, persistent=False)
    module.register_buffer(f'{name}_counts', seg.counts, persistent=False)


def module_segments(module: torch.nn.Module, name: str):
    """The Segments :func:`register_segments` kept in module as name, or
    None where it keeps none."""
    order = getattr(module, f'{name}_order', None)
    if order is None:
        return None
    return Segments(order, getattr(module, f'{name}_counts'))


def segment_sum(values: torch.Tensor, seg: Segments) -> torch.Tensor:
    """values [B, N, ...] summed by the table's index: [B, n, ...], entry i
    the sum from 0 of the rows of index i in ascending row order (0 where
    none).  Differentiable: the gradient of a row is its index's."""
    B, N = values.shape[:2]
    rest = values.shape[2:]
    flat = values.reshape(B, N, -1)
    if seg.order.ndim == 1:
        rows = flat[:, seg.order]
        counts = seg.counts.expand(B, -1)
    else:
        rows = torch.gather(flat, 1, seg.order[..., None].expand_as(flat))
        counts = seg.counts
    out = torch.segment_reduce(rows, 'sum', lengths=counts, axis=1,
                               unsafe=True, initial=0.0)
    return out.reshape((B, out.shape[1]) + rest)


class _GatherRows(torch.autograd.Function):
    """x[:, index] whose backward sums the gradients of each row of x in a
    fixed order (segment_sum over the table of index)."""

    @staticmethod
    def forward(ctx, x, index, order, counts):
        ctx.save_for_backward(order, counts)
        ctx.nx = x.shape[1]
        if index.ndim == 1:
            return x[:, index]
        bidx = torch.arange(x.shape[0], device=x.device)[:, None]
        return x[bidx, index]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        order, counts = ctx.saved_tensors
        out = segment_sum(grad, Segments(order, counts))
        if out.shape[1] < ctx.nx:  # rows past the table's: no index names them
            out = torch.nn.functional.pad(
                out, (0, 0) * (out.ndim - 2) + (0, ctx.nx - out.shape[1]))
        return out, None, None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor,
                seg: Segments = None) -> torch.Tensor:
    """x [B, n, ...] gathered along dim 1 by index [N] or [B, N] (int):
    [B, N, ...].  Its gradient sums each row's gradients in a fixed order,
    over ``seg`` (the table of index, :func:`segments`; None: made here)."""
    index = index.long()
    if seg is None:
        seg = segments(index, x.shape[1])
    return _GatherRows.apply(x, index, seg.order, seg.counts)
