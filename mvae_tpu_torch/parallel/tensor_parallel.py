"""The collectives of tensor and expert parallelism over a tp group (the
JAX mesh's "model" axis), as autograd ops: GSPMD inserts them for the JAX
package (mvae_tpu/parallel/mesh.py), the port writes them out.

    copy_to_tp(x)         forward the identity; backward all-reduces the
                          gradient (a column layer's input: each rank's
                          columns give a part of it)
    reduce_from_tp(x)     forward all-reduces (a row layer's partial
                          products); backward the identity
    gather_from_tp(x, d)  forward all-gathers along d (a trailing column
                          layer's features, the experts' outputs);
                          backward keeps this rank's slice of the
                          gradient. Every rank of the group holds the
                          whole, equal gradient downstream, so the slice
                          is the gradient; a reduce-scatter would multiply
                          it by the group's size.

Only all_reduce, all_gather and broadcast: gloo, which ranks that share a
card use, has no reduce_scatter. `calls` counts the collectives of all
three, forward and backward, as collectives.all_reduce_sum.calls counts
the data-parallel group's.
"""

import threading

import torch
import torch.distributed as dist

_LOCK = threading.Lock()
calls = 0


def _counted():
    global calls
    with _LOCK:
        calls += 1


def all_reduce(t, group):
    """t summed across the group, in place: one collective."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _counted()
    return t


def all_gather(t, dim, group):
    """The group's tensors of t's shape joined along dim, in rank order:
    one collective."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    _counted()
    return torch.cat(parts, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def copy_to_tp(x, group):
    return _Copy.apply(x, group)


def reduce_from_tp(x, group):
    return _Reduce.apply(x, group)


def gather_from_tp(x, dim, group):
    return _Gather.apply(x, dim % x.ndim, group)
