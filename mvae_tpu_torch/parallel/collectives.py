"""The all-reduces of the data-parallel path, over a torch.distributed
process group.

`all_reduce_sum` sums tensors across the group's ranks in one collective
(the BN passes' (G, C) sums), `sum_in_place` one tensor in place (the
gradients' flat buffer, the logged losses);
`all_reduce_sum_grad` is the same sum as an autograd op, whose backward
sums the incoming gradients across the ranks in one collective too: the
fused route's BN sums (nn/norm.py:bn_swish_from_moments) are
differentiable, and each rank's loss depends on every rank's sums.
(torch.distributed.nn.functional.all_reduce does the same and is
deprecated.)

`all_reduce_sum.calls` counts the collectives of all three (forward and
backward), as a kernel's wrapper counts its launches
(ops/_cuda.py:launched).
"""

import threading

import torch
import torch.distributed as dist

_LOCK = threading.Lock()


def sum_in_place(group, t):
    """Sum t across the group's ranks, in place: one collective."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    with _LOCK:
        all_reduce_sum.calls += 1
    return t


def all_reduce_sum(group, *tensors):
    """The sums across the group's ranks of same-shaped, same-dtype
    tensors, as new tensors, in one collective over their stack."""
    return tuple(sum_in_place(group, torch.stack(tensors)).unbind(0))


all_reduce_sum.calls = 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return all_reduce_sum(group, *tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_sum(ctx.group, *grads))


def all_reduce_sum_grad(group, *tensors):
    """all_reduce_sum, differentiable: the gradient of a rank's sums is the
    sum across the ranks of the gradients they receive."""
    return _AllReduceSum.apply(group, *tensors)
