"""Core layers: linear, embedding, swish, dropout and the MLP helper
(counterpart of mvae_tpu/nn/layers.py).

Weights are stored f32 and cast to the input's dtype at use, so a bf16
activation runs a bf16 matmul while the parameters stay f32 (the JAX
package's mixed-precision rule, mvae_tpu/nn/dcgan.py:_cast).

Tensor parallelism (parallel/mesh.py:shard_params_tp sets a Linear's `tp`
to a TPRole): a column layer holds its rank's output features, takes its
input through copy_to_tp and adds its bias slice; a row layer holds its
rank's input features, reduces its partial product in f32 across the tp
group and adds its replicated bias in the input's dtype, so a bf16 layer
rounds once, as on one device; a column layer that ends its MLP list
(`gather`) all-gathers its features. The swish between a pair is
elementwise and runs on the rank's columns.
"""

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from mvae_tpu_torch.nn.initializers import (
    kaiming_uniform_bound, normal_, uniform_)
from mvae_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp, gather_from_tp, reduce_from_tp)


class TPRole(NamedTuple):
    """A linear layer's part in tensor parallelism: kind "col" (output
    features sharded) or "row" (input features sharded) over the tp
    group; gather: a column layer whose features are all-gathered after
    it (the last layer of its MLP list)."""
    kind: str
    group: object
    gather: bool = False


def linear(x, weight, bias=None, tp=None, product=F.linear):
    """x @ weight.T + bias in x's dtype; weight is torch's (out, in). The
    product rounds to x's dtype before the bias is added, as `x @ w + b`
    does in the JAX package (F.linear's fused bias would round once).
    tp: the layer's TPRole, or None (see the module docstring).
    product(x, w): x @ w.T (torch.bmm's for stacked layers)."""
    if tp is not None and tp.kind == "row":
        part = product(x.float(), weight.to(x.dtype).float())
        y = reduce_from_tp(part, tp.group).to(x.dtype)
    else:
        if tp is not None:
            x = copy_to_tp(x, tp.group)
        y = product(x, weight.to(x.dtype))
    y = y if bias is None else y + bias.to(x.dtype)
    if tp is not None and tp.gather:
        y = gather_from_tp(y, -1, tp.group)
    return y


class _Swish(torch.autograd.Function):
    """x * s with s = sigmoid(x); its backward is JAX's, g * s + (x * g) *
    (s * (1 - s)), each step in x's dtype: jax.nn.sigmoid differentiates
    as s * (1 - s) of its own output. Autograd through 1 / (1 + exp(-x))
    would multiply the reciprocal's zero gradient by exp(-x) = inf wherever
    x < -88.7 and give NaN, which then spreads through every earlier
    layer."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


def swish(x):
    """x * sigmoid(x), in x's dtype (mnist/model.py:166-169). The sigmoid is
    1 / (1 + exp(-x)) with each step rounded to x's dtype: the form JAX
    lowers `jax.nn.sigmoid` to (lax.logistic has no HLO primitive), so a
    bf16 swish rounds where the JAX package's does. torch.reciprocal is
    one kernel where `1 / t` is two (a reciprocal, then a multiply by 1).
    The gradient is JAX's (_Swish), finite at any x."""
    return _Swish.apply(x)


class Linear(nn.Module):
    tp = None           # a TPRole under tensor parallelism

    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((d_out, d_in), device=device))
        self.bias = nn.Parameter(torch.empty((d_out,), device=device))

    def reset_parameters(self, generator):
        bound = kaiming_uniform_bound(self.weight.shape[1])
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.tp)


class Embedding(nn.Module):
    """Index lookup in a (num, dim) f32 table, torch's key `.weight`. The
    JAX package's `one_hot @ table` (models/mnist.py:59-61) picks the same
    values: a one-hot row times the table is one of its rows exactly, in
    f32, and in bf16 with the table cast first (callers cast the rows)."""

    def __init__(self, num: int, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((num, dim), device=device))

    def reset_parameters(self, generator):
        normal_(self.weight, generator)

    def forward(self, idx):
        return F.embedding(idx.long(), self.weight)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


def mlp(dims, *, final_activation: bool = False, device=None):
    """Linear layers dims[0] -> ... -> dims[-1] with a Swish between them
    (and after the last if final_activation), as one nn.Sequential whose
    indices are the reference's: the i-th Linear sits at index 2i
    (counterpart of mlp_init / mlp_apply, mvae_tpu/nn/layers.py:36-50)."""
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(Linear(a, b, device=device))
        if i < len(dims) - 2 or final_activation:
            layers.append(Swish())
    return nn.Sequential(*layers)


def dropout(x, keep_mask, rate: float):
    """where(keep_mask, x / keep, 0) in x's dtype, keep = 1 - rate
    (nn/layers.py:28-33). keep is rounded to x's dtype first, as JAX's
    weakly typed scalar is, so a bf16 x is divided by bf16(0.9)."""
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(keep_mask, x / keep, 0.0)


class Dropout(nn.Module):
    """Identity in eval mode. In train mode it takes the keep-mask (a bool
    tensor of x's shape) from the caller: the port draws no random numbers
    inside the model, so the noise can be fed from anywhere (the train
    step's generator, or the JAX package's draws in the tests)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, keep_mask=None):
        if not (self.training and self.p):
            return x
        if keep_mask is None:
            raise ValueError("train-mode dropout takes its keep-mask from "
                             "the caller")
        return dropout(x, keep_mask, self.p)
