"""BatchNorm with explicit running statistics, torch semantics (counterpart
of mvae_tpu/nn/norm.py:56-160).

Eval mode normalizes with the running statistics, eps 1e-5. The math runs
in f32 whatever the input's dtype, and the result returns in the input's
dtype; the Swish that follows every BN in the reference nets then runs in
that dtype (nn/norm.py:158-160).

Train mode runs the fused BN + swish op (ops/bn.py:bn_swish_train, the
JAX package's Pallas path, nn/norm.py:145-157) with `groups` sets of batch
statistics, and so also applies the swish that follows it:
`BNSwishSequential` then skips that Swish. The forward never touches the
running buffers. It keeps its batch moments on the module; the model's
encode/decode collect them (`pop_moments`) and the engine commits the EMA
(core/engine.py:commit_ema_states), momentum 0.1, with the unbiased
variance, n = the rows and positions of one group.

`stacked_bn` runs k BatchNorms of one width as one call over their
channels side by side (vision's stacked modality groups, nn/dcgan.py:
stacked).

`bn_swish_from_moments` is the train-mode BN + swish of a conv whose batch
moments came with its output (ops/convbn.py:conv2d_moments, the encoder's
fused route; nn/norm.py:105-126 in the JAX package): plain PyTorch, since
the JAX package writes it in jnp.
"""

from typing import NamedTuple

import torch
from torch import nn

from mvae_tpu_torch.nn.layers import Swish, swish
from mvae_tpu_torch.ops.bn import bn_swish_train

EPS = 1e-5
# torch's default; commit_ema_states assumes every BN uses it
BN_MOMENTUM = 0.1


def batchnorm_eval(x, mean, var, scale, bias, eps: float = EPS):
    """x: (N, C, ...) in any float dtype; statistics and affine (C,) f32."""
    shape = (-1,) + (1,) * (x.ndim - 2)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    y = ((x.float() - mean.reshape(shape)) * inv.reshape(shape)
         * scale.reshape(shape) + bias.reshape(shape))
    return y.to(x.dtype)


class Moments(NamedTuple):
    """One train-mode BN call's batch statistics, for the EMA commit."""
    bn: "BatchNorm"
    mean: torch.Tensor      # (G, C) f32, biased
    var: torch.Tensor       # (G, C) f32, biased
    n: int                  # elements a group and channel: rows * positions
    terms: object = None    # (G,) long: the ELBO terms of the G groups
                            # where they are not all T (--fast-term-decode)


class BatchNorm(nn.Module):
    """Keys and buffers of torch's BatchNorm1d/2d (weight, bias,
    running_mean, running_var, num_batches_tracked), channel axis 1.
    `groups`: how many sets of batch statistics a train-mode call keeps,
    over consecutive blocks of rows (the decoders' ELBO terms); `terms`:
    which ELBO terms those groups are, where not all of them."""

    def __init__(self, c: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c,), device=device))
        self.bias = nn.Parameter(torch.empty((c,), device=device))
        self.register_buffer("running_mean", torch.empty((c,), device=device))
        self.register_buffer("running_var", torch.empty((c,), device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))
        self.groups = 1
        self.terms = None
        self.moments = None

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x):
        """Eval: BN alone. Train: swish(BN(x)) with batch statistics."""
        if not self.training:
            return batchnorm_eval(x, self.running_mean, self.running_var,
                                  self.weight, self.bias)
        y, mean, var = bn_swish_train(x, self.weight, self.bias, self.groups)
        self.moments = Moments(self, mean, var,
                               x.numel() // (self.groups * x.shape[1]),
                               self.terms)
        return y


def stacked_bn(bns, x):
    """k BatchNorms of C channels each as one call over x's k * C channels
    (bns[j] on channels [j * C, (j + 1) * C)): eval mode normalizes with
    their running statistics; train mode runs the fused BN + swish with
    each channel's own batch statistics in the BNs' `groups`, and leaves
    each BN its block of the moments, as a call of each BN on its block of
    channels would. Every channel's statistics and affine parameters are
    its own, so the values are those of the k calls."""
    first = bns[0]

    def cat(name):
        return torch.cat([getattr(bn, name) for bn in bns])

    if not first.training:
        return batchnorm_eval(x, cat("running_mean"), cat("running_var"),
                              cat("weight"), cat("bias"))
    y, mean, var = bn_swish_train(x, cat("weight"), cat("bias"), first.groups)
    n = x.numel() // (first.groups * x.shape[1])
    for bn, m, v in zip(bns, mean.chunk(len(bns), 1), var.chunk(len(bns), 1)):
        bn.moments = Moments(bn, m, v, n, bn.terms)
    return y


def bn_swish_from_moments(bn: "BatchNorm", y, s, q, dtype):
    """swish(BN(y)) with the batch statistics of y from its sums.

    y: (B, C, H, W) in the compute dtype `dtype`, or its values in f32;
    s, q: (C,) f32, the sum and the sum of squares of y over
    (B, H, W). As batchnorm_swish_from_moments computes it: mean = s/n,
    var = max(q/n - mean^2, 0), z = y.f32 * a + (bias - mean * a) with
    a = scale / sqrt(var + eps), rounded to `dtype`, then swish in that
    dtype. The gradient flows through s and q (into the conv op's backward
    fold). The moments land on `bn` for the EMA commit, as a train-mode
    BatchNorm call leaves them.

    The encoder passes y in f32, as conv2d_moments returns it, so that its
    gradient reaches the fold unrounded (see ops/convbn.py)."""
    n = y.numel() // y.shape[1]
    mean = s / n
    var = torch.clamp(q / n - mean * mean, min=0.0)
    a = torch.reciprocal(torch.sqrt(var + EPS)) * bn.weight
    shape = (1, -1) + (1,) * (y.ndim - 2)
    z = y.float() * a.view(shape) + (bn.bias - mean * a).view(shape)
    bn.moments = Moments(bn, mean.detach()[None], var.detach()[None], n)
    return swish(z.to(dtype))


class BNSwishSequential(nn.Sequential):
    """nn.Sequential whose train-mode BatchNorms apply the Swish that
    follows them (the fused op), so that Swish is skipped. The indices,
    and so the reference's state_dict keys, stay those of the plain
    [..., BN, Swish, ...] stack."""

    def __init__(self, *layers):
        super().__init__(*layers)
        for i, layer in enumerate(layers):
            if isinstance(layer, BatchNorm) and not (
                    i + 1 < len(layers) and isinstance(layers[i + 1], Swish)):
                raise ValueError("every BatchNorm is fused with the Swish "
                                 "that follows it; this one has none")

    def forward(self, x):
        return bn_swish_walk(self, x, lambda i, layer, x: layer(x))


def bn_swish_walk(seq: BNSwishSequential, x, apply):
    """x through apply(i, layer, x) for the layers of `seq` in order, but
    for the Swish after a train-mode BatchNorm, which that BN applied."""
    fused = False
    for i, layer in enumerate(seq):
        if not (fused and isinstance(layer, Swish)):
            x = apply(i, layer, x)
        fused = seq.training and isinstance(layer, BatchNorm)
    return x


def set_bn_groups(module: nn.Module, groups: int, terms=None):
    """Set the train-mode BNs under `module` to `groups` sets of
    statistics; terms: the ELBO terms they are, None for all."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.groups = groups
            m.terms = terms


def pop_moments(module: nn.Module) -> list:
    """The Moments of the train-mode BN calls under `module` since the last
    pop, in module order; clears them. Empty in eval mode."""
    out = []
    for m in module.modules():
        if isinstance(m, BatchNorm) and m.moments is not None:
            out.append(m.moments)
            m.moments = None
    return out
