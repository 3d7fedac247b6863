"""BatchNorm with explicit running statistics, torch semantics (counterpart
of mvae_tpu/nn/norm.py:56-102,129-160), eval branch.

Eval mode normalizes with the running statistics, eps 1e-5. The math runs
in f32 whatever the input's dtype, and the result returns in the input's
dtype; the Swish that follows every BN in the reference nets then runs in
that dtype (nn/norm.py:158-160). Train-mode batch statistics and the EMA
update wait for the training slice of the port, so a module in train mode
raises.
"""

import torch
from torch import nn

EPS = 1e-5


def batchnorm_eval(x, mean, var, scale, bias, eps: float = EPS):
    """x: (N, C, ...) in any float dtype; statistics and affine (C,) f32."""
    shape = (-1,) + (1,) * (x.ndim - 2)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    y = ((x.float() - mean.reshape(shape)) * inv.reshape(shape)
         * scale.reshape(shape) + bias.reshape(shape))
    return y.to(x.dtype)


class BatchNorm(nn.Module):
    """Keys and buffers of torch's BatchNorm1d/2d (weight, bias,
    running_mean, running_var, num_batches_tracked), channel axis 1."""

    def __init__(self, c: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c,), device=device))
        self.bias = nn.Parameter(torch.empty((c,), device=device))
        self.register_buffer("running_mean", torch.empty((c,), device=device))
        self.register_buffer("running_var", torch.empty((c,), device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x):
        if self.training:
            raise NotImplementedError("train-mode BatchNorm is not ported yet")
        return batchnorm_eval(x, self.running_mean, self.running_var,
                              self.weight, self.bias)
