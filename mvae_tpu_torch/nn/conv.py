"""Bias-free convolutions with PyTorch size semantics (counterpart of
mvae_tpu/nn/conv.py:90-126).

NCHW activations; weights in the reference's layouts: conv (c_out, c_in,
k, k), transposed conv (c_in, c_out, k, k). The weight is cast to the
input's dtype at use.

    conv2d:          out = floor((in + 2p - k)/s) + 1
    conv_transpose:  out = (in - 1)*s - 2p + k
"""

import torch
from torch import nn
from torch.nn import functional as F

from mvae_tpu_torch.nn.initializers import kaiming_uniform_bound, uniform_


def conv2d(x, weight, *, stride: int, padding: int, groups: int = 1):
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding,
                    groups=groups)


def conv_transpose2d(x, weight, *, stride: int, padding: int,
                     groups: int = 1):
    return F.conv_transpose2d(x, weight.to(x.dtype), stride=stride,
                              padding=padding, groups=groups)


class Conv2d(nn.Module):
    def __init__(self, c_in, c_out, kernel, stride, padding, *, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty((c_out, c_in, kernel, kernel), device=device))

    def reset_parameters(self, generator):
        c_in, k = self.weight.shape[1], self.weight.shape[2]
        uniform_(self.weight, kaiming_uniform_bound(c_in * k * k), generator)

    def forward(self, x):
        return conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class ConvTranspose2d(nn.Module):
    def __init__(self, c_in, c_out, kernel, stride, padding, *, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty((c_in, c_out, kernel, kernel), device=device))

    def reset_parameters(self, generator):
        # torch takes fan_in from weight.shape[1] (the OUTPUT channels) here
        c_out, k = self.weight.shape[1], self.weight.shape[2]
        uniform_(self.weight, kaiming_uniform_bound(c_out * k * k), generator)

    def forward(self, x):
        return conv_transpose2d(x, self.weight, stride=self.stride,
                                padding=self.padding)
