"""Bias-free convolutions with PyTorch size semantics (counterpart of
mvae_tpu/nn/conv.py:90-126).

NCHW activations by shape; weights in the reference's layouts: conv
(c_out, c_in, k, k), transposed conv (c_in, c_out, k, k). The weight is
cast to the input's dtype at use. A conv runs in its input's memory format
(`layout_of`): a channels-last input (NHWC memory, the conv stacks' layout
in bf16 and fp16, `activation_format`) takes a channels-last weight from
the same copy, so cuDNN's NHWC tensor-core kernels get both without a
transpose. A grouped conv (vision's stacked modalities) runs NCHW in every
dtype: channels-last, cuDNN's grouped bf16 kernels ran vision's stacked
step 3.3% slower on an H100 (PERF.md). The NHWC kernels read 16-byte runs
of channels; a channel count that holds no whole run (the images' 3 or 1
channels in and out) is zero-padded to the next multiple of CHANNEL_RUN,
input and weight, and the padded output channels are dropped (cuDNN's own
padding of such a tensor is a generic transform that took a third of a
bf16 celeba19 step on an H100). The padded channels add zeros to every
sum, so the values are those of the unpadded conv, to the order of its
sums. The parameters stay OIHW, so the state_dict does not change.

    conv2d:          out = floor((in + 2p - k)/s) + 1
    conv_transpose:  out = (in - 1)*s - 2p + k
"""

import torch
from torch import nn
from torch.nn import functional as F

from mvae_tpu_torch.nn.initializers import kaiming_uniform_bound, uniform_
from mvae_tpu_torch.ops.bn import is_channels_last

# compute dtypes whose conv stacks keep their activations channels-last:
# cuDNN's Hopper tensor-core kernels for them are NHWC and transpose an
# NCHW tensor around every call; its f32 engines are not
CHANNELS_LAST_DTYPES = (torch.bfloat16, torch.float16)
CHANNEL_RUN = 8         # channels of one 16-byte run in bf16 or fp16
CL = torch.channels_last


def activation_format(dtype):
    """The memory format of a conv stack's activations at compute dtype
    `dtype`: channels-last for bf16 and fp16, NCHW otherwise."""
    return CL if dtype in CHANNELS_LAST_DTYPES else torch.contiguous_format


def layout_of(x):
    """The memory format a conv runs x in: channels-last where x is stored
    so, or where it is bf16 or fp16 and its strides are both layouts' (one
    channel, or one pixel); NCHW otherwise."""
    if is_channels_last(x) or (
            x.dtype in CHANNELS_LAST_DTYPES
            and x.is_contiguous(memory_format=CL)):
        return CL
    return torch.contiguous_format


def _run(c):
    return -(-c // CHANNEL_RUN) * CHANNEL_RUN


def _pad_dim(t, dim, size):
    """t zero-padded at the end of dim `dim` to `size` (t where it is)."""
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def _conv(fn, x, weight, transposed, groups, **kw):
    """fn (F.conv2d or F.conv_transpose2d) on x, the weight cast at use:
    channels-last, its channels padded to whole runs, where layout_of(x)
    is and the conv is ungrouped; NCHW otherwise (the module docstring)."""
    if groups != 1 or layout_of(x) != CL:
        return fn(x.contiguous(), weight.to(x.dtype), groups=groups, **kw)
    # a weight's dims of the input and of the output channels
    d_in, d_out = (0, 1) if transposed else (1, 0)
    c_in, c_out = weight.shape[d_in], weight.shape[d_out]
    x = x.contiguous(memory_format=CL)
    if _run(c_in) != c_in:          # the NHWC view's last dim padded
        x = _pad_dim(x.permute(0, 2, 3, 1), 3, _run(c_in)).permute(
            0, 3, 1, 2)
    w = _pad_dim(_pad_dim(weight, d_in, _run(c_in)), d_out, _run(c_out))
    y = fn(x, w.to(x.dtype, memory_format=CL), **kw)   # one copy of w
    if _run(c_out) == c_out:
        return y
    # sliced in the NHWC view, whose backward pads the gradient
    # channels-last (slicing the NCHW view pads it into an NCHW tensor)
    return y.permute(0, 2, 3, 1)[..., :c_out].contiguous().permute(
        0, 3, 1, 2)


def conv2d(x, weight, *, stride: int, padding: int, groups: int = 1):
    return _conv(F.conv2d, x, weight, False, groups, stride=stride,
                 padding=padding)


def conv_transpose2d(x, weight, *, stride: int, padding: int,
                     groups: int = 1):
    return _conv(F.conv_transpose2d, x, weight, True, groups, stride=stride,
                 padding=padding)


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
