"""Conv stack, deconv stack and posterior head (counterpart of
mvae_tpu/nn/dcgan.py), as `nn.Sequential`s whose indices are the
reference's `state_dict` keys (celeba/model.py:66-133):

    encoder features:  [conv -> (BN) -> swish]*
    posterior head:    fc(512) -> swish -> dropout -> fc(2L)
    decoder:           [convT -> BN -> swish]* -> convT (logits)

Mixed precision as in the JAX package: each stack casts its input to the
compute dtype, conv/linear weights are cast at use (nn/dcgan.py:43-50),
BN math runs in f32 and swish in the compute dtype, the posterior head
emits f32 (:150-156) and the eval-mode decoder logits are f32 (:124-126).

Train mode (the JAX package's Pallas BN path, nn/norm.py:145-157): each
BN runs fused with the swish after it, in f32 and rounded once to the
compute dtype (nn/norm.py:BNSwishSequential); the head's dropout takes a
keep-mask from the caller; under a compute dtype the decoder logits stay
in it (nn/dcgan.py:124-126, the JAX package's default), and the losses
upcast them.

The encoder's fused route (`ConvStack(conv_moments=True)`, train mode
only, nn/dcgan.py:62-72): a conv followed by a BatchNorm, at a shape the
op takes, runs as ops/convbn.py:conv2d_moments, whose output comes with
its batch-moment sums, and nn/norm.py:bn_swish_from_moments, so no pass of
the BN reads the conv's output again for its statistics. The port's convs
have no bias, as the op requires.

spec row: (c_out, kernel, stride, pad, use_bn)
"""

import torch
from torch import nn

from mvae_tpu_torch.nn.conv import Conv2d, ConvTranspose2d
from mvae_tpu_torch.nn.layers import Dropout, Linear, Swish
from mvae_tpu_torch.nn.norm import (
    BatchNorm, BNSwishSequential, bn_swish_from_moments)
from mvae_tpu_torch.ops.convbn import conv2d_moments, supported


class ConvStack(BNSwishSequential):
    """[conv -> (BN) -> swish]*; conv_moments: the fused route in train
    mode (see the module docstring)."""

    def __init__(self, c_in, specs, *, compute_dtype=None,
                 conv_moments=False, device=None):
        layers = []
        for c_out, kern, s, pad, bn in specs:
            layers.append(Conv2d(c_in, c_out, kern, s, pad, device=device))
            if bn:
                layers.append(BatchNorm(c_out, device=device))
            layers.append(Swish())
            c_in = c_out
        super().__init__(*layers)
        self.compute_dtype = compute_dtype
        self.conv_moments = conv_moments

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if not (self.training and self.conv_moments):
            return super().forward(x)
        layers = iter(self)                 # [conv, (BN), Swish] blocks
        for conv in layers:
            nxt = next(layers)
            k = conv.weight.shape[-1]
            if isinstance(nxt, BatchNorm) and supported(
                    tuple(x.shape), k, conv.stride, conv.padding):
                y, s, q = conv2d_moments(x, conv.weight.to(x.dtype),
                                         conv.stride, conv.padding)
                x = bn_swish_from_moments(nxt, y, s, q, x.dtype)
            else:                           # a train-mode BN applies the
                x = nxt(conv(x))            # swish too
            if isinstance(nxt, BatchNorm):
                next(layers)                # the Swish, applied above
        return x


class DeconvStack(BNSwishSequential):
    """BN + swish between layers; the final convT emits the logits: f32,
    or the compute dtype in train mode."""

    def __init__(self, c_in, specs, *, compute_dtype=None, device=None):
        layers = []     # BNSwishSequential refuses a BN with no swish after it
        for i, (c_out, kern, s, pad, bn) in enumerate(specs):
            layers.append(ConvTranspose2d(c_in, c_out, kern, s, pad,
                                          device=device))
            if bn:
                layers.append(BatchNorm(c_out, device=device))
            if i != len(specs) - 1:
                layers.append(Swish())
            c_in = c_out
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        logits = super().forward(x)
        return logits if self.training else logits.float()


class PosteriorHead(nn.Sequential):
    """fc -> swish -> dropout -> fc(2L); output always f32 (mu/logvar feed
    exp())."""

    def __init__(self, d_in, n_latents, *, hidden=512, dropout=0.1,
                 compute_dtype=None, device=None):
        super().__init__(Linear(d_in, hidden, device=device), Swish(),
                         Dropout(dropout),
                         Linear(hidden, 2 * n_latents, device=device))
        self.compute_dtype = compute_dtype

    def forward(self, x, keep_mask=None):
        """keep_mask: (N, hidden) bool, the dropout's, in train mode."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        fc, act, drop, out = self
        return out(drop(act(fc(x)), keep_mask)).to(torch.float32)
