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

Layout: a stack whose compute dtype is bf16 or fp16 casts its input
straight to channels-last (nn/conv.py:activation_format), and its convs
(the images' channels padded to whole 16-byte runs, nn/conv.py), BNs and
swishes keep it so, as the JAX package's stacks are NHWC end to end; f32
stacks run NCHW, and so do the encoder's fused route, whose
conv2d_moments reads NCHW, and `stacked`, whose convs are grouped. The reference's (c, h, w) order where a stack
meets a fully connected layer holds in either layout: the encoder's
flatten and the decoder's reshape are copies into it where they must be.

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

Stacked stacks (vision's modality groups, models/vision.py): `stacked`
runs k ConvStacks or k DeconvStacks of one spec list as one stack over
their inputs side by side on the channel axis: each conv a grouped
convolution (groups = k) over the k weights concatenated, each BN over
the k blocks of channels (nn/norm.py:stacked_bn); `stacked_head` runs k
posterior heads as batched matmuls. The parameters stay the modules' own,
so the state_dict does not change and gradients reach each module. The
values are those of the k stacks, to the order of the convolutions' sums.

Tensor parallelism (parallel/mesh.py): a posterior head's fc is a column
layer and its out a row layer (nn/layers.py:linear), so the hidden
features stay on their rank and the 2L posterior is whole after one
all-reduce; the dropout between them takes the rank's columns of the
global (N, hidden) keep-mask (train/loop.py:local_noise). The stacked
head stacks each rank's slices.

spec row: (c_out, kernel, stride, pad, use_bn)
"""

import torch
from torch import nn

from mvae_tpu_torch.nn.conv import (
    Conv2d, ConvTranspose2d, activation_format, conv2d, conv_transpose2d)
from mvae_tpu_torch.nn.layers import Dropout, Linear, Swish, linear, swish
from mvae_tpu_torch.nn.norm import (
    BatchNorm, BNSwishSequential, bn_swish_from_moments, bn_swish_walk,
    stacked_bn)
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

    def cast_in(self, x):
        """x in the compute dtype and the stack's layout (the module
        docstring: NCHW on the encoder's fused route), in one copy at
        most."""
        fused = self.training and getattr(self, "conv_moments", False)
        fmt = (torch.contiguous_format if fused
               else activation_format(self.compute_dtype))
        return x.to(self.compute_dtype or x.dtype, memory_format=fmt)

    def cast_out(self, x):
        return x

    def forward(self, x):
        x = self.cast_in(x)
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

    cast_in = ConvStack.cast_in

    def cast_out(self, logits):
        return logits if self.training else logits.float()

    def forward(self, x):
        return self.cast_out(super().forward(self.cast_in(x)))


class PosteriorHead(nn.Sequential):
    """fc -> swish -> dropout -> fc(2L); output always f32 (mu/logvar feed
    exp())."""

    def __init__(self, d_in, n_latents, *, hidden=512, dropout=0.1,
                 compute_dtype=None, device=None):
        super().__init__(Linear(d_in, hidden, device=device), Swish(),
                         Dropout(dropout),
                         Linear(hidden, 2 * n_latents, device=device))
        self.compute_dtype = compute_dtype
        self.hidden = hidden        # the keep-mask's width, on every rank

    def forward(self, x, keep_mask=None):
        """keep_mask: (N, hidden) bool, the dropout's, in train mode (the
        rank's columns of it under tensor parallelism)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        fc, act, drop, out = self
        return out(drop(act(fc(x)), keep_mask)).to(torch.float32)


def stacked(seqs, x):
    """k ConvStacks (or k DeconvStacks) of one spec list as one stack: x
    (N, k * C, H, W) holds the k inputs side by side on the channel axis;
    returns the k outputs so. It runs the unfused encoder route whatever
    the stacks' conv_moments (conv2d_moments takes no groups): the caller
    refuses that pairing (models/vision.py)."""
    first, k = seqs[0], len(seqs)

    def apply(i, layer, x):
        group = [seq[i] for seq in seqs]
        if isinstance(layer, (Conv2d, ConvTranspose2d)):
            conv = conv2d if isinstance(layer, Conv2d) else conv_transpose2d
            return conv(x, torch.cat([m.weight for m in group]),
                        stride=layer.stride, padding=layer.padding, groups=k)
        if isinstance(layer, BatchNorm):
            return stacked_bn(group, x)
        return layer(x)                     # a Swish

    # NCHW in the compute dtype, in one copy: grouped convs run NCHW
    # (nn/conv.py)
    x = x.to(first.compute_dtype or x.dtype,
             memory_format=torch.contiguous_format)
    return first.cast_out(bn_swish_walk(first, x, apply))


def stacked_head(heads, h, keep_mask=None):
    """k PosteriorHeads as one: h (k, N, d_in), keep_mask (k, N, hidden)
    in train mode -> (k, N, 2L) f32. Each matmul is a torch.bmm over the
    k weights, the bias added after it in h's dtype, as linear does, and
    under tensor parallelism over the rank's k slices."""
    if heads[0].compute_dtype is not None:
        h = h.to(heads[0].compute_dtype)
    fcs, outs = zip(*((hd[0], hd[3]) for hd in heads))
    drop = heads[0][2]

    def fc(layers, x):
        w = torch.stack([m.weight for m in layers])
        b = torch.stack([m.bias for m in layers])[:, None]
        return linear(x, w, b, layers[0].tp,
                      lambda x, w: torch.bmm(x, w.transpose(1, 2)))

    return fc(outs, drop(swish(fc(fcs, h)), keep_mask)).to(torch.float32)
