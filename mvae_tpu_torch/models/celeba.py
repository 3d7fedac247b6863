"""CelebA MVAE: 64x64 RGB image (DCGAN CNN) + 18 binary attributes (one
joint expert). Counterpart of mvae_tpu/models/celeba.py, with the
reference's module names (celeba/model.py:66-190), so a reference-layout
`state_dict` loads with `strict=True`:

    image_encoder.features   conv 3->32->64->128->256 (4,2,1 x3; 4,1,0),
                             BN from the 2nd conv, swish
    image_encoder.classifier fc 256*5*5 -> 512 -> swish -> dropout -> 2L
    image_decoder.upsample   fc L -> 256*5*5 -> swish
    image_decoder.hallucinate convT 256->128->64->32->3, BN + swish between
    attrs_encoder.net        18 -> 512 -> 512 (BN1d + swish) -> 2L
    attrs_decoder.net        L -> 512 x3 (BN1d + swish) -> 18 logits

Images enter and leave NHWC. Inside, the conv stacks hold NCHW shapes,
stored channels-last under a bf16 compute dtype (nn/dcgan.py), so the
image input's NHWC tensor, permuted, is the first conv's input as it is
and the decoder's logits, permuted back, are NHWC-contiguous; the
reference's (c, h, w) flatten order holds in either layout. With a compute
dtype (bfloat16) the conv stacks and the image posterior head run in it; the
attribute MLPs and the decoder's upsample fc run in f32, as in the JAX
package (models/celeba.py:100-117).

Train mode (`model.train()`): BN with batch statistics, fused with its
swish; the image head's dropout (rate 0.1) takes a keep-mask from the
caller; decode keeps `groups` sets of BN statistics over consecutive
blocks of rows (the ELBO terms). encode and decode return the batch
moments their BNs made, for the engine's EMA commit. With
`conv_moments=True` the image encoder's three BN'd convs take the fused
route in train mode: the conv2d_moments kernel and the BN from its sums
(nn/dcgan.py). That route is opt-in, as in the JAX package
(MVAE_CONVBN_PALLAS=1): on an H100 the unfused route (conv, then the four
BN kernels) takes less time a step (PERF.md).
"""

import torch
from torch import nn

from mvae_tpu_torch.core.losses import bce_row_sum
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE, head_chain
from mvae_tpu_torch.nn.dcgan import ConvStack, DeconvStack, PosteriorHead
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.layers import Linear, Swish
from mvae_tpu_torch.nn.norm import (
    BatchNorm, BNSwishSequential, pop_moments, set_bn_groups)

ENC_SPECS = [(32, 4, 2, 1, False), (64, 4, 2, 1, True),
             (128, 4, 2, 1, True), (256, 4, 1, 0, True)]   # 64->32->16->8->5
DEC_SPECS = [(128, 4, 1, 0, True), (64, 4, 2, 1, True),
             (32, 4, 2, 1, True), (3, 4, 2, 1, False)]     # 5->8->16->32->64
N_ATTRS = 18


def _mlp_bn(dims, d_out, device):
    """[linear -> BN1d -> swish]* -> linear, as one indexed Sequential."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers += [Linear(a, b, device=device), BatchNorm(b, device=device),
                   Swish()]
    layers.append(Linear(dims[-1], d_out, device=device))
    return BNSwishSequential(*layers)


class ImageEncoder(nn.Module):
    """The DCGAN image encoder: `specs` convs from `channels` to 256
    channels of side x side, then the posterior head. CelebA's by
    default; MultiMNIST's takes its own specs (models/multimnist.py)."""

    def __init__(self, n_latents, compute_dtype, conv_moments, device, *,
                 channels=3, specs=ENC_SPECS, side=5):
        super().__init__()
        self.features = ConvStack(channels, specs,
                                  compute_dtype=compute_dtype,
                                  conv_moments=conv_moments, device=device)
        self.classifier = PosteriorHead(256 * side * side, n_latents,
                                        compute_dtype=compute_dtype,
                                        device=device)

    def forward(self, x, keep_mask=None):   # x: (B, C, H, W)
        h = self.features(x)
        return self.classifier(h.reshape(h.shape[0], -1), keep_mask)


class ImageDecoder(nn.Module):
    """fc L -> 256 x side x side with a swish, then the `specs` convTs."""

    def __init__(self, n_latents, compute_dtype, device, *, specs=DEC_SPECS,
                 side=5):
        super().__init__()
        self.side = side
        self.upsample = nn.Sequential(
            Linear(n_latents, 256 * side * side, device=device), Swish())
        self.hallucinate = DeconvStack(256, specs,
                                       compute_dtype=compute_dtype,
                                       device=device)

    def forward(self, z):                   # -> (N, C, H, W) logits
        h = self.upsample(z)
        return self.hallucinate(h.reshape(-1, 256, self.side, self.side))


class MlpBN(nn.Module):
    def __init__(self, dims, d_out, device):
        super().__init__()
        self.net = _mlp_bn(dims, d_out, device)

    def forward(self, x):
        return self.net(x.float())


class CelebaMVAE(MultimodalVAE):
    modalities = ("image", "attrs")

    def __init__(self, n_latents: int = 100, compute_dtype=None, *,
                 conv_moments: bool = False, device=None, generator=None):
        """device: None runs on the CUDA card (raises without one), "cpu"
        on the CPU. generator: CPU torch.Generator for the initial weights
        (default: seed 0). conv_moments: the encoder's fused conv + BN
        moments route in train mode (off by default). The model starts in
        eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.n_latents = n_latents
        self.compute_dtype = compute_dtype
        L = n_latents
        self.image_encoder = ImageEncoder(L, compute_dtype, conv_moments,
                                          device)
        self.image_decoder = ImageDecoder(L, compute_dtype, device)
        self.attrs_encoder = MlpBN([N_ATTRS, 512, 512], 2 * L, device)
        self.attrs_decoder = MlpBN([L, 512, 512, 512], N_ATTRS, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters_(self, generator)
        self.eval()

    def input_spec(self):
        return {"image": ((64, 64, 3), torch.float32),
                "attrs": ((N_ATTRS,), torch.float32)}

    @property
    def dropout_rate(self) -> float:
        return self.image_encoder.classifier[2].p

    def tp_chains(self):
        return [head_chain("image_encoder")]

    def keep_mask_shape(self, batch: int):
        return (batch, self.image_encoder.classifier.hidden)

    def encode(self, inputs, keep_mask=None):
        L = self.n_latents
        img = self.image_encoder(inputs["image"].permute(0, 3, 1, 2),
                                 keep_mask)
        att = self.attrs_encoder(inputs["attrs"])
        mu = torch.stack([img[:, :L], att[:, :L]])
        logvar = torch.stack([img[:, L:], att[:, L:]])
        return mu, logvar, {"image": pop_moments(self.image_encoder),
                            "attrs": pop_moments(self.attrs_encoder)}

    def decode_group(self, name, z, groups, terms, keep_mask=None,
                     operand=None):
        """Both decoders have BN: a term that never trains one decodes it
        forward for its statistics (the engine's no_grad call)."""
        dec = getattr(self, f"{name}_decoder")
        set_bn_groups(dec, groups, terms)
        out = dec(z)
        if name == "image":
            out = out.permute(0, 2, 3, 1)
        return {name: out}, pop_moments(dec)

    def recon_loss(self, name, logits, target):
        lo = logits.reshape(logits.shape[0], -1)
        ta = target.reshape(target.shape[0], -1)
        return bce_row_sum(lo, ta)
