"""FashionMNIST MVAE: 28x28 image (small CNN, no BatchNorm) + class label.
Counterpart of mvae_tpu/models/fashionmnist.py, with the reference's
module names (fashionmnist/model.py:70-165), so a reference-layout
`state_dict` loads with `strict=True`:

    image_encoder.features    conv 1->64->128 (4,2,1; no bias, no BN), swish
    image_encoder.classifier  fc 128*7*7 -> 512 -> swish -> 2L
    image_decoder.upsampler   fc L -> 512 -> swish -> 128*7*7 -> swish
    image_decoder.hallucinate convT 128->64 (4,2,1) -> swish -> convT 64->1
    text_encoder.net          Embedding(10, 512) -> swish -> 512 -> swish
                              -> 2L
    text_decoder.net          L -> 512 x3 (swish) -> 10 logits

Images enter and leave NHWC, (B, 28, 28, 1); inside they run NCHW, so the
reference's (c, h, w) flatten order needs no permutation. With a compute
dtype (bfloat16) only the conv stacks run in it: the image FCs and the
label MLPs stay f32 (models/fashionmnist.py:33-35, 64). In train mode the
deconv stack's logits stay in the compute dtype (nn/dcgan.py:124-126) and
the loss upcasts them; in eval mode they are f32. There is no dropout and
no BatchNorm: train mode needs no keep-mask and leaves no moments.
"""

import torch
from torch import nn

from mvae_tpu_torch.core.losses import bce_row_sum, cross_entropy_with_logits
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE
from mvae_tpu_torch.nn.dcgan import ConvStack, DeconvStack
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.layers import Embedding, Linear, Swish, mlp

ENC_SPECS = [(64, 4, 2, 1, False), (128, 4, 2, 1, False)]   # 28->14->7
DEC_SPECS = [(64, 4, 2, 1, False), (1, 4, 2, 1, False)]     # 7->14->28
N_CLASSES = 10


class ImageEncoder(nn.Module):
    def __init__(self, n_latents, compute_dtype, device):
        super().__init__()
        self.features = ConvStack(1, ENC_SPECS, compute_dtype=compute_dtype,
                                  device=device)
        self.classifier = mlp([128 * 7 * 7, 512, 2 * n_latents],
                              device=device)

    def forward(self, x):                   # x: (B, 1, 28, 28)
        h = self.features(x).float()
        return self.classifier(h.reshape(h.shape[0], -1))


class ImageDecoder(nn.Module):
    def __init__(self, n_latents, compute_dtype, device):
        super().__init__()
        self.upsampler = mlp([n_latents, 512, 128 * 7 * 7],
                             final_activation=True, device=device)
        self.hallucinate = DeconvStack(128, DEC_SPECS,
                                       compute_dtype=compute_dtype,
                                       device=device)

    def forward(self, z):                   # -> (N, 1, 28, 28) logits
        h = self.upsampler(z)
        return self.hallucinate(h.reshape(-1, 128, 7, 7))


class TextEncoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.net = nn.Sequential(
            Embedding(N_CLASSES, 512, device=device), Swish(),
            Linear(512, 512, device=device), Swish(),
            Linear(512, 2 * n_latents, device=device))

    def forward(self, labels):
        return self.net(labels)


class TextDecoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.net = mlp([n_latents, 512, 512, 512, N_CLASSES], device=device)

    def forward(self, z):
        return self.net(z)


class FashionMnistMVAE(MultimodalVAE):
    modalities = ("image", "text")

    def __init__(self, n_latents: int = 64, compute_dtype=None, *,
                 device=None, generator=None):
        """device: None runs on the CUDA card (raises without one), "cpu"
        on the CPU. generator: CPU torch.Generator for the initial weights
        (default: seed 0). The model starts in eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.n_latents = n_latents
        self.compute_dtype = compute_dtype
        self.image_encoder = ImageEncoder(n_latents, compute_dtype, device)
        self.image_decoder = ImageDecoder(n_latents, compute_dtype, device)
        self.text_encoder = TextEncoder(n_latents, device)
        self.text_decoder = TextDecoder(n_latents, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters_(self, generator)
        self.eval()

    def input_spec(self):
        return {"image": ((28, 28, 1), torch.float32),
                "text": ((), torch.int32)}

    def tp_chains(self):
        """JAX's image_dec["up"] pair and text_dec list; the encoders' fc
        and head are lone linears (mvae_tpu/models/fashionmnist.py)."""
        return [[("image_decoder.upsampler.0",),
                 ("image_decoder.upsampler.2",)],
                [(f"text_decoder.net.{i}",) for i in (0, 2, 4, 6)]]

    def encode(self, inputs, keep_mask=None):
        L = self.n_latents
        x = inputs["image"].reshape(-1, 28, 28, 1).permute(0, 3, 1, 2)
        img = self.image_encoder(x)
        txt = self.text_encoder(inputs["text"])
        mu = torch.stack([img[:, :L], txt[:, :L]])
        logvar = torch.stack([img[:, L:], txt[:, L:]])
        return mu, logvar, {"image": [], "text": []}

    def decode(self, z, groups: int = 1):
        img = self.image_decoder(z).permute(0, 2, 3, 1)
        return {"image": img, "text": self.text_decoder(z)}, []

    def recon_loss(self, name, logits, target):
        if name == "image":
            return bce_row_sum(logits.reshape(logits.shape[0], -1),
                               target.reshape(target.shape[0], -1))
        return cross_entropy_with_logits(logits, target)
