"""Vision MVAE: six image modalities of CelebA, RGB, grayscale, Canny
edges, landmark mask, half-obscured and watermarked. Counterpart of
mvae_tpu/models/vision.py, with the reference's module names
(vision/model.py:12-100), so a reference-layout `state_dict` loads with
`strict=True`:

    {m}_encoder.features     conv C->32->64->128->256 (4,2,1 x3; 4,1,0),
                             BN from the 2nd conv, swish: 64->32->16->8->5
    {m}_encoder.classifier   fc 256*5*5 -> 512 -> swish -> dropout(0.1)
                             -> 2L
    {m}_decoder.upsample     fc L -> 256*5*5 -> swish
    {m}_decoder.hallucinate  convT 256->128->64->32->C, BN + swish between

for m in MODALITIES with C = 3, 1, 1, 1, 3, 3: six instances of CelebA's
image encoder and decoder (models/celeba.py). Mixed precision, train mode
and the encoder's fused route (`conv_moments=True`) are CelebA's. Each
encoder's dropout takes its own keep-mask: encode's keep_mask is
(6, B, 512), one per modality in MODALITIES order, drawn by the caller
(JAX folds the dropout key per modality, :103).

The loss of a modality is its row-summed pixel BCE; the CLI weighs each
by 1/6 (experiments/vision/train.py).
"""

import torch

from mvae_tpu_torch.core.losses import bce_row_sum
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE
from mvae_tpu_torch.models.celeba import ImageDecoder, ImageEncoder
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.norm import pop_moments, set_bn_groups

N_MODALITIES = 6
MODALITIES = ("image", "gray", "edge", "mask", "obscured", "watermark")
CHANNELS = {"image": 3, "gray": 1, "edge": 1, "mask": 1,
            "obscured": 3, "watermark": 3}


def dec_specs(c_out):
    return [(128, 4, 1, 0, True), (64, 4, 2, 1, True),
            (32, 4, 2, 1, True), (c_out, 4, 2, 1, False)]


class VisionMVAE(MultimodalVAE):
    modalities = MODALITIES

    def __init__(self, n_latents: int = 250, compute_dtype=None, *,
                 conv_moments: bool = False, device=None, generator=None):
        """device: None runs on the CUDA card (raises without one), "cpu"
        on the CPU. generator: CPU torch.Generator for the initial weights
        (default: seed 0). conv_moments: the encoders' fused conv + BN
        moments route in train mode (off by default). The model starts in
        eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.n_latents = n_latents
        self.compute_dtype = compute_dtype
        for m in MODALITIES:
            c = CHANNELS[m]
            self.add_module(f"{m}_encoder", ImageEncoder(
                n_latents, compute_dtype, conv_moments, device, channels=c))
            self.add_module(f"{m}_decoder", ImageDecoder(
                n_latents, compute_dtype, device, specs=dec_specs(c)))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters_(self, generator)
        self.eval()

    def input_spec(self):
        return {m: ((64, 64, CHANNELS[m]), torch.float32)
                for m in MODALITIES}

    @property
    def dropout_rate(self) -> float:
        return self.image_encoder.classifier[2].p

    def keep_mask_shape(self, batch: int):
        return (N_MODALITIES, batch,
                self.image_encoder.classifier[0].weight.shape[0])

    def encode(self, inputs, keep_mask=None):
        L = self.n_latents
        mus, lvs, moments = [], [], {}
        for i, m in enumerate(MODALITIES):
            enc = getattr(self, f"{m}_encoder")
            p = enc(inputs[m].permute(0, 3, 1, 2),
                    None if keep_mask is None else keep_mask[i])
            mus.append(p[:, :L])
            lvs.append(p[:, L:])
            moments[m] = pop_moments(enc)
        return torch.stack(mus), torch.stack(lvs), moments

    def decode(self, z, groups: int = 1):
        recons, moments = {}, []
        for m in MODALITIES:
            dec = getattr(self, f"{m}_decoder")
            set_bn_groups(dec, groups)
            recons[m] = dec(z).permute(0, 2, 3, 1)
            moments += pop_moments(dec)
        return recons, moments

    def recon_loss(self, name, logits, target):
        lo = logits.reshape(logits.shape[0], -1)
        ta = target.reshape(target.shape[0], -1)
        return bce_row_sum(lo, ta)
