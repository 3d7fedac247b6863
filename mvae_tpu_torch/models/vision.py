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

`stack_modalities=True` (the JAX package's MVAE_STACK_MODALITIES=1,
:33-45, 112-193) runs each channel group of GROUPS as one stack: the
three encoders of a group as one grouped conv stack over their inputs
side by side on the channel axis and one batched head, the three decoders
as one up-projection (z is shared) and one grouped deconv stack
(nn/dcgan.py:stacked, stacked_head). An encode then runs 2 conv stacks in
place of 6, and so does a decode; the state_dict is the loop's, and the
values are the loop's to the order of the convolutions' sums. The stacked
encoder takes the unfused route: conv2d_moments has no groups, so
conv_moments=True is refused beside it. The port's decode stops no
gradients (core/engine.py decodes every term as one batch), so the
stacked decode serves every call, where JAX's falls back to the loop
under stop-grads (:157).
"""

import torch

from mvae_tpu_torch.core.losses import bce_row_sum
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE, head_chain
from mvae_tpu_torch.models.celeba import ImageDecoder, ImageEncoder
from mvae_tpu_torch.nn.dcgan import stacked, stacked_head
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.layers import linear, swish
from mvae_tpu_torch.nn.norm import pop_moments, set_bn_groups

N_MODALITIES = 6
MODALITIES = ("image", "gray", "edge", "mask", "obscured", "watermark")
CHANNELS = {"image": 3, "gray": 1, "edge": 1, "mask": 1,
            "obscured": 3, "watermark": 3}
# the two architectures, three instances each (vision/model.py:16-28)
GROUPS = (("image", "obscured", "watermark"), ("gray", "edge", "mask"))


def dec_specs(c_out):
    return [(128, 4, 1, 0, True), (64, 4, 2, 1, True),
            (32, 4, 2, 1, True), (c_out, 4, 2, 1, False)]


class VisionMVAE(MultimodalVAE):
    modalities = MODALITIES

    def __init__(self, n_latents: int = 250, compute_dtype=None, *,
                 conv_moments: bool = False, stack_modalities: bool = False,
                 device=None, generator=None):
        """device: None runs on the CUDA card (raises without one), "cpu"
        on the CPU. generator: CPU torch.Generator for the initial weights
        (default: seed 0). conv_moments: the encoders' fused conv + BN
        moments route in train mode (off by default). stack_modalities:
        each channel group as one stack (see the module docstring; off by
        default). The model starts in eval mode."""
        if stack_modalities and conv_moments:
            raise ValueError("stack_modalities runs the encoders' unfused "
                             "route: conv2d_moments has no groups argument, "
                             "so it cannot take conv_moments=True")
        super().__init__()
        device = resolve_device(device)
        self.n_latents = n_latents
        self.compute_dtype = compute_dtype
        self.stack_modalities = stack_modalities
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

    def tp_chains(self):
        return [head_chain(f"{m}_encoder") for m in MODALITIES]

    def keep_mask_shape(self, batch: int):
        return (N_MODALITIES, batch,
                self.image_encoder.classifier.hidden)

    def encode(self, inputs, keep_mask=None):
        if self.stack_modalities:
            return self._encode_stacked(inputs, keep_mask)
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

    def _encode_stacked(self, inputs, keep_mask):
        """One conv stack and one head a group; each modality's dropout
        takes its own row of keep_mask, as in the loop."""
        L = self.n_latents
        posteriors, moments = {}, {}
        for grp in GROUPS:
            encs = [getattr(self, f"{m}_encoder") for m in grp]
            x = torch.cat([inputs[m].permute(0, 3, 1, 2) for m in grp], 1)
            h = stacked([e.features for e in encs], x)   # (B, 3 * 256, 5, 5)
            h = h.reshape(h.shape[0], len(grp), -1).transpose(0, 1)
            keep = None if keep_mask is None else keep_mask[
                [MODALITIES.index(m) for m in grp]]
            p = stacked_head([e.classifier for e in encs], h, keep)
            for j, m in enumerate(grp):
                posteriors[m] = p[j]
                moments[m] = pop_moments(encs[j])
        return (torch.stack([posteriors[m][:, :L] for m in MODALITIES]),
                torch.stack([posteriors[m][:, L:] for m in MODALITIES]),
                {m: moments[m] for m in MODALITIES})

    def decode(self, z, groups: int = 1):
        if self.stack_modalities:
            return self._decode_stacked(z, groups)
        recons, moments = {}, []
        for m in MODALITIES:
            dec = getattr(self, f"{m}_decoder")
            set_bn_groups(dec, groups)
            recons[m] = dec(z).permute(0, 2, 3, 1)
            moments += pop_moments(dec)
        return recons, moments

    def _decode_stacked(self, z, groups):
        """One up-projection and one deconv stack a group: the three
        upsample fcs as one linear over their weights concatenated, its
        (N, 3 * 6400) output each modality's (256, 5, 5) in turn."""
        recons, moments = {}, {}
        for grp in GROUPS:
            decs = [getattr(self, f"{m}_decoder") for m in grp]
            for d in decs:
                set_bn_groups(d, groups)
            ups = [d.upsample[0] for d in decs]
            h = swish(linear(z, torch.cat([u.weight for u in ups]),
                             torch.cat([u.bias for u in ups])))
            side = decs[0].side
            img = stacked([d.hallucinate for d in decs],
                          h.reshape(-1, len(grp) * 256, side, side))
            for j, (m, logits) in enumerate(zip(grp, img.chunk(len(grp), 1))):
                # contiguous NCHW, as a decoder of the loop returns it: the
                # BCE kernel reads each row of the NHWC view's flattening
                recons[m] = logits.contiguous().permute(0, 2, 3, 1)
                moments[m] = pop_moments(decs[j])
        return ({m: recons[m] for m in MODALITIES},
                [x for m in MODALITIES for x in moments[m]])

    def recon_loss(self, name, logits, target):
        lo = logits.reshape(logits.shape[0], -1)
        ta = target.reshape(target.shape[0], -1)
        return bce_row_sum(lo, ta)
