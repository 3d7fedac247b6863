"""CelebA-19 MVAE: 64x64 RGB image + 18 binary attributes, each attribute
its own expert (19 experts). Counterpart of mvae_tpu/models/celeba19.py,
with the reference's module names (celeba19/model.py:26-209), so a
reference-layout `state_dict` loads with `strict=True`:

    image_encoder, image_decoder   CelebA's (models/celeba.py)
    attr_encoders.{i}.net          Embedding(2, 512) -> swish -> 512 ->
                                   swish -> 2L, i = 0..17
    attr_decoders.{i}.net          L -> 512 -> 512 -> 512 -> 1 logit, swish
                                   between

The reference loops over its 18 expert modules; here, as in the JAX
package, they run stacked along a leading expert axis (the 18 modules'
weights stacked at use), one batched matmul a layer: the encoder's
Embedding(2, .) lookup as the lerp e0 + a (e1 - e0) of its two rows, then
swish, fc and head; the decoder L -> 512 x 3 -> 1 over the expert axis.

Mixed precision as in the JAX package (models/celeba19.py:154-177): with a
compute dtype (bfloat16) the conv stacks and image head run in it as in
CelebA; the attribute decoder's input and its weights round to it, its
first matmul's product rounds to it, and the bias adds and the later
matmuls run in f32 (JAX promotes bf16 + f32 to f32); the attribute
encoder stays f32.

Losses (celeba19/train.py:26-60): (N, 19) rows, the image's row-summed
BCE over 12288 pixels and one scalar BCE per attribute. `bf16_loss=True`
computes the image BCE's elementwise math in bf16 steps when its logits
are bf16 (the train step under bf16 compute; ops/elbo.py), the row sums
in f32: the CLI's default under bf16 without --fast-term-decode.

`decode(..., decode_terms={"image": terms})` (--fast-term-decode) decodes
the image only on the rows of those terms, with one set of BN statistics
each; the other terms' image recon weight is 0 (their loss column holds
0), and their decoder BN commits are the JAX package's for a skipped
term (core/engine.py:commit_ema_states).
"""

import torch
from torch import nn

from mvae_tpu_torch.core.losses import (
    bce_row_sum, binary_cross_entropy_with_logits)
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE
from mvae_tpu_torch.models.celeba import ImageDecoder, ImageEncoder
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.layers import Embedding, Linear, Swish, swish
from mvae_tpu_torch.nn.norm import pop_moments, set_bn_groups
from mvae_tpu_torch.ops.poe import masked_poe_all_terms

N_ATTRS = 18


class AttrEncoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.net = nn.Sequential(
            Embedding(2, 512, device=device), Swish(),
            Linear(512, 512, device=device), Swish(),
            Linear(512, 2 * n_latents, device=device))


class AttrDecoder(nn.Module):
    def __init__(self, n_latents, device):
        super().__init__()
        self.net = nn.Sequential(
            Linear(n_latents, 512, device=device), Swish(),
            Linear(512, 512, device=device), Swish(),
            Linear(512, 512, device=device), Swish(),
            Linear(512, 1, device=device))


def stacked(experts, index):
    """The experts' layer `index` as (n, d_out, d_in) weights and (n, 1,
    d_out) biases (an Embedding: (n, 2, d) rows and None)."""
    layers = [e.net[index] for e in experts]
    w = torch.stack([m.weight for m in layers])
    if getattr(layers[0], "bias", None) is None:
        return w, None
    return w, torch.stack([m.bias for m in layers])[:, None]


class Celeba19MVAE(MultimodalVAE):
    # expert order: the image, then the 18 attributes
    modalities = ("image",) + tuple(f"attr_{i}" for i in range(N_ATTRS))
    # the inputs whose losses the IWAE sums (core/loglike.py)
    loglike_targets = ("image", "attrs")
    # decoder groups --fast-term-decode may skip (core/engine.py)
    skip_decode_groups = ("image",)

    def __init__(self, n_latents: int = 100, compute_dtype=None, *,
                 conv_moments: bool = False, bf16_loss: bool = False,
                 device=None, generator=None):
        """device: None runs on the CUDA card (raises without one), "cpu"
        on the CPU. generator: CPU torch.Generator for the initial weights
        (default: seed 0). conv_moments: the encoder's fused conv + BN
        moments route in train mode (off by default). bf16_loss: the image
        BCE's bf16 elementwise math for bf16 logits (see the module
        docstring). The model starts in eval mode."""
        super().__init__()
        device = resolve_device(device)
        self.n_latents = n_latents
        self.compute_dtype = compute_dtype
        self.bf16_loss = bf16_loss
        L = n_latents
        self.image_encoder = ImageEncoder(L, compute_dtype, conv_moments,
                                          device)
        self.image_decoder = ImageDecoder(L, compute_dtype, device)
        self.attr_encoders = nn.ModuleList(
            [AttrEncoder(L, device) for _ in range(N_ATTRS)])
        self.attr_decoders = nn.ModuleList(
            [AttrDecoder(L, device) for _ in range(N_ATTRS)])
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

    def keep_mask_shape(self, batch: int):
        return (batch, self.image_encoder.classifier[0].weight.shape[0])

    def encode_attrs(self, attrs):
        """(B, 18) 0/1 -> (18, B, 2L) f32, the experts stacked."""
        emb, _ = stacked(self.attr_encoders, 0)                # (18, 2, 512)
        e0, e1 = emb[:, :1], emb[:, 1:]
        h = swish(e0 + attrs.float().t()[..., None] * (e1 - e0))
        for i in (2, 4):
            w, b = stacked(self.attr_encoders, i)
            h = torch.bmm(h, w.transpose(1, 2)) + b
            if i == 2:
                h = swish(h)
        return h

    def encode(self, inputs, keep_mask=None):
        L = self.n_latents
        img = self.image_encoder(inputs["image"].permute(0, 3, 1, 2),
                                 keep_mask)
        att = self.encode_attrs(inputs["attrs"])
        mu = torch.cat([img[None, :, :L], att[..., :L]])
        logvar = torch.cat([img[None, :, L:], att[..., L:]])
        return mu, logvar, {"image": pop_moments(self.image_encoder)}

    def decode_attrs(self, z):
        """(N, L) -> (N, 18) f32 logits over the stacked experts."""
        cd = self.compute_dtype
        x = z[None]
        for i in (0, 2, 4, 6):
            w, b = stacked(self.attr_decoders, i)
            w = w.transpose(1, 2)
            if cd is None:
                y = torch.matmul(x, w)
            elif i == 0:        # bf16 input, weights and product
                y = torch.matmul(x.to(cd), w.to(cd)).float()
            else:               # f32 input, bf16-rounded weights
                y = torch.matmul(x, w.to(cd).float())
            x = y + b
            if i != 6:
                x = swish(x)
        return x[..., 0].t().contiguous()

    def decode(self, z, groups: int = 1, decode_terms=None):
        """decode_terms: {"image": (T',) long tensor} decodes the image of
        those terms' rows only (see the module docstring); the recons then
        carry the terms under "image_terms"."""
        terms = None if decode_terms is None else decode_terms.get("image")
        if terms is None:
            set_bn_groups(self.image_decoder, groups)
            img = self.image_decoder(z)
        else:
            zi = z.view(groups, -1, z.shape[-1])[terms]
            set_bn_groups(self.image_decoder, len(terms), terms)
            img = self.image_decoder(zi.reshape(-1, z.shape[-1]))
        recons = {"image": img.permute(0, 2, 3, 1),
                  "attrs": self.decode_attrs(z)}
        if terms is not None:
            recons["image_terms"] = terms
        return recons, pop_moments(self.image_decoder)

    def recon_loss(self, name, logits, target):
        """The loglike targets' losses: "image" or "attrs", each the
        row-summed BCE (f32 math)."""
        return bce_row_sum(logits.reshape(logits.shape[0], -1),
                           target.reshape(target.shape[0], -1).float())

    def recon_losses(self, recons, inputs):
        """(N, 19): the image's row-summed BCE, then the 18 attributes'
        scalar BCEs; row r reads input row r mod B."""
        att = recons["attrs"]
        n, nt = att.shape[0], inputs["attrs"].shape[0]
        img = bce_row_sum(recons["image"].reshape(recons["image"].shape[0],
                                                  -1),
                          inputs["image"].reshape(nt, -1),
                          bf16_math=self.bf16_loss)
        terms = recons.get("image_terms")
        if terms is not None:
            img = img.new_zeros((n // nt, nt)).index_copy(
                0, terms, img.view(-1, nt)).reshape(n)
        att = binary_cross_entropy_with_logits(
            att.view(n // nt, nt, N_ATTRS), inputs["attrs"].float())
        return torch.cat([img[:, None], att.reshape(n, N_ATTRS)], dim=-1)

    def infer(self, inputs, attrs_mask=None):
        """Fuse the posterior of the image if given and of the attribute
        experts that attrs_mask (18,) 0/1 names (all 18 when attrs are
        given without a mask, none without attrs), with the prior
        (celeba19/model.py:63-89): one PoE launch, one mask row."""
        b = next(iter(inputs.values())).shape[0]
        dev = self.device
        full = dict(inputs)
        img_present = 1.0 if "image" in full else 0.0
        if "image" not in full:
            full["image"] = self.placeholder("image", b)
        if "attrs" not in full:
            full["attrs"] = self.placeholder("attrs", b)
            if attrs_mask is None:
                attrs_mask = torch.zeros(N_ATTRS)
        if attrs_mask is None:
            attrs_mask = torch.ones(N_ATTRS)
        mask = torch.cat([torch.tensor([img_present]), torch.as_tensor(
            attrs_mask, dtype=torch.float32).cpu()])[None].to(dev)
        mu, logvar, _ = self.encode(full)
        pd_mu, pd_logvar = masked_poe_all_terms(mu, logvar, mask)
        return pd_mu[0], pd_logvar[0]
