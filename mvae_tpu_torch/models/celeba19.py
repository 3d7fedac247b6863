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
The experts sit in ModuleDicts keyed "0" .. "17", the reference's keys.

Expert parallelism (parallel/mesh.py:shard_params_tp, where 18 divides
by the tp size): a rank keeps its 18 / tp consecutive experts of each
ModuleDict under their own keys, runs them, and all-gathers their outputs
along the expert axis, (18, B, 2L) posteriors before the PoE kernel and
(N, 18) logits before the BCE; the decoder takes z through copy_to_tp,
since each rank's experts give a part of its gradient.

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

The train step's grouped decode (core/engine.py:decode_plan; the JAX
package's models/celeba19.py:117-206): the decoder groups are the image
(column 0) and the stacked attribute experts (columns 1-18). The 18
single-attribute terms never train the image decoder, which has BN: they
decode it forward for its statistics, or skip it under
--fast-term-decode (skip_decode_groups). The image-only term never trains
the experts, which are stateless: it skips them (exact_skip_groups). A
term whose support holds k of the 18 experts, 0 < k < 18, decodes only
those (decode_group_key, decode_term_operands): the terms of one k as one
batched product a layer on the weights of their experts, gathered from
the ModuleDict in the terms' order, the logits scattered to their
columns with zeros elsewhere (weight 0 there). Under expert parallelism
a rank decodes the gathered experts it holds and the ranks' logits are
summed (reduce_from_tp: each (term, expert) is one rank's, the others add
zeros), as exact as the stacked decode's gather.
"""

from typing import NamedTuple

import numpy as np

import torch
from torch import nn

from mvae_tpu_torch.core.losses import (
    bce_row_sum, binary_cross_entropy_with_logits)
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.base import MultimodalVAE, head_chain
from mvae_tpu_torch.models.celeba import ImageDecoder, ImageEncoder
from mvae_tpu_torch.nn.initializers import init_parameters_
from mvae_tpu_torch.nn.layers import Embedding, Linear, Swish, swish
from mvae_tpu_torch.nn.norm import pop_moments, set_bn_groups
from mvae_tpu_torch.ops.poe import masked_poe_all_terms
from mvae_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp, gather_from_tp, reduce_from_tp)

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
    """The experts' (a ModuleDict's) layer `index` as (n, d_out, d_in)
    weights and (n, 1, d_out) biases (an Embedding: (n, 2, d) rows and
    None)."""
    layers = [e.net[index] for e in experts.values()]
    w = torch.stack([m.weight for m in layers])
    if getattr(layers[0], "bias", None) is None:
        return w, None
    return w, torch.stack([m.bias for m in layers])[:, None]


class ExpertGather(NamedTuple):
    """decode_term_operands of a group of G terms of k experts each:
    `index` (G, k) their experts (the JAX package's operand); the (term,
    expert) pairs this rank holds, P of them: `experts` (host ints),
    `rows` (P,) long, each pair's term (None where that is 0 .. G-1),
    `flat` (P,) long, term * 18 + expert."""
    index: np.ndarray
    experts: tuple
    rows: object
    flat: torch.Tensor


class Celeba19MVAE(MultimodalVAE):
    # expert order: the image, then the 18 attributes
    modalities = ("image",) + tuple(f"attr_{i}" for i in range(N_ATTRS))
    # the inputs whose losses the IWAE sums (core/loglike.py)
    loglike_targets = ("image", "attrs")
    # decoder groups --fast-term-decode may skip (core/engine.py)
    skip_decode_groups = ("image",)
    # the stacked experts are stateless: the image-only term skips them
    exact_skip_groups = ("attrs",)
    gathered_groups = ("attrs",)

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
        self.attr_encoders = nn.ModuleDict(
            {str(i): AttrEncoder(L, device) for i in range(N_ATTRS)})
        self.attr_decoders = nn.ModuleDict(
            {str(i): AttrDecoder(L, device) for i in range(N_ATTRS)})
        self.expert_tp = None       # the tp group where the experts shard
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

    tp_experts = ("attr_encoders", "attr_decoders")

    def tp_chains(self):
        return [head_chain("image_encoder")]

    def _gather_experts(self, x, dim):
        """The rank's experts' outputs joined with the other ranks' along
        the expert axis `dim`; x itself without expert parallelism."""
        if self.expert_tp is None:
            return x
        return gather_from_tp(x, dim, self.expert_tp)

    def keep_mask_shape(self, batch: int):
        return (batch, self.image_encoder.classifier.hidden)

    def encode_attrs(self, attrs):
        """(B, 18) 0/1 -> (18, B, 2L) f32, the experts stacked."""
        emb, _ = stacked(self.attr_encoders, 0)                # (18, 2, 512)
        e0, e1 = emb[:, :1], emb[:, 1:]
        a = attrs.float()[:, [int(k) for k in self.attr_encoders]]
        h = swish(e0 + a.t()[..., None] * (e1 - e0))
        for i in (2, 4):
            w, b = stacked(self.attr_encoders, i)
            h = torch.bmm(h, w.transpose(1, 2)) + b
            if i == 2:
                h = swish(h)
        return self._gather_experts(h, 0)

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
        x = z[None] if self.expert_tp is None else copy_to_tp(
            z, self.expert_tp)[None]
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
        return self._gather_experts(x[..., 0].t(), 1).contiguous()

    def decode_attrs_gathered(self, z, groups, operand):
        """(G * B, L), an ExpertGather of the G terms -> (G * B, 18) f32:
        each term's k experts' logits at their columns, zeros at the
        others; decode_attrs' products and roundings, a (term, expert)
        pair a batch of one batched product a layer."""
        cd = self.compute_dtype
        x = z.view(groups, -1, z.shape[-1])                    # (G, B, L)
        if self.expert_tp is not None:
            x = copy_to_tp(x, self.expert_tp)
        if operand.rows is not None:
            x = x.index_select(0, operand.rows)                # (P, B, L)
        nets = [self.attr_decoders[str(j)].net for j in operand.experts]
        for i in (0, 2, 4, 6):
            w = torch.stack([n[i].weight for n in nets]).transpose(1, 2)
            b = torch.stack([n[i].bias for n in nets])[:, None]
            if cd is None:
                y = torch.bmm(x, w)
            elif i == 0:
                y = torch.bmm(x.to(cd), w.to(cd)).float()
            else:
                y = torch.bmm(x, w.to(cd).float())
            x = y + b
            if i != 6:
                x = swish(x)
        n_b = x.shape[1]
        out = x.new_zeros((groups * N_ATTRS, n_b)).index_copy(
            0, operand.flat, x[..., 0])
        if self.expert_tp is not None:
            out = reduce_from_tp(out, self.expert_tp)
        return out.view(groups, N_ATTRS, n_b).transpose(1, 2).reshape(
            groups * n_b, N_ATTRS)

    def decoder_columns(self):
        return {"image": (0, 1), "attrs": (1, 1 + N_ATTRS)}

    def decode_group_key(self, support_row):
        """k for a term whose support holds k of the 18 experts, 0 < k <
        18 (the single-attribute terms: k = 1), else None."""
        k = int(sum(1 for v in support_row[1:] if v))
        return k if 0 < k < N_ATTRS else None

    def decode_term_operands(self, support_rows, device=None):
        """An ExpertGather of a group of terms of one key: their experts,
        and the pairs this rank holds (all of them without expert
        parallelism; build it after the model is sharded)."""
        index = np.stack([np.nonzero(np.asarray(r[1:]))[0]
                          for r in support_rows])
        pairs = [(g, int(j)) for g, row in enumerate(index) for j in row
                 if str(int(j)) in self.attr_decoders]
        rows = [g for g, _ in pairs]
        return ExpertGather(
            index, tuple(j for _, j in pairs),
            None if rows == list(range(len(index))) else torch.as_tensor(
                rows, dtype=torch.long, device=device),
            torch.as_tensor([g * N_ATTRS + j for g, j in pairs],
                            dtype=torch.long, device=device))

    def decode_group(self, name, z, groups, terms, keep_mask=None,
                     operand=None):
        if name == "attrs":
            att = (self.decode_attrs(z) if operand is None
                   else self.decode_attrs_gathered(z, groups, operand))
            return {"attrs": att}, []
        set_bn_groups(self.image_decoder, groups, terms)
        img = self.image_decoder(z).permute(0, 2, 3, 1)
        return {"image": img}, pop_moments(self.image_decoder)

    def group_losses(self, name, recons, inputs):
        """The image's row-summed BCE (N, 1), or the 18 attributes' scalar
        BCEs (N, 18); row r reads input row r mod B."""
        if name == "image":
            img = recons["image"]
            return bce_row_sum(img.reshape(img.shape[0], -1),
                               inputs["image"].reshape(
                                   inputs["image"].shape[0], -1),
                               bf16_math=self.bf16_loss)[:, None]
        att = recons["attrs"]
        n, nt = att.shape[0], inputs["attrs"].shape[0]
        return binary_cross_entropy_with_logits(
            att.view(n // nt, nt, N_ATTRS),
            inputs["attrs"].float()).reshape(n, N_ATTRS)

    def recon_loss(self, name, logits, target):
        """The loglike targets' losses: "image" or "attrs", each the
        row-summed BCE (f32 math)."""
        return bce_row_sum(logits.reshape(logits.shape[0], -1),
                           target.reshape(target.shape[0], -1).float())

    def recon_losses(self, recons, inputs):
        """(N, 19): the image's row-summed BCE, then the 18 attributes'
        scalar BCEs (group_losses)."""
        return torch.cat([self.group_losses(g, recons, inputs)
                          for g in ("image", "attrs")], dim=-1)

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
