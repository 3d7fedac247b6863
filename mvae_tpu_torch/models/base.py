"""Model protocol (counterpart of mvae_tpu/models/base.py).

A model is an `nn.Module` that holds its weights and running statistics.
Public functions keep the JAX package's layouts: images NHWC, posteriors
stacked (M, B, D) in `modalities` order.

Subclasses define:
    modalities: tuple[str, ...]          expert order
    n_latents: int
    encode(inputs, keep_mask=None) -> (mu, logvar, moments)
        inputs: name -> (B, ...), all present; keep_mask: the dropout's, in
        train mode; moments: modality -> [nn.norm.Moments] of the encoder's
        train-mode BN calls (empty lists in eval mode)
    decode(z, groups=1) -> (recons, moments)
        z: (N, D); recons: name -> (N, ...) logits; groups: sets of
        train-mode BN statistics over consecutive row blocks (the ELBO
        terms); moments: [nn.norm.Moments] of the decoders' BN calls
    dropout_rate: float                  the rate of encode's dropout; 0
                                         (the default) for a family
                                         without one, which trains with
                                         no keep-mask
    keep_mask_shape(batch) -> the shape of encode's keep_mask (a family
        with dropout)
    recon_loss(name, logits, target) -> (N,) per-sample loss summed over
        the event dims; target may hold fewer rows (N % Nt == 0, shared)
    input_spec() -> name -> (event_shape, dtype)

and, for tensor and expert parallelism (parallel/mesh.py:tp_plan), where
the JAX package's parameter tree has them:
    tp_chains() -> the MLP lists that tp_spec_tree pairs column / row
        (mvae_tpu/parallel/mesh.py:126-151): its lists of linears and the
        DCGAN heads' {"fc", "out"} pairs, in the JAX tree's order; each a
        list of layers, each layer the names of the Linear modules that
        make one JAX linear (MNIST's 2L head is two, fc31 and fc32)
    tp_experts: names of the ModuleDicts of stacked experts, whose
        leading (expert) axis shards
"""

import torch
from torch import nn

from mvae_tpu_torch.ops.poe import masked_poe_all_terms


def head_chain(prefix: str) -> list:
    """A DCGAN posterior head's {"fc", "out"} pair as a tp chain."""
    return [(f"{prefix}.classifier.0",), (f"{prefix}.classifier.3",)]


class MultimodalVAE(nn.Module):
    modalities: tuple = ()
    n_latents: int = 0
    dropout_rate: float = 0.0
    tp_experts: tuple = ()

    def tp_chains(self) -> list:
        return []

    def dropout_tp(self):
        """The TPRole of the layer whose output the encoder's dropout
        masks (the image head's fc), or None."""
        return self.image_encoder.classifier[0].tp if self.dropout_rate \
            else None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def modality_index(self, name: str) -> int:
        return self.modalities.index(name)

    def recon_losses(self, recons, inputs):
        """(N, M) per-sample loss, one column per expert."""
        return torch.stack([self.recon_loss(n, recons[n], inputs[n])
                            for n in self.modalities], dim=-1)

    def infer(self, inputs):
        """Fuse the posterior of exactly the modalities in `inputs`, with the
        prior expert (mnist/model.py:46-64). Absent modalities run through
        their encoder on zero placeholders and are masked out of the
        product: one PoE launch with a single mask row.

        Returns (pd_mu, pd_logvar), each (B, D)."""
        b = next(iter(inputs.values())).shape[0]
        full = {m: inputs[m] if m in inputs else self.placeholder(m, b)
                for m in self.modalities}
        mask = torch.tensor([[1.0 if m in inputs else 0.0
                              for m in self.modalities]], device=self.device)
        mu, logvar, _ = self.encode(full)
        pd_mu, pd_logvar = masked_poe_all_terms(mu, logvar, mask)
        return pd_mu[0], pd_logvar[0]

    def placeholder(self, name: str, batch: int):
        """Zero-filled stand-in for an absent modality."""
        shape, dtype = self.input_spec()[name]
        return torch.zeros((batch,) + tuple(shape), dtype=dtype,
                           device=self.device)

    def input_spec(self):
        raise NotImplementedError
