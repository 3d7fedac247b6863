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
    decode(z, groups=1, keep_mask=None) -> (recons, moments)
        z: (N, D); recons: name -> (N, ...) logits; groups: sets of
        train-mode BN statistics over consecutive row blocks (the ELBO
        terms); moments: [nn.norm.Moments] of the decoders' BN calls.
        The one-batch decode: eval, and a train step whose terms all
        decode everything. Default: each decoder group's decode_group on
        all the rows
    dropout_rate: float                  the rate of encode's dropout; 0
                                         (the default) for a family
                                         without one, which trains with
                                         no keep-mask
    keep_mask_shape(batch) -> the shape of encode's keep_mask (a family
        with dropout)
    recon_loss(name, logits, target) -> (N,) per-sample loss summed over
        the event dims; target may hold fewer rows (N % Nt == 0, shared)
    input_spec() -> name -> (event_shape, dtype)

and, for the train step's grouped decode (core/engine.py:decode_plan; the
JAX package's models/base.py:30-64 and engine.py:_decode_grouped):
    decoder_columns() -> name -> (lo, hi): the decoder groups and the
        expert columns [lo, hi) of the (N, M) loss that each one's recons
        feed. Default: one group a modality, named like it, its column
    stop_grad_groups(support_row) -> frozenset: the decoder groups that
        a term whose static recon support is support_row ((M,) 0/1)
        never trains. Default: the groups of the columns it does not
        support
    exact_skip_groups: groups without BatchNorm (no statistics to keep),
        which a term that never trains them does not decode at all.
        Default: none
    skip_decode_groups: groups with BatchNorm that --fast-term-decode
        skips too (their skipped terms commit the old statistics)
    decode_group(name, z, groups, terms, keep_mask=None, operand=None)
        -> (recons, moments): decoder group `name` alone on the rows z
        (N, D) of the ELBO terms `terms` ((G,) long, G = groups sets of
        BN statistics, each naming its term in the moments); recons:
        the group's modality -> (N, ...) logits; keep_mask: the
        decoder dropout's for those rows; operand: decode_term_operands
        of the terms, for a group of gathered_groups
    group_losses(name, recons, inputs) -> (N, hi - lo): the group's loss
        columns. Default: recon_loss of the modality
    decode_group_key(support_row), decode_term_operands(support_rows),
    gathered_groups: optional (celeba19): terms of one key decode the
        groups of gathered_groups on the operand that
        decode_term_operands gives them (its experts), as one call

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
    exact_skip_groups: tuple = ()
    skip_decode_groups: tuple = ()
    gathered_groups: tuple = ()

    def decoder_columns(self) -> dict:
        return {m: (i, i + 1) for i, m in enumerate(self.modalities)}

    def stop_grad_groups(self, support_row) -> frozenset:
        cols = self.decoder_columns()
        return frozenset(g for g, (lo, hi) in cols.items()
                         if not any(support_row[lo:hi]))

    def decode(self, z, groups: int = 1, keep_mask=None):
        recons, moments = {}, []
        for name in self.decoder_columns():
            r, m = self.decode_group(name, z, groups, None, keep_mask)
            recons.update(r)
            moments += m
        return recons, moments

    def decode_group(self, name, z, groups, terms, keep_mask=None,
                     operand=None):
        raise NotImplementedError(
            f"{type(self).__name__} decodes its terms as one batch only")

    def group_losses(self, name, recons, inputs):
        return self.recon_loss(name, recons[name], inputs[name])[:, None]

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
