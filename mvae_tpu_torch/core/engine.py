"""Multi-term ELBO engine (counterpart of mvae_tpu/core/engine.py:188-281),
eval mode.

  1. Encode every modality once.
  2. Fuse all T subset posteriors in one PoE kernel launch.
  3. z = mu (eval mode: no reparametrization noise).
  4. Decode the T*B rows as one batch. Exact in eval mode, where BN uses
     the running statistics and so acts row by row; this takes the place
     of the JAX package's vmap over terms.
  5. Masked, weighted reconstruction losses (the T*B logit rows share the
     B target rows) plus the per-term KL.

The train branch (reparametrization noise, per-term BN batch statistics,
the grouped decode and the EMA commits) waits for the training slice.
"""

import torch

from mvae_tpu_torch.core.losses import kl_divergence
from mvae_tpu_torch.core.sampling import reparametrize
from mvae_tpu_torch.ops.poe import masked_poe_all_terms


def multi_term_elbo(model, inputs, term_masks, term_lambdas, beta=1.0, *,
                    train: bool = False):
    """Sum over T subset-ELBO terms.

    inputs:       name -> (B, ...) tensors, every modality present.
    term_masks:   (T, M) 0/1: which experts join each term's posterior,
                  and which reconstruction losses count in it.
    term_lambdas: (T, M) per-term, per-modality loss weights.

    Returns (total, aux) with aux = {"per_term": (T,), "mu", "logvar":
    the first term's posterior (B, D)}.
    """
    if train:
        raise NotImplementedError("the train-mode ELBO is not ported yet")
    mu, logvar = model.encode(inputs)                          # (M, B, D)
    pd_mu, pd_logvar = masked_poe_all_terms(mu, logvar, term_masks)
    z = reparametrize(pd_mu, pd_logvar, train=False)           # (T, B, D)
    t, b, d = z.shape
    recons = model.decode(z.reshape(t * b, d))
    recon_stack = model.recon_losses(recons, inputs).reshape(t, b, -1)
    w = (term_masks * term_lambdas)[:, None, :]                # (T, 1, M)
    recon = torch.sum(recon_stack * w, dim=-1)                 # (T, B)
    kld = kl_divergence(pd_mu, pd_logvar)                      # (T, B)
    per_term = torch.mean(recon + beta * kld, dim=1)           # (T,)
    total = torch.sum(per_term)
    return total, {"per_term": per_term, "mu": pd_mu[0],
                   "logvar": pd_logvar[0]}
