"""Multi-term ELBO engine (counterpart of mvae_tpu/core/engine.py:48-86,
188-281).

  1. Encode every modality once.
  2. Fuse all T subset posteriors in one PoE kernel launch.
  3. z = mu in eval mode; z = mu + eps * exp(logvar / 2) in train mode,
     eps (T, B, D) from the caller.
  4. Decode the T*B rows as one batch. In eval mode BN uses the running
     statistics and acts row by row; in train mode every decoder BN keeps
     T sets of batch statistics, one per term (groups = T), which are the
     statistics the JAX package's vmap over terms gives. This one batch
     takes the place of that vmap and of `_decode_grouped`, which only
     stops the gradient of zero-weighted terms: with per-term statistics
     those gradients are exactly zero here too (the upstream gradient is
     0, so are sum dz and sum dz*x, and so dx), so values and gradients
     agree. Skipping that dead backward work is a later speed item.
  5. Masked, weighted reconstruction losses (the T*B logit rows share the
     B target rows) plus the per-term KL.
  6. Train mode: commit the BN running statistics (commit_ema_states).

The engine draws no random numbers: train mode takes `noise = (eps,
keep_mask[, decode_keep_mask])` from the caller.

--fast-term-decode (`decode_terms`, celeba19): a decoder group of the
model's `skip_decode_groups` runs only on the rows of the terms whose
static recon support holds it (fast_decode_terms), as the JAX package's
`_decode_grouped(skip_nograd=True)` does; losses and gradients do not
change, the skipped terms' BN commits are the JAX package's for a term
that returns the old state.
"""

import torch

from mvae_tpu_torch.core.losses import kl_divergence
from mvae_tpu_torch.core.sampling import reparametrize
from mvae_tpu_torch.nn.norm import BN_MOMENTUM
from mvae_tpu_torch.ops.poe import masked_poe_all_terms


@torch.no_grad()
def commit_ema_states(model, enc_moments, dec_moments, term_masks):
    """Fold the reference's sequential BN-EMA commits into the running
    buffers, in place, in the closed forms of engine.py:48-86.

    The reference runs one forward per term: every decoder BN gets T
    commits in term order, and modality m's encoder BNs get
    k = sum(term_masks[:, m]) commits, all of the same batch moments. With
    s_t = (1-mom) old + mom m_t the T decoder commits fold to
        new = (1-mom)^T old + sum_t (1-mom)^(T-1-t) (s_t - (1-mom) old)
    and the k encoder commits to
        new = old + ((1 - (1-mom)^k) / mom) (s - old).
    The variance committed is the unbiased one, var * n / (n - 1).

    enc_moments: modality -> [Moments] (G = 1); dec_moments: [Moments]
    (G = T, or G of the T terms that Moments.terms names: each other term
    commits s_t = old, the state a skipped decode returns in the JAX
    package, engine.py:_decode_grouped); term_masks: (T, M).
    """
    mom = BN_MOMENTUM
    t = term_masks.shape[0]
    w = (1.0 - mom) ** torch.arange(t - 1, -1, -1, dtype=torch.float32,
                                    device=term_masks.device)[:, None]

    def unbiased(m):
        return m.var * (m.n / max(m.n - 1, 1))

    for m in dec_moments:
        for buf, stat in ((m.bn.running_mean, m.mean),
                          (m.bn.running_var, unbiased(m))):
            s = (1.0 - mom) * buf + mom * stat                  # (G, C)
            if m.terms is not None:
                s = buf.expand(t, -1).index_copy(0, m.terms, s)  # (T, C)
            buf.copy_((1.0 - mom) ** t * buf
                      + torch.sum(w * (s - (1.0 - mom) * buf), dim=0))
    for name, moments in enc_moments.items():
        k = term_masks[:, model.modality_index(name)].sum()
        q = 1.0 - (1.0 - mom) ** k
        for m in moments:
            for buf, stat in ((m.bn.running_mean, m.mean[0]),
                              (m.bn.running_var, unbiased(m)[0])):
                s = (1.0 - mom) * buf + mom * stat
                buf.add_((q / mom) * (s - buf))


def fast_decode_terms(model, recon_support, device):
    """--fast-term-decode's decode_terms: for each of the model's
    skip_decode_groups, the (T',) terms whose static recon support
    (numpy (T, M) 0/1) holds that modality."""
    return {g: torch.as_tensor(
        [t for t, row in enumerate(recon_support)
         if row[model.modality_index(g)]], dtype=torch.long, device=device)
        for g in getattr(model, "skip_decode_groups", ())}


def multi_term_elbo(model, inputs, term_masks, term_lambdas, beta=1.0, *,
                    train: bool = False, noise=None, decode_terms=None,
                    recon_masks=None):
    """Sum over T subset-ELBO terms.

    inputs:       name -> (B, ...) tensors, every modality present.
    term_masks:   (T, M) 0/1: which experts join each term's posterior,
                  and (without recon_masks) which reconstruction losses
                  count in it.
    term_lambdas: (T, M) per-term, per-modality loss weights.
    recon_masks:  (T, M) 0/1 or None: which reconstruction losses count
                  in each term, apart from the posterior's experts
                  (vision's unimodal terms reconstruct all six
                  modalities; engine.py:267-268). The EMA commit keeps
                  term_masks: an encoder commits once for each term whose
                  posterior holds its modality.
    train:        the model must be in the same mode. Train mode needs
                  noise = (eps (T, B, D) standard normal, keep_mask: the
                  encoder dropout's, model.keep_mask_shape(B) bool, or
                  None for a model whose dropout_rate is 0[, the
                  decoder dropout's model.decode_keep_mask_shape(T * B),
                  for a model with a decode_dropout_rate]), and commits
                  the BN running statistics after the forward.
    decode_terms: fast_decode_terms(...), train mode only, or None.

    Returns (total, aux) with aux = {"per_term": (T,), "mu", "logvar":
    the first term's posterior (B, D)}.
    """
    if train != model.training:
        raise ValueError(f"train={train} but the model is in "
                         f"{'train' if model.training else 'eval'} mode")
    dec_dropout = getattr(model, "decode_dropout_rate", 0.0)
    if train and (noise is None or noise[0] is None
                  or (model.dropout_rate and noise[1] is None)
                  or (dec_dropout and (len(noise) < 3 or noise[2] is None))):
        raise ValueError("train mode takes noise = (eps, keep_mask[, "
                         "decode_keep_mask]); a keep_mask may be None only "
                         "without that dropout")
    eps, keep_mask = noise[:2] if train else (None, None)
    mu, logvar, enc_moments = model.encode(inputs, keep_mask)   # (M, B, D)
    pd_mu, pd_logvar = masked_poe_all_terms(mu, logvar, term_masks)
    z = reparametrize(pd_mu, pd_logvar, eps)                     # (T, B, D)
    t, b, d = z.shape
    kw = {} if decode_terms is None else {"decode_terms": decode_terms}
    if train and dec_dropout:
        kw["keep_mask"] = noise[2]
    recons, dec_moments = model.decode(z.reshape(t * b, d), groups=t, **kw)
    recon_stack = model.recon_losses(recons, inputs).reshape(t, b, -1)
    rmask = term_masks if recon_masks is None else recon_masks
    w = (rmask * term_lambdas)[:, None, :]                     # (T, 1, M)
    recon = torch.sum(recon_stack * w, dim=-1)                 # (T, B)
    kld = kl_divergence(pd_mu, pd_logvar)                      # (T, B)
    per_term = torch.mean(recon + beta * kld, dim=1)           # (T,)
    total = torch.sum(per_term)
    if train:
        commit_ema_states(model, enc_moments, dec_moments, term_masks)
    return total, {"per_term": per_term, "mu": pd_mu[0],
                   "logvar": pd_logvar[0]}
